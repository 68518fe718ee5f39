"""The port's kernel build: which edits make a library stale.

``_build._target`` names the library of ``csrc/<name>.cu`` by a hash of
what compiles into it. These tests point ``CSRC_DIR`` and ``BUILD_DIR`` at
temporary directories; no ``nvcc`` is needed.
"""

from __future__ import annotations

import os

import pytest

from torchsnapshot_tpu_torch.ops import _build


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "common.cuh"\nint a() { return 1; }\n')
    (src / "b.cu").write_text('#include "common.cuh"\nint b() { return 2; }\n')
    (src / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


def _targets():
    return {name: _build._target(name) for name in ("a", "b")}


def test_target_is_stable_for_unchanged_sources(csrc) -> None:
    assert _targets() == _targets()
    assert all(path.startswith(_build.BUILD_DIR) for path in _targets().values())


def test_editing_a_header_changes_every_target(csrc) -> None:
    before = _targets()
    (csrc / "common.cuh").write_text("// v2\n")
    after = _targets()
    assert all(before[name] != after[name] for name in before)


def test_adding_a_header_changes_every_target(csrc) -> None:
    before = _targets()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _targets()
    assert all(before[name] != after[name] for name in before)


def test_editing_a_source_changes_only_its_target(csrc) -> None:
    before = _targets()
    (csrc / "a.cu").write_text('#include "common.cuh"\nint a() { return 3; }\n')
    after = _targets()
    assert after["a"] != before["a"] and after["b"] == before["b"]


def test_changing_the_flags_changes_the_target(csrc, monkeypatch) -> None:
    before = _targets()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    after = _targets()
    assert all(before[name] != after[name] for name in before)


def test_build_skips_a_current_library(csrc, monkeypatch) -> None:
    def no_nvcc():
        raise AssertionError("build ran nvcc for a library that is current")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    target = _build._target("a")
    os.makedirs(os.path.dirname(target))
    open(target, "wb").close()
    _build.build(["a"])
