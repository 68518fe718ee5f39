"""Env knobs that the port reads or refuses as the JAX package reads them.

Each test runs both packages with the same knob value and compares what
they do: the kind of buffer a large fs read returns under
``*_MMAP_READS``, the CPU worker count under ``*_CPU_CONCURRENCY``, and,
for the telemetry knobs the port has no feature for yet, that the port
refuses by name exactly the values that turn the feature on in JAX.
"""

from __future__ import annotations

import asyncio
import json
import mmap
import os
import subprocess
import sys

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu.storage_plugins import fs as jax_fs
from torchsnapshot_tpu.telemetry import core as jax_telemetry
from torchsnapshot_tpu_torch.storage_plugins import fs as port_fs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(module, root: str, name: str, io_type):
    plugin = module.FSStoragePlugin(root)
    read_io = io_type(path=name)
    asyncio.run(plugin.read(read_io))
    asyncio.run(plugin.close())
    return read_io.buf


def _is_mapped(buf) -> bool:
    return isinstance(buf, memoryview) and isinstance(buf.obj, mmap.mmap)


@pytest.mark.parametrize("value", [None, "1", "0", "false", "no", "off", "OFF", "auto"])
def test_mmap_reads_knob_picks_the_same_buffer_kind(tmp_path, monkeypatch, value) -> None:
    from torchsnapshot_tpu.io_types import ReadIO as JaxReadIO
    from torchsnapshot_tpu_torch.io_types import ReadIO as PortReadIO

    payload = os.urandom(2 << 20)
    (tmp_path / "blob").write_bytes(payload)
    for name in (jax_fs.MMAP_ENV_VAR, port_fs.MMAP_ENV_VAR):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    jax_buf = _read(jax_fs, str(tmp_path), "blob", JaxReadIO)
    port_buf = _read(port_fs, str(tmp_path), "blob", PortReadIO)
    assert bytes(jax_buf) == bytes(port_buf) == payload
    assert _is_mapped(port_buf) == _is_mapped(jax_buf)
    assert _is_mapped(port_buf) == (value not in ("0", "false", "no", "off", "OFF"))
    if not _is_mapped(port_buf):
        assert type(port_buf) is type(jax_buf) is bytearray


@pytest.mark.parametrize("value", ["1", "3", "bogus"])
def test_cpu_concurrency_knob_gives_the_same_worker_count(value) -> None:
    env = dict(os.environ)
    env["TORCHSNAPSHOT_TPU_CPU_CONCURRENCY"] = value
    env["TORCHSNAPSHOT_GPU_CPU_CONCURRENCY"] = value
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import json\n"
        "from torchsnapshot_tpu import scheduler as J\n"
        "from torchsnapshot_tpu_torch import scheduler as P\n"
        "print(json.dumps([J._MAX_PER_RANK_CPU_CONCURRENCY, P._CPU_CONCURRENCY]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    jax_n, port_n = json.loads(out.stdout.strip().splitlines()[-1])
    assert jax_n == port_n
    if value != "bogus":
        assert port_n == int(value)


def _jax_metrics_port_starts(value: str) -> bool:
    """What ``telemetry/promexp.py:maybe_start`` does with ``value``: it
    starts the exporter for an integer port >= 0, and for nothing else."""
    from torchsnapshot_tpu.telemetry import promexp

    started = []
    orig = promexp.start_exporter
    promexp.start_exporter = lambda port, rank=None: started.append(port)
    try:
        os.environ[promexp.METRICS_PORT_ENV_VAR] = value
        promexp.maybe_start()
    finally:
        promexp.start_exporter = orig
        del os.environ[promexp.METRICS_PORT_ENV_VAR]
    return bool(started)


def _port_take_raises(tmp_path, monkeypatch, knob: str, value: str) -> bool:
    monkeypatch.setenv(knob, value)
    try:
        P.Snapshot.take(str(tmp_path / f"s_{len(os.listdir(tmp_path))}"),
                        {"app": P.StateDict(w=torch.ones(2))})
    except NotImplementedError as exc:
        assert knob in str(exc)
        return True
    finally:
        monkeypatch.delenv(knob)
    return False


@pytest.mark.parametrize(
    "value", ["1", "on", "true", "yes", "always", "ALWAYS", "0", "", "auto", "off", "never", "2"]
)
def test_telemetry_knob_is_refused_exactly_where_jax_turns_it_on(tmp_path, monkeypatch, value):
    monkeypatch.setenv(jax_telemetry.TELEMETRY_ENV_VAR, value)
    jax_on = jax_telemetry._env_enabled()
    assert _port_take_raises(tmp_path, monkeypatch, "TORCHSNAPSHOT_GPU_TELEMETRY", value) == jax_on


@pytest.mark.parametrize("value", ["9464", "0", "1", " 9484 ", "-1", "", "auto", "port"])
def test_metrics_port_knob_is_refused_exactly_where_jax_starts_it(tmp_path, monkeypatch, value):
    jax_on = _jax_metrics_port_starts(value)
    assert _port_take_raises(tmp_path, monkeypatch, "TORCHSNAPSHOT_GPU_METRICS_PORT", value) == jax_on
