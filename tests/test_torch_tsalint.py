"""The port's static analyzer (``torchsnapshot_tpu_torch/analysis/``) held
against the JAX package's (``torchsnapshot_tpu/analysis/``).

Four layers:

1. **Shared fixtures** — every synthetic tree of ``tests/test_tsalint.py``
   goes through both analyzers in one process: the same
   ``(rule, line, message)`` findings, hygiene failures and suppressions,
   the path prefix aside, and the same exit code. The env fixtures are
   given to each analyzer in its own prefix (``TORCHSNAPSHOT_TPU_`` /
   ``TORCHSNAPSHOT_GPU_``), and the port's messages name its own docs
   page; both are mapped back before comparing.
2. **The legacy passes** — the synthetic ``check_source`` cases of
   ``tests/test_timing_lint.py``, ``tests/test_fanout.py``,
   ``tests/test_faultinject.py`` and ``tests/test_flightrec.py`` give
   equal results through both packages' plugins.
3. **The shipped tree** — ``python -m torchsnapshot_tpu_torch lint`` exits
   0 with every rule and an empty baseline; a seeded violation in a copy of
   the package fails it with exit 1 naming the rule.
4. **The registries** — the port's knob registry, governance table and
   election knobs are the JAX package's with the prefix swapped; its rule
   catalog is the JAX package's.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import torchsnapshot_tpu.analysis as J
import torchsnapshot_tpu_torch.analysis as P
from torchsnapshot_tpu.analysis import runner as jax_runner
from torchsnapshot_tpu.analysis import suppress as jax_suppress
from torchsnapshot_tpu.analysis.plugins import envreg as jax_envreg
from torchsnapshot_tpu.analysis.plugins import legacy_event_taxonomy as jax_taxonomy
from torchsnapshot_tpu.analysis.plugins import legacy_fault_sites as jax_fault_sites
from torchsnapshot_tpu.analysis.plugins import legacy_peer_channel as jax_peer
from torchsnapshot_tpu.analysis.plugins import legacy_timing as jax_timing
from torchsnapshot_tpu_torch.analysis import runner, suppress
from torchsnapshot_tpu_torch.analysis.plugins import PLUGINS, envreg
from torchsnapshot_tpu_torch.analysis.plugins import legacy_event_taxonomy as taxonomy
from torchsnapshot_tpu_torch.analysis.plugins import legacy_fault_sites as fault_sites
from torchsnapshot_tpu_torch.analysis.plugins import legacy_peer_channel as peer
from torchsnapshot_tpu_torch.analysis.plugins import legacy_timing as timing
from torch_test_env import autotune_never  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "torchsnapshot_tpu_torch"


def _to_jax(text: str) -> str:
    """The port's wording of a finding, mapped onto the JAX package's."""
    return (text.replace("TORCHSNAPSHOT_GPU_", "TORCHSNAPSHOT_TPU_")
            .replace("utilities_torch.rst", "utilities.rst"))


def _to_port(text: str) -> str:
    return text.replace("TORCHSNAPSHOT_TPU_", "TORCHSNAPSHOT_GPU_")


def _write_tree(root, files, env_prefix_port: bool = False) -> str:
    for sub, source in files.items():
        path = root / sub
        path.parent.mkdir(parents=True, exist_ok=True)
        text = textwrap.dedent(source)
        path.write_text(_to_port(text) if env_prefix_port else text)
    return str(root)


def _rows(report):
    """A report as comparable rows, the path prefix and the package's own
    names aside."""
    def row(f):
        return (f.rule, f.file.split("/", 1)[1], f.line, _to_jax(f.message))

    return {
        "findings": [row(f) for f in report.unsuppressed],
        "hygiene": [row(f) for f in report.hygiene],
        "suppressed": [(row(f), src.split(":", 1)[0]) for f, src in report.suppressed],
        "rules": report.rules_run,
        "errors": report.errors,
        "exit_code": report.exit_code,
    }


def _lint_both(tmp_path, files, rules, baseline=None, env=False):
    """Run both analyzers over the same tree (the env fixtures: each in
    its own prefix) and return (jax rows, port rows, port report)."""
    jax_dir = _write_tree(tmp_path / "jax" / "pkg", files)
    port_dir = jax_dir if not env else _write_tree(tmp_path / "port" / "pkg", files, True)
    base = baseline or str(tmp_path / "_no_baseline.json")
    jax_report = J.run_lint(rules=rules, project=J.Project(package_dir=jax_dir, rel_prefix="pkg"),
                            baseline_file=base)
    port_report = P.run_lint(rules=rules, project=P.Project(package_dir=port_dir, rel_prefix="pkg"),
                             baseline_file=base)
    return _rows(jax_report), _rows(port_report), port_report


# ------------------------------------------------------------ shared fixtures

_BLOCKING_FIXTURE = """\
    import time

    def f(lk):
        with lk:
            time.sleep(1.0)
    """

# (case, files, rules, what the JAX package's test expects of the report)
_FIXTURES = {
    "lock_order_inversion_seeded": ({
        "dist_store.py": """\
            class S:
                def bad(self, link):
                    with link.lock:
                        with self._cond:
                            pass
            """,
    }, ["lock-order"], {"findings": ["lock-order"], "exit": 1}),
    "lock_order_generic_inversion_seeded": ({
        "mod.py": """\
            class S:
                def ab(self):
                    with self.a_lock:
                        with self.b_lock:
                            pass

                def ba(self):
                    with self.b_lock:
                        with self.a_lock:
                            pass
            """,
    }, ["lock-order"], {"findings": ["lock-order"] * 2, "exit": 1}),
    "lock_blocking_seeded": ({"mod.py": _BLOCKING_FIXTURE}, ["lock-blocking"],
                             {"findings": ["lock-blocking"], "says": "time.sleep", "exit": 1}),
    "lock_blocking_one_level_descent": ({
        "mod.py": """\
            import time

            def _wait():
                time.sleep(1.0)

            def f(lk):
                with lk:
                    _wait()
            """,
    }, ["lock-blocking"], {"findings": ["lock-blocking"], "says": "_wait", "exit": 1}),
    "restricted_context_blocking_finalizer_seeded": ({
        "pool.py": """\
            import threading
            import weakref

            class Pool:
                def __init__(self):
                    self._lock = threading.Lock()
                    weakref.finalize(self, self._cleanup)

                def _cleanup(self):
                    with self._lock:
                        pass
            """,
    }, ["restricted-context"],
        {"findings": ["restricted-context"], "says": "finalizer", "exit": 1}),
    "resource_lifecycle_early_return_leak_seeded": ({
        "io.py": """\
            import os

            def read_header(path, probe):
                fd = os.open(path, os.O_RDONLY)
                if probe:
                    return None
                data = os.read(fd, 16)
                os.close(fd)
                return data
            """,
    }, ["resource-lifecycle"], {"findings": ["resource-lifecycle"], "says": "os.open", "exit": 1}),
    "resource_lifecycle_try_finally_is_clean": ({
        "io.py": """\
            import os

            def read_header(path, probe):
                fd = os.open(path, os.O_RDONLY)
                try:
                    if probe:
                        return None
                    return os.read(fd, 16)
                finally:
                    os.close(fd)
            """,
    }, ["resource-lifecycle"], {"findings": [], "exit": 0}),
    "env_unregistered_seeded": ({
        "knobs.py": """\
            import os

            def knob():
                return os.environ.get("TORCHSNAPSHOT_TPU_NOT_A_KNOB", "0")
            """,
    }, ["env-unregistered"], {"findings": ["env-unregistered"], "says": "_NOT_A_KNOB", "exit": 1}),
    "env_dynamic_seeded": ({
        "knobs.py": """\
            import os

            class Cfg:
                def get(self, name):
                    return os.environ.get(name)
            """,
    }, ["env-dynamic"], {"findings": ["env-dynamic"], "exit": 1}),
    "env_registered_read_is_clean": ({
        "knobs.py": """\
            import os

            def knob():
                return os.environ.get("TORCHSNAPSHOT_TPU_TELEMETRY", "0")
            """,
    }, ["env-unregistered", "env-dynamic"], {"findings": [], "exit": 0}),
    "inline_allow_suppresses": ({
        "mod.py": """\
            import time

            def f(lk):
                with lk:
                    # tsalint: allow[lock-blocking] fixture: deliberate hold
                    time.sleep(1.0)
            """,
    }, ["lock-blocking"], {"findings": [], "hygiene": [], "suppressed": 1, "exit": 0}),
    "inline_allow_comment_block_slides": ({
        "mod.py": """\
            import time

            def f(lk):
                with lk:
                    # tsalint: allow[lock-blocking] a long justification
                    # that continues onto a second comment line
                    time.sleep(1.0)
            """,
    }, ["lock-blocking"], {"findings": [], "hygiene": [], "suppressed": 1, "exit": 0}),
    "stale_allow_fails_the_run": ({
        "mod.py": """\
            # tsalint: allow[lock-blocking] nothing blocks here anymore
            X = 1
            """,
    }, ["lock-blocking"], {"hygiene": ["stale-suppression"], "exit": 1}),
    "allow_without_reason_fails_the_run": ({
        "mod.py": """\
            import time

            def f(lk):
                with lk:
                    # tsalint: allow[lock-blocking]
                    time.sleep(1.0)
            """,
    }, ["lock-blocking"], {"hygiene_has": "suppression-syntax", "exit": 1}),
    "allow_in_docstring_is_not_a_suppression": ({
        "mod.py": '''\
            """Docs: write '# tsalint: allow[lock-blocking] reason' above."""

            import time

            def f(lk):
                with lk:
                    time.sleep(1.0)
            ''',
    }, ["lock-blocking"], {"findings": ["lock-blocking"], "hygiene": [], "exit": 1}),
}


def _check_expected(port_report, want) -> None:
    if "findings" in want:
        assert [f.rule for f in port_report.unsuppressed] == want["findings"]
    if "says" in want:
        assert want["says"] in port_report.unsuppressed[0].message
    if "hygiene" in want:
        assert [f.rule for f in port_report.hygiene] == want["hygiene"]
    if "hygiene_has" in want:
        assert any(f.rule == want["hygiene_has"] for f in port_report.hygiene)
    if "suppressed" in want:
        assert len(port_report.suppressed) == want["suppressed"]
    assert port_report.exit_code == want["exit"]


@pytest.mark.parametrize("case", sorted(_FIXTURES))
def test_fixture_reports_equal_jax(case, tmp_path) -> None:
    files, rules, want = _FIXTURES[case]
    jax_rows, port_rows, port_report = _lint_both(
        tmp_path, files, rules, env=case.startswith("env_"))
    assert port_rows == jax_rows
    _check_expected(port_report, want)
    if case == "lock_order_inversion_seeded":
        assert port_report.unsuppressed[0].file == "pkg/dist_store.py"


def _baseline(tmp_path, rows) -> str:
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"suppressions": rows}))
    return str(base)


@pytest.mark.parametrize("case", ["suppresses", "goes_stale", "requires_reason"])
def test_baseline_reports_equal_jax(case, tmp_path) -> None:
    """``test_baseline_suppresses_and_goes_stale`` (both halves) and
    ``test_baseline_entry_requires_reason`` of the JAX package's tests."""
    entry = {"rule": "lock-blocking", "file": "pkg/mod.py", "reason": "adopted with the analyzer"}
    rows = {
        "suppresses": [entry],
        "goes_stale": [entry, {"rule": "lock-blocking", "file": "pkg/gone.py",
                               "reason": "file was deleted"}],
        "requires_reason": [{"rule": "lock-blocking", "file": "pkg/mod.py"}],
    }[case]
    jax_rows, port_rows, report = _lint_both(
        tmp_path, {"mod.py": _BLOCKING_FIXTURE}, ["lock-blocking"],
        baseline=_baseline(tmp_path, rows))
    assert port_rows == jax_rows
    if case == "suppresses":
        assert report.unsuppressed == [] and len(report.suppressed) == 1
        assert report.exit_code == P.EXIT_CLEAN
    elif case == "goes_stale":
        assert [f.rule for f in report.hygiene] == ["stale-suppression"]
        assert report.exit_code == P.EXIT_FINDINGS
    else:
        assert any(f.rule == "suppression-syntax" for f in report.hygiene)
        assert [f.rule for f in report.unsuppressed] == ["lock-blocking"]


def test_unknown_rule_is_usage_error_in_both(capsys) -> None:
    assert P.run_lint(rules=["no-such-rule"]).exit_code == P.EXIT_ERROR
    assert J.run_lint(rules=["no-such-rule"]).exit_code == J.EXIT_ERROR
    assert runner.main(["--rule", "no-such-rule"]) == jax_runner.main(["--rule", "no-such-rule"])
    capsys.readouterr()


def test_list_rules_equals_jax(capsys) -> None:
    assert runner.main(["--list-rules"]) == P.EXIT_CLEAN
    port_out = capsys.readouterr().out
    assert jax_runner.main(["--list-rules"]) == J.EXIT_CLEAN
    assert port_out == capsys.readouterr().out
    assert [(p.EXIT_CLEAN, p.EXIT_FINDINGS, p.EXIT_ERROR) for p in (P, J)] == [(0, 1, 2)] * 2
    assert len(port_out.splitlines()) == 14
    for mod in PLUGINS.values():
        for rule in mod.RULES:
            assert rule in port_out


# -------------------------------------------------------------- legacy passes


_TIMING_SOURCES = {
    "every_spelling": (
        "import time\n"
        "import time as _time\n"
        "from time import perf_counter\n"
        "from time import monotonic as mono\n"
        "t0 = time.monotonic()\n"
        "t1 = _time.perf_counter()\n"
        "t2 = perf_counter()\n"
        "t3 = mono()\n"
    ),
    "ns_clocks": "import time\nt = time.monotonic_ns() + time.perf_counter_ns()\n",
    "telemetry_clock_is_clean": "from . import telemetry\nt0 = telemetry.monotonic()\n",
    "wall_clock_is_clean": "import time\nstamp = time.time()\n",
}


@pytest.mark.parametrize("case", sorted(_TIMING_SOURCES))
def test_timing_pass_equals_jax(case, tmp_path) -> None:
    path = tmp_path / "mod.py"
    path.write_text(_TIMING_SOURCES[case])
    found = timing._violations_in(str(path))
    assert found == jax_timing._violations_in(str(path))
    if case == "every_spelling":
        # Two from-imports and four call sites (tests/test_timing_lint.py).
        assert len(found) == 6
        assert {"time.monotonic()", "_time.perf_counter()", "perf_counter()", "mono()"} <= {
            w for _, w in found}
    elif case.endswith("_is_clean"):
        assert found == []


def test_timing_pass_keeps_the_jax_allowlists() -> None:
    assert timing.ALLOWLIST == jax_timing.ALLOWLIST
    assert timing.TELEMETRY_COVERED == jax_timing.TELEMETRY_COVERED
    # This package has no benchmarks/: that directory is the JAX package's.
    assert not hasattr(timing, "BENCH_DIR")


_FAULT_SOURCES = {
    "violations": (
        "from . import faultinject\n"
        "from .faultinject import site\n"
        "faultinject.site('no.such.site')\n"
        "faultinject.site(some_variable)\n"
        "faultinject.configure('fs.write@1=kill')\n"
        "faultinject.mutate('fs.write', b'x')\n"
    ),
    "one_site_twice": (
        "from . import faultinject\nfaultinject.site('fs.write')\nfaultinject.site('fs.write')\n"
    ),
    "aliased_module": "from .. import faultinject as fi\nfi.site('commit.metadata')\nfi.plan\n",
    "clean": "from . import faultinject\nfaultinject.site('fs.read')\n",
}


@pytest.mark.parametrize("case", sorted(_FAULT_SOURCES))
def test_fault_sites_pass_equals_jax(case) -> None:
    source = _FAULT_SOURCES[case]
    got = fault_sites.check_source(source, "<test>")
    assert got == jax_fault_sites.check_source(source, "<test>")
    violations, uses = got
    if case == "violations":
        whats = "\n".join(w for _, w in violations)
        assert "from ...faultinject import" in whats
        assert "not registered" in whats
        assert "string literal" in whats
        assert "faultinject.configure" in whats
        assert uses == {"fs.write": [6]}
    elif case == "clean":
        assert violations == [] and uses == {"fs.read": [2]}


def test_fault_sites_pass_keeps_the_jax_pins_and_floor() -> None:
    assert fault_sites.PINNED_SITE_FILES == jax_fault_sites.PINNED_SITE_FILES
    assert fault_sites.MIN_SITES == jax_fault_sites.MIN_SITES
    assert fault_sites.KNOWN_SITES == jax_fault_sites.KNOWN_SITES


_TAXONOMY_SOURCES = {
    "events": (
        "from .telemetry import flightrec\n"
        "flightrec.record('not.an.event', a=1)\n"
        "flightrec.record(name_var, a=1)\n"
        "flightrec.record('phase', name='x')\n"
    ),
    "histograms": (
        "from . import telemetry\n"
        "telemetry.histogram_observe('no.such_hist', 0.1)\n"
        "telemetry.histogram_observe(computed_name, 0.1)\n"
        "telemetry.histogram_observe('write.entry_s', 0.1, key='FS')\n"
    ),
    "dotted_module": "from . import telemetry\ntelemetry.flightrec.record('store.failover')\n",
}


@pytest.mark.parametrize("case", sorted(_TAXONOMY_SOURCES))
def test_event_taxonomy_pass_equals_jax(case) -> None:
    source = _TAXONOMY_SOURCES[case]
    got = taxonomy.check_source(source, "bad.py")
    assert got == jax_taxonomy.check_source(source, "bad.py")
    violations, uses, hist_uses = got
    whats = "\n".join(w for _, w in violations)
    if case == "events":
        assert "not registered" in whats and "string literal" in whats
        assert uses == {"phase": [4]} and hist_uses == {}
    elif case == "histograms":
        assert "no.such_hist" in whats and "string literal" in whats
        assert hist_uses == {"write.entry_s": [4]}
    assert (taxonomy.MIN_EVENTS, taxonomy.MIN_HISTOGRAMS) == (
        jax_taxonomy.MIN_EVENTS, jax_taxonomy.MIN_HISTOGRAMS)


_PEER_SOURCES = {
    "module": "import jax\n\ndef f(x):\n    return jax.device_put(x)\n",
    "aliased": "import jax.numpy as jnp\n\ndef f(x):\n    return jnp.sum(x)\n",
    "from_import": "from jax import device_put\n\ndef f(x):\n    return device_put(x)\n",
    "clean": "import numpy as np\n\ndef f(x):\n    return np.sum(x)\n",
}


@pytest.mark.parametrize("case", sorted(_PEER_SOURCES))
def test_peer_channel_pass_equals_jax(case) -> None:
    source = _PEER_SOURCES[case]
    got = peer.check_source(source, "<synthetic>")
    assert got == jax_peer.check_source(source, "<synthetic>")
    if case == "module":
        assert len(got) >= 2
    elif case == "clean":
        assert got == []
    else:
        assert got
    assert peer.PEER_PLANE_FILES == jax_peer.PEER_PLANE_FILES


def test_peer_channel_pass_also_bans_torch() -> None:
    """The port's device library is torch: a device call or a collective
    on the peer plane is flagged, where the JAX package's pass (which bans
    only jax) sees nothing."""
    for source in ("import torch\n\ndef f(x):\n    return torch.cuda.synchronize()\n",
                   "import torch.distributed as dist\n\ndef f():\n    dist.barrier()\n",
                   "from torch import cuda\n\ndef f():\n    cuda.synchronize()\n"):
        found = peer.check_source(source, "<synthetic>")
        assert len(found) >= 2, source
        assert jax_peer.check_source(source, "<synthetic>") == []


# ------------------------------------------------------------ shipped tree


def _lint_subprocess(cwd: str, *args: str):
    env = dict(os.environ, PYTHONPATH=cwd)
    env.pop(suppress.BASELINE_ENV_VAR, None)
    return subprocess.run([sys.executable, "-m", PKG, "lint", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_port_package_scan_clean() -> None:
    """Every rule runs on the shipped tree, with the empty baseline, and
    finds nothing unsuppressed."""
    r = _lint_subprocess(REPO, "--json")
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["exit_code"] == 0 and doc["errors"] == []
    assert doc["findings"] == [] and doc["hygiene"] == []
    assert sorted(doc["rules"]) == sorted(r for m in PLUGINS.values() for r in m.RULES)
    assert len(doc["rules"]) == 14
    assert all(s["suppressed_by"].startswith("in-file:") for s in doc["suppressed"])


def test_module_entrypoint_json_rule_subset() -> None:
    r = _lint_subprocess(REPO, "--json", "--rule", "timing", "--rule", "peer-channel")
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["exit_code"] == 0 and doc["findings"] == []
    assert sorted(doc["rules"]) == ["peer-channel", "timing"]


def _copy_tree(dst) -> str:
    """The package, its docs page, its contract tests and its baseline:
    what the port's lint reads."""
    shutil.copytree(os.path.join(REPO, PKG), dst / PKG,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel in ("docs/source/utilities_torch.rst", "tests/test_torch_streaming_read.py",
                ".tsalint_baseline_torch.json"):
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst / rel)
    return str(dst)


def test_a_seeded_violation_fails_the_port_lint(tmp_path) -> None:
    root = _copy_tree(tmp_path)
    target = tmp_path / PKG / "retention.py"
    source = target.read_text()
    lines = len(source.splitlines())
    seeded = "\n\ndef _seeded():\n    import time\n\n    return time.monotonic()\n"
    target.write_text(source + seeded)
    r = _lint_subprocess(root, "--json")
    assert r.returncode == 1, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert [(f["rule"], f["file"], f["line"]) for f in doc["findings"]] == [
        ("timing", f"{PKG}/retention.py", lines + 6)]


def test_an_undocumented_or_dead_knob_fails_the_port_lint(tmp_path, monkeypatch) -> None:
    with open(envreg.UTILITIES_RST) as f:
        doc = f.read()
    dropped = "TORCHSNAPSHOT_GPU_SEED_TTL_S"
    page = tmp_path / "utilities_torch.rst"
    page.write_text(doc.replace(f"``{dropped}``", "``(dropped)``"))
    monkeypatch.setattr(envreg, "UTILITIES_RST", str(page))
    monkeypatch.setattr(envreg, "ENV_REGISTRY", envreg.ENV_REGISTRY | {"TORCHSNAPSHOT_GPU_GONE"})
    report = P.run_lint(rules=["env-undocumented", "env-dead"],
                        baseline_file=str(tmp_path / "_none.json"))
    got = sorted((f.rule, f.message.split()[0]) for f in report.unsuppressed)
    assert got == [("env-dead", "TORCHSNAPSHOT_GPU_GONE"), ("env-undocumented", dropped)]
    assert report.exit_code == P.EXIT_FINDINGS


def test_baseline_env_var_is_honoured(monkeypatch, tmp_path) -> None:
    assert suppress.BASELINE_ENV_VAR == "TORCHSNAPSHOT_GPU_LINT_BASELINE"
    assert suppress.DEFAULT_BASELINE == os.path.join(REPO, ".tsalint_baseline_torch.json")
    override = tmp_path / "elsewhere.json"
    monkeypatch.setenv(suppress.BASELINE_ENV_VAR, str(override))
    # The JAX package's variable configures the JAX package only.
    monkeypatch.setenv(jax_suppress.BASELINE_ENV_VAR, str(tmp_path / "jax.json"))
    assert suppress.baseline_path() == str(override)
    override.write_text(json.dumps({"suppressions": [
        {"rule": "lock-blocking", "file": "pkg/mod.py", "reason": "adopted with the analyzer"}]}))
    project = P.Project(package_dir=_write_tree(tmp_path / "pkg", {"mod.py": _BLOCKING_FIXTURE}),
                        rel_prefix="pkg")
    report = P.run_lint(rules=["lock-blocking"], project=project)
    assert report.unsuppressed == [] and report.exit_code == P.EXIT_CLEAN
    assert report.suppressed[0][1] == "baseline:#0"
    monkeypatch.delenv(suppress.BASELINE_ENV_VAR)
    assert suppress.baseline_path() == suppress.DEFAULT_BASELINE


def test_shipped_baseline_is_empty() -> None:
    with open(os.path.join(REPO, ".tsalint_baseline_torch.json")) as f:
        doc = json.load(f)
    assert doc["suppressions"] == []
    with open(os.path.join(REPO, ".tsalint_baseline.json")) as f:
        assert doc["_comment"] == json.load(f)["_comment"]


# -------------------------------------------------------------- registries


def test_env_registry_is_jax_with_the_prefix_swapped() -> None:
    """The knob diff, automated: every knob the JAX package registers is
    registered here under this package's prefix, and no other."""
    from torchsnapshot_tpu import scheduler as jax_scheduler
    from torchsnapshot_tpu_torch import scheduler

    assert envreg.ENV_PREFIX == "TORCHSNAPSHOT_GPU_"
    assert envreg.ENV_REGISTRY == {_to_port(n) for n in jax_envreg.ENV_REGISTRY}
    assert envreg.ENV_GOVERNANCE == {_to_port(k): v for k, v in jax_envreg.ENV_GOVERNANCE.items()}
    assert len(envreg.ENV_GOVERNANCE) == 12
    assert scheduler.ELECTION_KNOBS == {_to_port(n) for n in jax_scheduler.ELECTION_KNOBS}
    assert "TORCHSNAPSHOT_GPU_LINT_BASELINE" in envreg.ENV_REGISTRY


def test_every_knob_has_a_row_naming_its_jax_counterpart() -> None:
    with open(envreg.UTILITIES_RST) as f:
        rows = [line.split() for line in f if line.startswith("``TORCHSNAPSHOT_GPU_")]
    assert {r[0].strip("`") for r in rows} == set(envreg.ENV_REGISTRY)
    assert all(r[1].strip("`") == r[0].strip("`").replace("_GPU_", "_TPU_") for r in rows)


def test_the_rules_and_plugins_are_the_jax_packages() -> None:
    from torchsnapshot_tpu.analysis.plugins import PLUGINS as JAX_PLUGINS

    assert list(PLUGINS) == list(JAX_PLUGINS)
    assert [m.RULES for m in PLUGINS.values()] == [m.RULES for m in JAX_PLUGINS.values()]
    assert P.__all__ == J.__all__
