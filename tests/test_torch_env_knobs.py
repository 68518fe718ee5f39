"""Env knobs that the port reads or refuses as the JAX package reads them.

Each test runs both packages with the same knob value and compares what
they do: the kind of buffer a large fs read returns under
``*_MMAP_READS``, the CPU worker count under ``*_CPU_CONCURRENCY``, the
telemetry core's knobs (the bus, its event cap, the flight recorder, its
ring, dump directory and SIGTERM dump, the heartbeat cadence and the
progress reporter's cadence), the durability tier's knobs (the journal
and its bounds, the manifest format), and that the port turns on the
``/metrics`` exporter for exactly the values that turn it on in JAX.
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
from torch_test_env import autotune_never  # noqa: F401 - autouse

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


def _port_take_starts_exporter(tmp_path, monkeypatch, value: str) -> bool:
    """Whether a port take under ``*_METRICS_PORT=value`` starts the
    /metrics exporter (its start recorded, not bound)."""
    from torchsnapshot_tpu_torch.telemetry import promexp

    started = []
    monkeypatch.setattr(promexp, "start_exporter", lambda port, rank=None: started.append(port))
    monkeypatch.setenv(promexp.METRICS_PORT_ENV_VAR, value)
    try:
        P.Snapshot.take(str(tmp_path / f"s_{len(os.listdir(tmp_path))}"),
                        {"app": P.StateDict(w=torch.ones(2))})
    finally:
        monkeypatch.delenv(promexp.METRICS_PORT_ENV_VAR)
    return bool(started)


@pytest.mark.parametrize(
    "value", ["1", "on", "true", "yes", "always", "ALWAYS", "0", "", "auto", "off", "never", "2"]
)
def test_telemetry_knob_is_refused_exactly_where_jax_turns_it_on(tmp_path, monkeypatch, value):
    """The telemetry knob is honoured since the telemetry core is ported:
    it turns the bus on for exactly the values that turn it on in JAX, and
    a take then writes ``.snapshot_telemetry`` (the test keeps the name it
    had while the port refused those values)."""
    from torchsnapshot_tpu_torch.telemetry import core as port_telemetry

    monkeypatch.setenv(jax_telemetry.TELEMETRY_ENV_VAR, value)
    monkeypatch.setenv(port_telemetry.TELEMETRY_ENV_VAR, value)
    jax_on = jax_telemetry._env_enabled()
    try:
        assert port_telemetry.refresh_from_env() == jax_on
        root = str(tmp_path / "s")
        P.Snapshot.take(root, {"app": P.StateDict(w=torch.ones(2))})
        assert os.path.exists(os.path.join(root, ".snapshot_telemetry")) == jax_on
    finally:
        monkeypatch.delenv(port_telemetry.TELEMETRY_ENV_VAR)
        port_telemetry.refresh_from_env()
    assert not port_telemetry.enabled()


@pytest.mark.parametrize("value", ["1", "on", "true", "yes", "YES", "always", "0", "", "off"])
def test_flightrec_sigterm_knob_dumps_exactly_where_jax_does(tmp_path, monkeypatch, value):
    """``*_FLIGHTREC_SIGTERM``: a watcher that saw the signal dumps the ring
    to ``*_FLIGHTREC_DIR`` on its next call for exactly the values the JAX
    package dumps for."""
    import signal

    from torchsnapshot_tpu import preemption as jax_preemption
    from torchsnapshot_tpu_torch import preemption as port_preemption

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_FLIGHTREC_SIGTERM", value)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_FLIGHTREC_SIGTERM", value)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_FLIGHTREC_DIR", str(tmp_path))
    jax_on = jax_preemption._sigterm_dump_enabled()
    assert port_preemption._sigterm_dump_enabled() == jax_on
    watcher = port_preemption.PreemptionWatcher(signals=(signal.SIGUSR1,))
    try:
        watcher._handle(signal.SIGUSR1, None)
        watcher._log_pending()
    finally:
        watcher.close()
    dump = tmp_path / ".flight" / "rank_0.jsonl"
    assert dump.exists() == jax_on
    if jax_on:
        assert b"preempt.signal" in dump.read_bytes()


_TELEMETRY_VALUES = ["", "1", "0", "7", "2.5", "-3", "bogus", " 12 ", "on", "off"]


@pytest.mark.parametrize("value", _TELEMETRY_VALUES)
def test_telemetry_core_knobs_parse_as_in_jax(monkeypatch, value) -> None:
    """The event cap, the flight recorder's switch and ring size and the
    heartbeat cadence: each parser decides what the JAX package's
    decides, value for value."""
    from torchsnapshot_tpu.telemetry import flightrec as jax_fr
    from torchsnapshot_tpu.telemetry import health as jax_health
    from torchsnapshot_tpu_torch.telemetry import core as port_core
    from torchsnapshot_tpu_torch.telemetry import flightrec as port_fr
    from torchsnapshot_tpu_torch.telemetry import health as port_health

    for suffix in ("TELEMETRY_MAX_EVENTS", "FLIGHTREC", "FLIGHTREC_RING", "HEARTBEAT_S"):
        monkeypatch.setenv(f"TORCHSNAPSHOT_TPU_{suffix}", value)
        monkeypatch.setenv(f"TORCHSNAPSHOT_GPU_{suffix}", value)
    assert port_core._read_max_events() == jax_telemetry._read_max_events()
    assert port_fr._env_enabled() == jax_fr._env_enabled()
    assert port_fr._read_ring_size() == jax_fr._read_ring_size()
    assert port_health.heartbeat_cadence_s() == jax_health.heartbeat_cadence_s()


@pytest.mark.parametrize("value", [None, "", "0.25", "1", "30", "bogus", "1e-3", " 2 "])
def test_progress_knob_sets_the_reporters_interval_as_in_jax(monkeypatch, value) -> None:
    """``*_PROGRESS_S`` (F7): the port's progress reporter samples at the
    interval JAX's ``_ProgressReporter`` takes from the same value (5.0
    when unset or unparsable)."""
    from torchsnapshot_tpu import scheduler as jax_scheduler
    from torchsnapshot_tpu_torch import scheduler as port_scheduler

    for name in ("TORCHSNAPSHOT_TPU_PROGRESS_S", "TORCHSNAPSHOT_GPU_PROGRESS_S"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    jax_r = jax_scheduler._ProgressReporter("write", 0, 1, jax_scheduler._MemoryBudget(1 << 20))
    port_r = port_scheduler._ProgressReporter("write", 0, 1, port_scheduler._MemoryBudget(1 << 20))
    assert port_r.interval_s == jax_r.interval_s


@pytest.mark.parametrize("value", ["9464", "0", "1", " 9484 ", "-1", "", "auto", "port"])
def test_metrics_port_knob_is_refused_exactly_where_jax_starts_it(tmp_path, monkeypatch, value):
    """The /metrics exporter is ported: a take starts it for exactly the
    values that start it in JAX (the test keeps the name it had while the
    port refused those values)."""
    jax_on = _jax_metrics_port_starts(value)
    assert _port_take_starts_exporter(tmp_path, monkeypatch, value) == jax_on


@pytest.mark.parametrize("value", ["1", "0", "", "false", "yes", "off", "2"])
def test_journal_knobs_parse_as_in_jax(monkeypatch, value) -> None:
    from torchsnapshot_tpu import journal as jax_journal
    from torchsnapshot_tpu_torch import journal as port_journal

    for suffix in ("JOURNAL", "JOURNAL_EPOCH_BYTES", "JOURNAL_MAX_EPOCHS"):
        monkeypatch.setenv(f"TORCHSNAPSHOT_TPU_{suffix}", value)
        monkeypatch.setenv(f"TORCHSNAPSHOT_GPU_{suffix}", value)
    assert port_journal.enabled_by_env() == jax_journal.enabled_by_env()
    assert port_journal.epoch_bytes_cap() == jax_journal.epoch_bytes_cap()
    assert port_journal.max_epochs() == jax_journal.max_epochs()


@pytest.mark.parametrize("value", ["columnar", "json", "", "COLUMNAR", "1"])
def test_manifest_format_knob_writes_tscm_exactly_where_jax_does(tmp_path, monkeypatch, value):
    import jax.numpy as jnp

    import torchsnapshot_tpu as J

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_MANIFEST_FORMAT", value)
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_MANIFEST_FORMAT", value)
    J.Snapshot.take(str(tmp_path / "j"), {"app": J.StateDict(w=jnp.ones(2))})
    P.Snapshot.take(str(tmp_path / "p"), {"app": P.StateDict(w=torch.ones(2))})
    heads = [open(tmp_path / d / ".snapshot_metadata", "rb").read(4) for d in ("j", "p")]
    assert (heads[0] == b"TSCM") == (heads[1] == b"TSCM") == (value == "columnar")


@pytest.mark.parametrize("value", ["1", "on", "true", "yes", "YES", "0", "", "off", "no", "false"])
def test_update_push_knob_is_refused_exactly_where_jax_turns_it_on(tmp_path, monkeypatch, value):
    """``TORCHSNAPSHOT_GPU_UPDATE_PUSH`` turns on the push after each
    committed epoch for exactly the values that make the JAX package push
    (before the rolling-update push was ported, those values were refused
    by name; the test keeps its name)."""
    from torchsnapshot_tpu import distrib
    from torchsnapshot_tpu_torch import distrib as port_distrib

    monkeypatch.setenv("TORCHSNAPSHOT_TPU_UPDATE_PUSH", value)
    jax_on = distrib.update_push_enabled()
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_JOURNAL", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_UPDATE_PUSH", value)
    assert port_distrib.update_push_enabled() == jax_on
    pushes = []
    monkeypatch.setattr(P.CheckpointManager, "push_update", lambda self: pushes.append(1))
    mgr = P.CheckpointManager(str(tmp_path))
    state = {"app": P.StateDict(w=torch.ones(2))}
    mgr.save(0, state)
    state["app"]["w"] = torch.zeros(2)
    assert mgr.journal_step(1, state)
    assert len(pushes) == int(jax_on)
