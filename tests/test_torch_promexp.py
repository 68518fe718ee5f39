"""The port's live /metrics exporter against the JAX package's.

- The same bus and heartbeat state renders the same OpenMetrics text in
  both packages (the family names are the JAX package's), which
  ``prometheus_client``'s strict parser accepts where it is installed.
- The exporter starts for an integer port >= 0 only, serves ``GET
  /metrics`` (404 elsewhere) from a thread and is started once a process.
- A scrape while a port take is held mid-write shows the take's phase and
  non-zero byte counts, and ends ``# EOF``.
"""

from __future__ import annotations

import asyncio
import http.client
import threading

import pytest
import torch

import torchsnapshot_tpu_torch as P
from torchsnapshot_tpu import telemetry as jax_telemetry
from torchsnapshot_tpu.telemetry import promexp as jax_promexp
from torchsnapshot_tpu_torch import telemetry
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.telemetry import health, promexp
from torch_test_env import autotune_never  # noqa: F401 - autouse


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(promexp.METRICS_PORT_ENV_VAR, raising=False)
    for tel in (telemetry, jax_telemetry):
        tel.set_enabled(False)
        tel.reset()
        tel.health.clear()
    yield
    promexp.stop_exporter()
    for tel in (telemetry, jax_telemetry):
        tel.set_enabled(False)
        tel.reset()
        tel.health.clear()


def _families(text: str):
    parser = pytest.importorskip("prometheus_client.openmetrics.parser")
    return list(parser.text_string_to_metric_families(text))


def _get(port: int, path: str = "/metrics"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read().decode("utf-8")
    finally:
        conn.close()


def _written_bytes(text: str) -> float:
    """The heartbeat's ``written_bytes`` in a scrape, or -1 before the
    first tick that published it."""
    for f in _families(text):
        if f.name == "torchsnapshot_tpu_heartbeat_written_bytes":
            return f.samples[0].value
    return -1.0


def _feed(tel, state: int) -> None:
    tel.set_enabled(True)
    if state >= 1:
        tel.counter_add("bytes_written", 123)
        tel.counter_add("bytes_staged", 4567)
        tel.gauge_set("budget_free_bytes", 7.5)
    if state >= 2:
        for v in (0.002, 0.02, 0.2, 2.0):
            tel.histogram_observe("write.entry_s", v, key="FSStoragePlugin")
        tel.histogram_observe("collective.wait_s", 0.01, key="barrier")
    if state >= 3:
        tel.health.update(op="take", phase="write", staged_bytes=4567, written_bytes=123,
                          total_bytes=9000, inflight_io=2, binding="storage_write", step=7)


@pytest.mark.parametrize("state", [0, 1, 2, 3])
@pytest.mark.parametrize("rank", [None, 3])
def test_the_same_state_renders_the_same_families(state, rank) -> None:
    _feed(telemetry, state)
    _feed(jax_telemetry, state)
    mine, theirs = promexp.render_live(rank=rank), jax_promexp.render_live(rank=rank)
    assert mine == theirs
    assert mine.endswith("# EOF\n")
    names = {f.name for f in _families(mine)}
    assert names == {f.name for f in _families(theirs)}
    if state >= 2:
        assert "torchsnapshot_tpu_write_entry_s" in names
    if state >= 3:
        assert 'phase="write"' in mine and "torchsnapshot_tpu_heartbeat_staged_bytes" in names


@pytest.mark.parametrize("value", ["", "0", "-1", "x", " 0 "])
def test_maybe_start_starts_for_an_integer_port_of_zero_or_more(monkeypatch, value) -> None:
    monkeypatch.setenv(promexp.METRICS_PORT_ENV_VAR, value)
    exporter = promexp.maybe_start(rank=0)
    assert (exporter is not None) == (value.strip() == "0")
    if exporter is not None:
        assert promexp.maybe_start(rank=1) is exporter  # once a process
        status, ctype, body = _get(exporter.port)
        assert status == 200 and ctype == promexp.CONTENT_TYPE == jax_promexp.CONTENT_TYPE
        assert body.endswith("# EOF\n")
        assert _get(exporter.port, "/nope")[0] == 404


def test_a_scrape_during_a_held_take_shows_its_phase_and_bytes(tmp_path, monkeypatch) -> None:
    """The take's second payload write is held on an event while the
    exposition is scraped, so the scrape lands mid-op."""
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_TELEMETRY", "1")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_PROGRESS_S", "0.01")
    monkeypatch.setenv("TORCHSNAPSHOT_GPU_IO_CONCURRENCY", "1")
    monkeypatch.setenv(promexp.METRICS_PORT_ENV_VAR, "0")
    telemetry.refresh_from_env()
    held, release = threading.Event(), threading.Event()
    write = FSStoragePlugin.write
    writes = []

    async def gated(self, write_io):
        if not write_io.path.startswith("."):
            writes.append(write_io.path)
            if len(writes) == 2:
                held.set()
                while not release.is_set():
                    await asyncio.sleep(0.01)
        return await write(self, write_io)

    monkeypatch.setattr(FSStoragePlugin, "write", gated)
    state = {f"w{i}": torch.full((1 << 14,), float(i)) for i in range(3)}
    err = []

    def take():
        try:
            P.Snapshot.take(str(tmp_path / "s"), {"m": P.StateDict(state)})
        except BaseException as e:  # noqa: BLE001 - reported below
            err.append(e)

    t = threading.Thread(target=take)
    t.start()
    try:
        assert held.wait(30)
        exporter = promexp.active_exporter()
        assert exporter is not None
        scrapes = []
        for _ in range(50):
            scrapes.append(_get(exporter.port)[2])
            # A tick that ran before the first write completed published
            # 0: wait for the tick that publishes the first write's bytes.
            if _written_bytes(scrapes[-1]) > 0:
                break
            release.wait(0.02)
    finally:
        release.set()
        t.join(60)
    assert not err
    text = scrapes[-1]
    assert text.endswith("# EOF\n")
    assert 'phase="' in text
    families = {f.name: f for f in _families(text)}
    staged = families["torchsnapshot_tpu_bytes_staged"].samples[0].value
    assert staged > 0
    assert families["torchsnapshot_tpu_heartbeat_written_bytes"].samples[0].value > 0
