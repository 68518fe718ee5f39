"""The port's retry taxonomy against the JAX package's
(``storage_plugins/retry.py``): the same exceptions classify alike, the
same seed jitters alike, and the collective strategy sleeps and gives up on
the same schedule."""

from __future__ import annotations

import asyncio
import random

import pytest

from torchsnapshot_tpu import dist_store as jax_dist_store
from torchsnapshot_tpu.storage_plugins import retry as J
from torchsnapshot_tpu_torch import dist_store as port_dist_store
from torchsnapshot_tpu_torch.storage_plugins import retry as P
from torch_test_env import autotune_never  # noqa: F401 - autouse


class TooManyRequests(Exception):
    pass


class InternalServerError(Exception):
    pass


class DeadlineExceeded(Exception):
    pass


class ReadTimeoutError(Exception):
    pass


class ChunkedEncodingError(Exception):
    pass


class EndpointConnectionError(Exception):
    pass


class NoSuchKey(Exception):
    pass


class NotFound(Exception):
    pass


class ClientError(Exception):
    def __init__(self, code: int, err: str) -> None:
        super().__init__(f"{code} {err}")
        self.response = {"ResponseMetadata": {"HTTPStatusCode": code}, "Error": {"Code": err}}


EXCEPTIONS = [
    FileNotFoundError("x"),
    KeyError("k"),
    PermissionError("denied"),
    ValueError("bad"),
    ConnectionError("reset"),
    ConnectionResetError("reset"),
    TimeoutError("slow"),
    OSError(5, "io"),
    EOFError("short"),
    TooManyRequests(),
    InternalServerError(),
    DeadlineExceeded(),
    ReadTimeoutError(),
    ChunkedEncodingError(),
    EndpointConnectionError(),
    NoSuchKey(),
    NotFound(),
    ClientError(429, "Throttling"),
    ClientError(503, "ServiceUnavailable"),
    ClientError(400, "SlowDown"),
    ClientError(400, "RequestTimeout"),
    ClientError(400, "InternalError"),
    ClientError(403, "AccessDenied"),
    RuntimeError("other"),
]


@pytest.mark.parametrize("exc", EXCEPTIONS, ids=lambda e: f"{type(e).__name__}-{e}")
def test_taxonomy_equals_jax(exc) -> None:
    assert P.classify_error(exc) == J.classify_error(exc)
    assert P.is_transient_error(exc) == J.is_transient_error(exc)
    assert P.is_not_found_error(exc) == J.is_not_found_error(exc)


def test_taxonomy_kinds() -> None:
    assert P.classify_error(TooManyRequests()) == "throttle"
    assert P.classify_error(ClientError(503, "x")) == "server"
    assert P.classify_error(TimeoutError()) == "timeout"
    assert P.classify_error(ConnectionResetError()) == "connection"
    assert P.classify_error(ValueError()) == "other"
    assert P.is_not_found_error(NoSuchKey()) and not P.is_not_found_error(PermissionError())


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_backoff_with_jitter_equals_jax_under_one_seed(seed) -> None:
    attempts = [0, 1, 2, 3, 5, 10, 16, 17, 2000]
    random.seed(seed)
    want = [J.backoff_with_jitter(a) for a in attempts] + [
        J.backoff_with_jitter(a, base_s=0.25, cap_s=2.0) for a in attempts
    ]
    random.seed(seed)
    got = [P.backoff_with_jitter(a) for a in attempts] + [
        P.backoff_with_jitter(a, base_s=0.25, cap_s=2.0) for a in attempts
    ]
    assert got == want
    assert all(0 < b <= 8.0 for b in got)


def test_store_connect_backoff_is_the_retry_tiers() -> None:
    random.seed(3)
    want = [jax_dist_store._connect_backoff_s(a) for a in range(8)]
    random.seed(3)
    assert [port_dist_store._connect_backoff_s(a) for a in range(8)] == want


def _schedule(module, seed: int):
    """Drive one strategy through a scripted fleet: transient errors with
    the clock advancing, progress that re-arms the deadline, and a stall
    past it. Returns (sleeps, the attempt that raised, its history)."""
    now = [0.0]
    sleeps = []

    async def sleep(s):
        sleeps.append(s)
        now[0] += s

    strategy = module.CollectiveRetryStrategy(
        stall_timeout_s=10.0, clock=lambda: now[0], sleep=sleep
    )
    random.seed(seed)

    async def run():
        attempt = 0
        slept = 0.0
        while True:
            started = now[0]
            now[0] += 1.0  # the attempt's own duration
            if attempt == 3:
                strategy.report_progress()
            try:
                slept += await strategy.backoff_or_raise(
                    ConnectionResetError("reset"), attempt, op_started_at=started, op="get",
                    backoff_slept_s=slept,
                )
            except ConnectionResetError as e:
                return attempt, {
                    k: getattr(e, k) for k in (
                        "retry_attempts", "retry_error_kind", "retry_backoff_slept_s",
                        "retry_fleet_attempts", "retry_fleet_backoff_s",
                    )
                }
            attempt += 1

    attempt, history = asyncio.run(run())
    return sleeps, attempt, history, strategy.fleet_attempts


@pytest.mark.parametrize("seed", [1, 2])
def test_collective_retry_schedule_equals_jax(seed) -> None:
    jax_sleeps, jax_attempt, jax_history, jax_fleet = _schedule(J, seed)
    sleeps, attempt, history, fleet = _schedule(P, seed)
    assert sleeps == jax_sleeps
    assert attempt == jax_attempt and attempt > 3
    assert history == jax_history
    assert history["retry_error_kind"] == "connection"
    assert fleet == jax_fleet == len(sleeps)


def test_reset_disarms_the_deadline() -> None:
    now = [100.0]

    async def sleep(s):
        now[0] += s

    s = P.CollectiveRetryStrategy(stall_timeout_s=1.0, clock=lambda: now[0], sleep=sleep)
    s.report_progress()
    now[0] += 50.0
    s.reset()
    assert s.fleet_attempts == 0
    # A fresh fleet gets a retry, however long ago the last one progressed.
    assert asyncio.run(s.backoff_or_raise(TimeoutError(), 0)) > 0


def test_attach_history_and_fallback_history_equal_jax() -> None:
    e_port, e_jax = OSError("x"), OSError("x")
    P.attach_retry_history(e_port, 3, "server", 1.23456, 7, 9.87654)
    J.attach_retry_history(e_jax, 3, "server", 1.23456, 7, 9.87654)
    keys = ("retry_attempts", "retry_error_kind", "retry_backoff_slept_s",
            "retry_fleet_attempts", "retry_fleet_backoff_s")
    assert [getattr(e_port, k) for k in keys] == [getattr(e_jax, k) for k in keys]
    assert len(e_port.__notes__) == 1

    fresh = TimeoutError("t")
    assert P.attach_fallback_history(fresh) == "timeout"
    assert fresh.retry_attempts == 1 and fresh.retry_fleet_attempts == 0
    # Real history from the storage layer is never zeroed by a fallback.
    assert P.attach_fallback_history(e_port, kind="other") == "other"
    assert e_port.retry_attempts == 3


def test_named_labels_closures_and_bound_methods() -> None:
    fn = P.named(lambda: 5, "put")
    assert fn.__name__ == "put" and fn() == 5
    bound = P.named([1, 2].copy, "get")
    assert bound.__name__ == "get" and bound() == [1, 2]


def test_ordered_window_chunks_orders_and_refuses_short_reads() -> None:
    data = bytes(range(100))

    async def collect(spans, short_at=None):
        loop = asyncio.get_running_loop()

        def fetch(lo, hi):
            fut = loop.create_future()
            fut.set_result(data[lo:hi - 1] if lo == short_at else data[lo:hi])
            return fut

        return [c async for c in P.ordered_window_chunks("p", spans, fetch, 2)]

    spans = [(0, 30), (30, 60), (60, 100)]
    assert b"".join(asyncio.run(collect(spans))) == data
    with pytest.raises(IOError, match="short read"):
        asyncio.run(collect(spans, short_at=30))


@pytest.mark.parametrize("value", ["", "4", "bogus", "0"])
def test_cloud_io_threads_knob_sizes_the_pool_as_jax(monkeypatch, value) -> None:
    monkeypatch.setenv(P.CLOUD_IO_THREADS_ENV_VAR, value)
    monkeypatch.setenv(J.CLOUD_IO_THREADS_ENV_VAR, value)
    monkeypatch.setattr(P, "_executor", None)
    monkeypatch.setattr(J, "_executor", None)
    port_pool, jax_pool = P.cloud_io_executor(), J.cloud_io_executor()
    try:
        assert port_pool._max_workers == jax_pool._max_workers
        assert P.cloud_io_executor() is port_pool
    finally:
        port_pool.shutdown()
        jax_pool.shutdown()
