"""Shared storage retry machinery: one error taxonomy for every retry and
every fallback.

Counterpart of ``torchsnapshot_tpu/storage_plugins/retry.py``. Transport
agnostic: the cloud plugins (``s3.py``, ``gcs.py``) drive their transfers
through one :class:`CollectiveRetryStrategy` a snapshot operation; the mirror tier
and the peer read path classify their degraded-path errors with
:func:`classify_error` and stamp them with :func:`attach_fallback_history`;
the coordination store's connect retries jitter with
:func:`backoff_with_jitter`.

The botocore, google-api and requests branches of
:func:`is_transient_error` import lazily and tolerate absence, so this
module needs none of the cloud SDKs. ``TORCHSNAPSHOT_GPU_CLOUD_IO_THREADS``
sizes :func:`cloud_io_executor` (default 16).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
from typing import Any, Callable, Optional

from .. import telemetry

logger = logging.getLogger(__name__)

BASE_BACKOFF_S = 0.5
MAX_BACKOFF_S = 8.0
STALL_TIMEOUT_S = 120.0


def backoff_with_jitter(
    attempt: int,
    base_s: float = BASE_BACKOFF_S,
    cap_s: float = MAX_BACKOFF_S,
) -> float:
    """Jittered exponential backoff, ``base * 2^attempt * (1 + rand)``
    capped at ``cap``; the exponent is capped before exponentiating, since
    ``2**attempt`` overflows float conversion near attempt 1076."""
    raw = base_s * (2 ** min(attempt, 16)) * (1.0 + random.random())
    return min(raw, cap_s)


def named(fn: Callable[[], Any], op: str) -> Callable[[], Any]:
    """Label a transfer closure for retry telemetry: retry wrappers read
    ``__name__`` as the op tag, and lambdas would all say ``<lambda>``."""
    try:
        fn.__name__ = op
        return fn
    except AttributeError:
        # Bound methods reject attribute writes: wrap instead.
        def call() -> Any:
            return fn()

        call.__name__ = op
        return call


def observe_storage_op(plugin: str, op: Optional[str], seconds: float) -> None:
    """Record one successful storage operation's latency into the
    ``storage.op_s`` histogram, keyed ``<Plugin>.<op>``. One flag check
    when telemetry is off."""
    if not telemetry.enabled():
        return
    telemetry.histogram_observe(
        "storage.op_s", seconds, key=f"{plugin}.{op}" if op else plugin
    )


def is_transient_error(exc: BaseException) -> bool:
    """Transport errors worth retrying: 429/5xx-style service faults,
    connection failures and timeouts. Everything else (permission denied,
    not found, invalid request) propagates at once."""
    try:
        from google.api_core import exceptions as gexc

        transient = (
            gexc.TooManyRequests,
            gexc.InternalServerError,
            gexc.BadGateway,
            gexc.ServiceUnavailable,
            gexc.GatewayTimeout,
            gexc.DeadlineExceeded,
        )
        if isinstance(exc, transient):
            return True
    except ImportError:  # pragma: no cover - optional SDK
        pass
    try:
        import requests.exceptions as rexc

        # requests' ConnectionError subclasses OSError, not the builtin
        # ConnectionError: check it explicitly.
        if isinstance(exc, (rexc.ConnectionError, rexc.Timeout, rexc.ChunkedEncodingError)):
            return True
    except ImportError:  # pragma: no cover - optional package
        pass
    try:
        import botocore.exceptions as bexc

        if isinstance(
            exc,
            (
                bexc.ConnectionError,
                bexc.HTTPClientError,
                bexc.ReadTimeoutError,
                bexc.ConnectTimeoutError,
            ),
        ):
            return True
        if isinstance(exc, bexc.ClientError):
            code = (
                exc.response.get("ResponseMetadata", {}).get("HTTPStatusCode", 0)
                if getattr(exc, "response", None)
                else 0
            )
            if code == 429 or 500 <= code < 600:
                return True
            if exc.response.get("Error", {}).get("Code") in (
                "SlowDown",
                "RequestTimeout",
                "InternalError",
                "ServiceUnavailable",
            ):
                return True
    except ImportError:  # pragma: no cover - optional SDK
        pass
    return isinstance(exc, (ConnectionError, TimeoutError))


def is_not_found_error(exc: BaseException) -> bool:
    """Any backend's not-found: the builtin types (``KeyError`` included,
    the missing key of dict-backed stores) and SDK types matched by type
    name (botocore ``NoSuchKey``, google-api ``NotFound``), so none of the
    SDKs need be installed. The commit fence reader classifies through
    here."""
    if isinstance(exc, (FileNotFoundError, KeyError)):
        return True
    names = {t.__name__ for t in type(exc).__mro__}
    return any("NotFound" in n or "NoSuchKey" in n for n in names)


def classify_error(exc: BaseException) -> str:
    """Coarse error kind for telemetry and failure reports: ``throttle``,
    ``server``, ``timeout``, ``connection`` or ``other``, by exception type
    name and embedded status codes (no SDK needed)."""
    names = {t.__name__ for t in type(exc).__mro__}
    if "TooManyRequests" in names:
        return "throttle"
    code = None
    response = getattr(exc, "response", None)
    if isinstance(response, dict):
        code = response.get("ResponseMetadata", {}).get("HTTPStatusCode")
        err = response.get("Error", {}).get("Code")
        if code == 429 or err == "SlowDown":
            return "throttle"
        if err in ("RequestTimeout",):
            return "timeout"
        if err in ("InternalError", "ServiceUnavailable"):
            return "server"
    if code is not None and 500 <= int(code) < 600:
        return "server"
    if any(
        n in names
        for n in ("InternalServerError", "BadGateway", "ServiceUnavailable", "GatewayTimeout")
    ):
        return "server"
    if "DeadlineExceeded" in names:
        return "timeout"
    if any("Timeout" in n for n in names) or isinstance(exc, TimeoutError):
        return "timeout"
    if "ChunkedEncodingError" in names:
        return "connection"
    if any("Connection" in n for n in names) or isinstance(exc, ConnectionError):
        return "connection"
    return "other"


def attach_retry_history(
    exc: BaseException,
    attempts: int,
    kind: str,
    backoff_slept_s: float,
    fleet_attempts: int,
    fleet_backoff_s: float,
) -> BaseException:
    """Record the retry history on the exception about to propagate, as
    attributes and a ``__notes__`` line; the exception keeps its type."""
    exc.retry_attempts = attempts
    exc.retry_error_kind = kind
    exc.retry_backoff_slept_s = round(backoff_slept_s, 3)
    exc.retry_fleet_attempts = fleet_attempts
    exc.retry_fleet_backoff_s = round(fleet_backoff_s, 3)
    note = (
        f"[torchsnapshot_tpu_torch retry] gave up after {attempts} attempt(s) on "
        f"this transfer ({backoff_slept_s:.1f}s backoff slept; error kind: "
        f"{kind}); fleet totals this operation: {fleet_attempts} retry "
        f"attempt(s), {fleet_backoff_s:.1f}s backoff"
    )
    add_note = getattr(exc, "add_note", None)
    if callable(add_note):
        try:
            add_note(note)
        except TypeError:  # pragma: no cover - exotic BaseException subclass
            pass
    return exc


def attach_fallback_history(exc: BaseException, kind: Optional[str] = None) -> str:
    """Degraded-path accounting (mirror failover, peer-read fallback):
    give ``exc`` the attributes a retry exhaustion carries, one attempt and
    no backoff, unless the storage layer already attached real history.
    Returns the classified kind."""
    kind = kind or classify_error(exc)
    if getattr(exc, "retry_attempts", None) is None:
        attach_retry_history(
            exc, attempts=1, kind=kind, backoff_slept_s=0.0, fleet_attempts=0,
            fleet_backoff_s=0.0,
        )
    return kind


class CollectiveRetryStrategy:
    """Shared-deadline retry for a fleet of concurrent transfer coroutines.

    One instance serves every transfer of a snapshot operation. A
    coroutine that completes a unit of work calls :meth:`report_progress`,
    pushing the shared deadline out by ``stall_timeout_s``. One that hits a
    transient error calls :meth:`backoff_or_raise`: while the fleet has
    progressed recently it sleeps (jittered exponential backoff) and the
    caller retries; once nothing anywhere has progressed past the deadline,
    the error is raised, so the fleet fails fast together. Not thread-safe
    by design: every coroutine runs on one event loop."""

    def __init__(
        self,
        stall_timeout_s: float = STALL_TIMEOUT_S,
        base_backoff_s: float = BASE_BACKOFF_S,
        max_backoff_s: float = MAX_BACKOFF_S,
        clock: Callable[[], float] = telemetry.monotonic,
        sleep: Optional[Callable[[float], Any]] = None,
    ) -> None:
        self._stall_timeout_s = stall_timeout_s
        self._base_backoff_s = base_backoff_s
        self._max_backoff_s = max_backoff_s
        self._clock = clock
        self._sleep = sleep or asyncio.sleep
        # Armed at first use: arming here would count the time before the
        # transfers against the stall budget.
        self._deadline: Optional[float] = None
        self.fleet_attempts = 0
        self.fleet_backoff_s = 0.0

    def report_progress(self) -> None:
        self._deadline = self._clock() + self._stall_timeout_s

    def reset(self) -> None:
        """Disarm the deadline for a new transfer fleet (an instance reused
        across snapshots would otherwise carry a lapsed deadline)."""
        self._deadline = None
        self.fleet_attempts = 0
        self.fleet_backoff_s = 0.0

    def backoff_s(self, attempt: int) -> float:
        return backoff_with_jitter(
            attempt, base_s=self._base_backoff_s, cap_s=self._max_backoff_s
        )

    async def backoff_or_raise(
        self,
        exc: BaseException,
        attempt: int,
        op_started_at: Optional[float] = None,
        op: Optional[str] = None,
        backoff_slept_s: float = 0.0,
    ) -> float:
        """Sleep and return the backoff, or raise ``exc`` with its history.
        An attempt that started before the deadline lapsed gets one more
        retry however long it ran (time inside a transfer is no stall).
        ``backoff_slept_s`` is what this coroutine already slept for the
        transfer."""
        kind = classify_error(exc)
        if self._deadline is None:
            self._deadline = self._clock() + self._stall_timeout_s
        elif self._clock() > self._deadline and (
            op_started_at is None or op_started_at > self._deadline
        ):
            logger.error(
                "No transfer progressed for %.0fs; giving up: %s", self._stall_timeout_s, exc
            )
            telemetry.event(
                "storage_retry_exhausted", cat="retry", kind=kind, op=op,
                attempts=attempt + 1, fleet_attempts=self.fleet_attempts,
                fleet_backoff_s=round(self.fleet_backoff_s, 3),
            )
            telemetry.flightrec.record("retry.exhausted", kind=kind, op=op, attempts=attempt + 1)
            raise attach_retry_history(
                exc,
                attempts=attempt + 1,
                kind=kind,
                backoff_slept_s=backoff_slept_s,
                fleet_attempts=self.fleet_attempts,
                fleet_backoff_s=self.fleet_backoff_s,
            )
        backoff = self.backoff_s(attempt)
        self.fleet_attempts += 1
        self.fleet_backoff_s += backoff
        telemetry.counter_add("retry_attempts", 1)
        telemetry.counter_add("retry_backoff_s", backoff)
        telemetry.event(
            "storage_retry", cat="retry", kind=kind, op=op, attempt=attempt,
            backoff_s=round(backoff, 3),
        )
        telemetry.flightrec.record(
            "retry.attempt", kind=kind, op=op, attempt=attempt, backoff_s=round(backoff, 3)
        )
        logger.warning("Transient storage error (%s); retrying in %.1fs", exc, backoff)
        await self._sleep(backoff)
        return backoff


async def ordered_window_chunks(path, spans, fetch, concurrency):
    """Drive ranged fetches through a bounded in-flight window and yield
    the chunks in offset order: ``fetch(lo, hi)`` returns an awaitable of
    the bytes of [lo, hi). The window refills before each yield, a short
    response raises, and a failure cancels the siblings in flight."""
    tasks = {}
    next_to_fire = 0

    def fire() -> None:
        nonlocal next_to_fire
        while next_to_fire < len(spans) and len(tasks) < concurrency:
            tasks[next_to_fire] = fetch(*spans[next_to_fire])
            next_to_fire += 1

    fire()
    try:
        for idx in range(len(spans)):
            chunk = await tasks.pop(idx)
            fire()
            lo, hi = spans[idx]
            if len(chunk) != hi - lo:
                raise IOError(
                    f"short read on {path}: got {len(chunk)} bytes for range [{lo}, {hi})"
                )
            yield chunk
    except BaseException:
        for t in tasks.values():
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks.values(), return_exceptions=True)
        raise


# ---------------------------------------------------------------- executor

CLOUD_IO_THREADS_ENV_VAR = "TORCHSNAPSHOT_GPU_CLOUD_IO_THREADS"
_DEFAULT_CLOUD_IO_THREADS = 16

_executor = None
_executor_lock = threading.Lock()


def cloud_io_executor():
    """The process's bounded thread pool for cloud-storage transfers, sized
    by ``TORCHSNAPSHOT_GPU_CLOUD_IO_THREADS`` (default 16, a bad value
    too), independent of the core count: its threads block in socket I/O
    with the GIL released. Threads are created lazily."""
    global _executor
    with _executor_lock:
        if _executor is None:
            import concurrent.futures

            raw = os.environ.get(CLOUD_IO_THREADS_ENV_VAR, "").strip()
            try:
                workers = int(raw) if raw else _DEFAULT_CLOUD_IO_THREADS
            except ValueError:
                workers = _DEFAULT_CLOUD_IO_THREADS
            _executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, workers), thread_name_prefix="tsnap-gpu-cloud-io"
            )
        return _executor
