"""Preemption-aware emergency checkpointing.

Counterpart of ``torchsnapshot_tpu/preemption.py``. Spot
and preemptible machines receive SIGTERM with a short grace window before
they disappear. :class:`PreemptionWatcher` turns the signal into a
decision the training loop acts on:

- the handler only sets a flag (async-signal-safe); the previous handler
  is chained, so other SIGTERM logic still runs;
- :meth:`PreemptionWatcher.should_save` answers "emergency-save now?",
  true on every rank when any rank of the world was signalled (a
  collective over the store of ``pg_wrapper``).

Typical loop::

    watcher = PreemptionWatcher()
    mgr = CheckpointManager(root, preemption=watcher, ...)
    for step in range(n_steps):
        train_step(state, batch)
        mgr.save(step, app_state)      # saves off-cadence when preempted
        if watcher.consumed:
            break                      # snapshot committed; exit cleanly

With ``preemption=``, :meth:`CheckpointManager.save` consults the watcher
and, on a preemption, saves the current step regardless of cadence,
synchronously, then marks the watcher consumed so the rest of the grace
window does not re-save every step. With the delta journal armed
(``journal.py``, ``TORCHSNAPSHOT_GPU_JOURNAL``) the manager flushes one
fenced journal epoch against the last committed base instead of the full
save. :meth:`PreemptionWatcher.consume` then runs its hooks, such as the
geo-replication shipper's bounded drain.

The signal is recorded in the flight recorder (``preempt.signal``); with
``TORCHSNAPSHOT_GPU_FLIGHTREC_SIGTERM`` on (1, on, true, yes, as in the JAX
package) the ring is dumped to ``TORCHSNAPSHOT_GPU_FLIGHTREC_DIR`` on the
first call after the signal.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Any, Sequence

from .pg_wrapper import PGWrapper
from .telemetry import flightrec

logger = logging.getLogger(__name__)


def _sigterm_dump_enabled() -> bool:
    raw = os.environ.get("TORCHSNAPSHOT_GPU_FLIGHTREC_SIGTERM", "").strip().lower()
    return raw in ("1", "on", "true", "yes")

# Distinguishes "caller passed pg explicitly (even None)" from "caller did
# not pass pg": an explicit pg (CheckpointManager always passes its own,
# None meaning the default group) is authoritative and never falls back to
# the watcher's constructor group.
_UNSET = object()


class PreemptionWatcher:
    """Watches termination signals and answers "should we emergency-save
    now?".

    ``signals`` defaults to SIGTERM (what cloud preemption sends). The
    constructor must run on the main thread (CPython restricts
    ``signal.signal`` to it); previous handlers are chained, and
    :meth:`close` puts them back."""

    def __init__(self, pg: Any = None, signals: Sequence[int] = (signal.SIGTERM,)) -> None:
        self._pg_raw = pg
        self._flagged = threading.Event()
        self._signums: list = []
        self._consumed = False
        self._consume_hooks: list = []
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame) -> None:
        # Async-signal-safe: set flags only. Logging from a handler can hit
        # stream-reentrancy errors mid-write, so the signal is logged from
        # the next should_save()/consume() call. The flight-recorder append
        # is one GIL-atomic deque op (no lock, no I/O); the dump waits for
        # _log_pending.
        flightrec.record("preempt.signal", signum=signum)
        self._signums.append(signum)
        self._flagged.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)
        # SIG_DFL/SIG_IGN/None: nothing to chain; termination is left to
        # the caller's loop, which breaks after the committed save.

    def _log_pending(self) -> None:
        dump_now = bool(self._signums) and _sigterm_dump_enabled()
        while self._signums:
            logger.warning(
                "received signal %d: flagged for emergency checkpoint", self._signums.pop(0)
            )
        if dump_now:
            # The grace window may be too short for the emergency save to
            # reach its own dump on abort: spool the ring now, to
            # TORCHSNAPSHOT_GPU_FLIGHTREC_DIR (no snapshot path yet).
            try:
                rank = PGWrapper(self._pg_raw).get_rank()
            except Exception:  # noqa: BLE001
                rank = 0
            flightrec.dump(None, rank, "sigterm")

    @property
    def preempted(self) -> bool:
        """This process observed a signal."""
        return self._flagged.is_set()

    def should_save(self, pg: Any = _UNSET) -> bool:
        """True when ANY rank observed a signal. Collective over a world of
        several processes: every rank calls it at the same point of its
        loop and gets the same answer, one all-gather a call, so ranks
        never split on a signal that arrives mid-call (preemption.py:150-172
        of the JAX package). ``pg`` overrides the constructor's group, and
        an explicit ``pg`` is authoritative even when it is None (the
        default group): ``CheckpointManager`` passes its own, so the
        decision rides the group of the save that follows."""
        self._log_pending()
        wrapper = PGWrapper(pg if pg is not _UNSET else self._pg_raw)
        if wrapper.get_world_size() == 1:
            return self._flagged.is_set()
        try:
            return any(wrapper.all_gather_object(self._flagged.is_set()))
        finally:
            wrapper.retire()

    def add_consume_hook(self, hook) -> None:
        """Run ``hook()`` inside :meth:`consume`, after the emergency save
        committed. Hooks are exception-isolated."""
        if hook not in self._consume_hooks:
            self._consume_hooks.append(hook)

    def consume(self) -> None:
        """Mark the preemption handled (a snapshot committed): later
        ``CheckpointManager.save`` calls stop re-triggering."""
        self._log_pending()
        self._consumed = True
        for hook in list(self._consume_hooks):
            try:
                hook()
            except Exception:  # noqa: BLE001 - teardown must proceed
                logger.warning("preemption consume hook failed", exc_info=True)

    @property
    def consumed(self) -> bool:
        return self._consumed

    def close(self) -> None:
        """Restore the previous signal handlers (main thread only)."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError):  # pragma: no cover - non-main thread
                pass
        self._prev.clear()


def simulate_preemption_now() -> None:
    """Send this process SIGTERM (drills: exercise a training loop's
    emergency-save path without waiting for a real event)."""
    os.kill(os.getpid(), signal.SIGTERM)
