"""Memory-budgeted asyncio pipelines for write and read requests, and the
I/O governor that sizes them.

Counterpart of ``torchsnapshot_tpu/scheduler.py`` for one process: the
buffered and streamed pipelines (``execute_write_reqs``,
``execute_read_reqs``), ``PendingIOWork``, the memory budget and the
:class:`IOGovernor`, with the JAX package's heuristics and env parsers.
The pipelines record the JAX package's telemetry (spans, counters, the
per-sub-chunk and per-entry latency histograms) and run its progress
reporter (:class:`_ProgressReporter`, cadence
``TORCHSNAPSHOT_GPU_PROGRESS_S``): a log table, ``progress`` flight events
and the heartbeat's byte fields and binding hint, tick by tick. Every
storage write and read runs under ``forensics.storage_op`` (the stall
watchdog's p99 baseline), a tenant's admission scales and paces the I/O
slots, and the governor's closed loop (``TORCHSNAPSHOT_GPU_AUTOTUNE``)
arms its trial when a pipeline begins.

Write pipeline::

    ready_for_staging -> staging -> ready_for_io -> io -> done

Staging (the DtoH copy into pinned memory, serialization, checksum) is
admitted under the per-process host-memory budget, largest entries first,
with a starvation escape that admits one over-budget entry when nothing
else is in flight. ``execute_write_reqs`` returns a :class:`PendingIOWork`
as soon as every entry is staged: that is the consistency point
``async_take`` returns at, while storage writes go on in the background.

Streamed writes (``allow_streaming``, blocking takes only): an entry whose
stager and storage plugin both opt in is one task that stages sub-chunk
N+1 while the plugin writes sub-chunk N, so its wall time is about
max(stage, write) rather than their sum. It is charged the plugin's
declared window (``stream_admission_cost``: two sub-chunks for fs), not
its size. A streamed entry is written when its task ends, so
``async_take``, whose consistency point is the end of staging, never
streams. Streams and buffered writes share one I/O concurrency cap.

Read pipeline: read -> consume, under the same budget. Streamed reads
(``TORCHSNAPSHOT_GPU_STREAM_READS``, default ``auto``): the plugin yields
sub-chunks as it reads them and the consumer verifies the chained CRC32C,
decompresses and copies each while the next is read; the entry is charged
the consumer's declared window. Under ``auto`` a consumer that would hold
the whole payload anyway, or whose streamed consume costs more than its
buffered one on page-cache reads (the CUDA device sink, which the JAX
package streams for its window alone), streams only from storage
measured as latency-bound.

Peer reads (``coop``, a ``fanout.CoopKeyPlan`` or a
``reshard.ComposedRestorePlan``): each request takes a role. An owner
reads from storage and forwards every sub-chunk to its subscribers while
its own consumer takes it; a receiver consumes the owner's frames
(streamed when its consumer can, else buffered) and verifies them itself.
Peer-fed entries dispatch first and take no I/O slot while they wait. Any
peer failure (owner death, abort, timeout, a bad transfer) reads that
entry directly from storage once, under a gate of the I/O concurrency;
when only peer-fed entries hold the budget, the first other entry is
admitted over it, or the world would wait out the coop timeout.

The budget is ``min(0.6 * available memory, 32 GiB)``, or
``TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES`` when set.

I/O governor (:class:`IOGovernor`): the sub-chunk size, the I/O
concurrency, the restore-side preverify gate, the native engine's and the
latency-bound elections follow the env pin, then a learned profile or the
armed trial (``autotune.py``), then rates measured on this process's own
traffic (storage write and read bandwidth per plugin, the device hash
rate of ``device_digest.probe_hash_throughput``), within env bounds.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set

from . import autotune as _autotune
from . import faultinject, rss_profiler, telemetry
from .fanout import count_peer
from .telemetry import flightrec, forensics, health
from .integrity import IntegrityError
from .io_types import (
    ReadIO,
    ReadReq,
    ReadStream,
    StoragePlugin,
    StreamRestartRequired,
    WriteIO,
    WriteReq,
    WriteStream,
)

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            logger.warning("ignoring non-integer %s=%r", name, raw)
    return default


try:
    _CPU_COUNT = len(os.sched_getaffinity(0)) or 1
except (AttributeError, OSError):  # pragma: no cover - non-Linux
    _CPU_COUNT = os.cpu_count() or 1
CPU_CONCURRENCY_ENV_VAR = "TORCHSNAPSHOT_GPU_CPU_CONCURRENCY"
# Read once at import, as the JAX package reads its knob.
_CPU_CONCURRENCY = _env_int(CPU_CONCURRENCY_ENV_VAR, min(4, max(2, _CPU_COUNT // 2)))
_AVAILABLE_MEMORY_MULTIPLIER = 0.6
_MAX_PER_RANK_MEMORY_BUDGET_BYTES = 32 * 1024**3
MEMORY_BUDGET_ENV_VAR = "TORCHSNAPSHOT_GPU_PER_RANK_MEMORY_BUDGET_BYTES"

# ------------------------------------------------------------ I/O governor

IO_CONCURRENCY_ENV_VAR = "TORCHSNAPSHOT_GPU_IO_CONCURRENCY"
SUB_CHUNK_ENV_VAR = "TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES"
SUB_CHUNK_MIN_ENV_VAR = "TORCHSNAPSHOT_GPU_SUB_CHUNK_MIN_BYTES"
SUB_CHUNK_MAX_ENV_VAR = "TORCHSNAPSHOT_GPU_SUB_CHUNK_MAX_BYTES"
PREVERIFY_ENV_VAR = "TORCHSNAPSHOT_GPU_PREVERIFY"
STREAM_READS_ENV_VAR = "TORCHSNAPSHOT_GPU_STREAM_READS"

# Measured read bandwidth below which storage counts as latency-bound:
# streamed reads then pay off even for consumers that hold the whole
# payload, since the overlap hides transport latency. The same 1 GB/s knee
# io_concurrency uses.
_STREAM_READ_LATENCY_BPS = 1e9

_DEFAULT_SUB_CHUNK_BYTES = 64 << 20
_DEFAULT_SUB_CHUNK_MIN_BYTES = 8 << 20
_DEFAULT_SUB_CHUNK_MAX_BYTES = 256 << 20
# A sub-chunk should take this long to write at the measured bandwidth:
# long enough to amortize per-chunk dispatch, short enough that an entry
# keeps several stages in flight.
_SUB_CHUNK_TARGET_SECONDS = 0.05
# Skip the preverify hash pass only when reading is clearly cheaper.
_PREVERIFY_READ_MARGIN = 1.25
# Depose an elected native engine only when its measured rate falls
# clearly below the plugin's rate without it.
_NATIVE_FALLBACK_MARGIN = 0.75
# Dead band around a boolean gate's knee: once made, a decision flips only
# when the rate crosses the knee by this fraction.
_KNEE_MARGIN = 0.10
# Cap of a learned I/O concurrency: the climb stays inside the range the
# pipeline was built for (an env pin may exceed it).
_IO_CONCURRENCY_CAP = 32

# The autotune mode's parser lives with the controller (autotune.py).
AUTOTUNE_ENV_VAR = _autotune.AUTOTUNE_ENV_VAR
autotune_mode = _autotune.autotune_mode


def stream_reads_mode() -> str:
    """The parser for ``TORCHSNAPSHOT_GPU_STREAM_READS``: ``never``
    disables streamed reads, ``always`` streams every eligible entry, and
    the default ``auto`` streams an entry when that buys something: a
    smaller budget charge than the buffered consume (device-bound and
    coalesced-slab consumers), or storage measured as latency-bound."""
    raw = os.environ.get(STREAM_READS_ENV_VAR, "auto").strip().lower()
    if raw in ("0", "false", "off", "no", "never"):
        return "never"
    if raw in ("always", "force"):
        return "always"
    return "auto"


def preverify_mode() -> str:
    """The parser for ``TORCHSNAPSHOT_GPU_PREVERIFY``: ``always``,
    ``never`` or (anything else) ``auto``."""
    raw = os.environ.get(PREVERIFY_ENV_VAR, "auto").strip().lower()
    if raw in ("1", "always", "on", "true", "yes"):
        return "always"
    if raw in ("0", "never", "off", "false", "no"):
        return "never"
    return "auto"


class IOGovernor:
    """Process-wide tuner of the save/restore path.

    Records achieved rates (storage write and read bandwidth per plugin,
    from the scheduler's own meters and the fs plugin's native engine, and
    the device hash rate of ``probe_hash_throughput``), exponentially
    smoothed (alpha 0.5), and derives from them, within env bounds:

    - ``sub_chunk_bytes``: the streaming sub-chunk size, sized so a
      sub-chunk takes about ``_SUB_CHUNK_TARGET_SECONDS`` at the measured
      bandwidth of the same direction; pinned by
      ``TORCHSNAPSHOT_GPU_SUB_CHUNK_BYTES``.
    - ``io_concurrency``: in-flight storage requests; fewer on
      bandwidth-bound storage, more on latency-bound storage; pinned by
      ``TORCHSNAPSHOT_GPU_IO_CONCURRENCY``.
    - ``should_preverify``: whether a restore fingerprints destinations to
      skip reads, or just reads (hashing wins on slow storage);
      ``TORCHSNAPSHOT_GPU_PREVERIFY`` forces ``always``/``never``.
    - ``should_native_io``: the native engine's election under
      ``TORCHSNAPSHOT_GPU_NATIVE_IO=auto``.
    - ``should_coop_restore`` / ``should_planned_reshard`` /
      ``should_seed_restore``: the latency-bound elections under ``auto``.

    The closed loop (``TORCHSNAPSHOT_GPU_AUTOTUNE``, default ``auto``;
    scheduler.py:215-800 of the JAX package): every site resolves the env
    pin, then a learned profile or the armed trial
    (:class:`autotune.AutoTuner`), then the measured-rate heuristic,
    through one :class:`autotune.Election` record, and records a
    ``governor.elect`` event when its decision changes. ``begin_io_op``
    arms at most one perturbation an op, ``observe_verdict`` scores the
    op's merged critical-path verdict after the commit and persists the
    profile into the root's history journal, and ``load_profiles``
    warm-starts a fresh process from it.
    """

    _EWMA_ALPHA = 0.5

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._write_bps: Dict[str, float] = {}
        self._read_bps: Dict[str, float] = {}
        self._hash_bps: Optional[float] = None
        self._gate_state: Dict[Any, bool] = {}
        self._tuner = _autotune.AutoTuner()
        # The last Election per (dim, plugin): a flight event is recorded
        # only when it changes (io_concurrency is asked inside dispatch
        # loops).
        self._elections: Dict[Any, _autotune.Election] = {}
        self._profile_roots: Set[str] = set()

    # ------------------------------------------------------- recording

    def _ewma(self, table: Dict[str, float], key: str, bps: float) -> None:
        with self._lock:
            prev = table.get(key)
            table[key] = bps if prev is None else prev + self._EWMA_ALPHA * (bps - prev)

    def record_write(self, plugin: str, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 1e-6:
            return
        self._ewma(self._write_bps, plugin, nbytes / seconds)

    def record_read(self, plugin: str, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 1e-6:
            return
        self._ewma(self._read_bps, plugin, nbytes / seconds)

    def record_hash(self, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 1e-6:
            return
        bps = nbytes / seconds
        with self._lock:
            prev = self._hash_bps
            self._hash_bps = bps if prev is None else prev + self._EWMA_ALPHA * (bps - prev)

    # -------------------------------------------------- measured rates

    def write_bps(self, plugin: Optional[str] = None) -> Optional[float]:
        with self._lock:
            if plugin is not None:
                return self._write_bps.get(plugin)
            return max(self._write_bps.values()) if self._write_bps else None

    def read_bps(self, plugin: Optional[str] = None) -> Optional[float]:
        with self._lock:
            if plugin is not None:
                return self._read_bps.get(plugin)
            return max(self._read_bps.values()) if self._read_bps else None

    def hash_bps(self) -> Optional[float]:
        with self._lock:
            return self._hash_bps

    def measured_rates(self) -> Dict[str, object]:
        with self._lock:
            return {
                "write_bps": dict(self._write_bps),
                "read_bps": dict(self._read_bps),
                "hash_bps": self._hash_bps,
            }

    @property
    def elections(self) -> Dict[Any, Any]:
        """The last ``(value, source)`` each site chose, by (dimension,
        plugin)."""
        with self._lock:
            return {k: (e.value, e.source) for k, e in self._elections.items()}

    # ------------------------------------------------ election plumbing

    def _resolved(self, site: str, dim: str, plugin: Optional[str], value: Any, source: str,
                  **inputs: Any) -> Any:
        """Every site's decision goes through here: one Election per
        (dim, plugin), a ``governor.elect`` event when the value or the
        source changes, and the profile key when a learned profile or
        trial decided."""
        profile = None
        if source in ("profile", "trial"):
            op = dim.rsplit(".", 1)[1] if "." in dim else "read"
            profile = self._tuner.key_for(plugin or "", op)
        election = _autotune.Election(site, dim, plugin, value, source, profile=profile,
                                      inputs=inputs)
        key = (dim, plugin or "")
        with self._lock:
            prev = self._elections.get(key)
            changed = prev is None or prev.value != value or prev.source != source
            self._elections[key] = election
        if changed:
            telemetry.record_election(**election.as_fields())
        return value

    def _banded(self, gate: str, plugin: Optional[str], rate: float, knee: float) -> bool:
        """``rate < knee`` with a dead band: once a decision is made, the
        rate must cross the knee by ``_KNEE_MARGIN`` to flip it."""
        key = (gate, plugin or "")
        with self._lock:
            prev = self._gate_state.get(key)
            if prev is None:
                decision = rate < knee
            elif prev:
                decision = rate < knee * (1.0 + _KNEE_MARGIN)
            else:
                decision = rate < knee * (1.0 - _KNEE_MARGIN)
            self._gate_state[key] = decision
        return decision

    def _tuned(self, dim: str, plugin: Optional[str], op: str):
        """The learned profile's or armed trial's ``(value, source)`` for
        one dimension, or None (cold start, or autotuning off)."""
        if _autotune.autotune_mode() == "never":
            return None
        return self._tuner.resolve(dim, plugin or "", op)

    # --------------------------------------------------------- tunables

    def sub_chunk_bytes(self, plugin: Optional[str] = None, op: str = "write") -> int:
        """The streaming sub-chunk size for ``op`` ("write"/"read"): the
        env pin, else the learned value, else sized from the measured
        bandwidth of the same direction, within the MIN/MAX env bounds, in
        whole MiB."""
        dim = f"sub_chunk.{op}"
        pinned = os.environ.get(SUB_CHUNK_ENV_VAR, "").strip()
        if pinned:
            try:
                # Honoured as is: tests pin tiny chunks to stream small
                # payloads in many pieces.
                value = max(1, int(pinned))
            except ValueError:
                logger.warning("ignoring non-integer %s=%r", SUB_CHUNK_ENV_VAR, pinned)
            else:
                return self._resolved("sub_chunk", dim, plugin, value, "env")
        lo = _env_int(SUB_CHUNK_MIN_ENV_VAR, _DEFAULT_SUB_CHUNK_MIN_BYTES)
        hi = max(lo, _env_int(SUB_CHUNK_MAX_ENV_VAR, _DEFAULT_SUB_CHUNK_MAX_BYTES))
        tuned = self._tuned(dim, plugin, op)
        if tuned is not None:
            value, source = tuned
            try:
                value = int(value)
            except (TypeError, ValueError):
                value = _DEFAULT_SUB_CHUNK_BYTES
            # A profile learned under other bounds is clamped into today's.
            return self._resolved("sub_chunk", dim, plugin, min(max(value, lo), hi), source)
        bps = self.read_bps(plugin) if op == "read" else self.write_bps(plugin)
        if bps is None:
            return self._resolved("sub_chunk", dim, plugin,
                                  min(max(_DEFAULT_SUB_CHUNK_BYTES, lo), hi), "heuristic")
        # Whole MiB: the staging pool's exact-size free lists recycle far
        # better when sizes do not wander byte by byte.
        target = max(1 << 20, (int(bps * _SUB_CHUNK_TARGET_SECONDS) >> 20) << 20)
        return self._resolved("sub_chunk", dim, plugin, min(max(target, lo), hi), "heuristic",
                              bps=round(bps))

    def io_concurrency(self, op: str = "write", plugin: Optional[str] = None) -> int:
        """In-flight storage requests for ``op``: the env pin, else the
        learned value (at most ``_IO_CONCURRENCY_CAP``), else from the
        measured rate of the same direction (this plugin's, else the best
        known): 2 a core (4-16) on bandwidth-bound storage (>= 1 GB/s), 16
        on latency-bound storage (<= 100 MB/s), else
        ``min(16, max(8, 2 * cores))``."""
        dim = f"io_concurrency.{op}"
        raw = os.environ.get(IO_CONCURRENCY_ENV_VAR, "").strip()
        if raw:
            try:
                return self._resolved("io_concurrency", dim, plugin, max(1, int(raw)), "env")
            except ValueError:
                logger.warning("ignoring non-integer %s=%r", IO_CONCURRENCY_ENV_VAR, raw)
        tuned = self._tuned(dim, plugin, op)
        if tuned is not None:
            value, source = tuned
            try:
                value = int(value)
            except (TypeError, ValueError):
                value = 0
            if value >= 1:
                return self._resolved("io_concurrency", dim, plugin,
                                      min(value, _IO_CONCURRENCY_CAP), source)
        default = min(16, max(8, 2 * _CPU_COUNT))
        table = self.read_bps if op == "read" else self.write_bps
        bps = table(plugin)
        if bps is None and plugin is not None:
            bps = table(None)
        if bps is None:
            value = default
        elif bps >= 1e9:
            value = min(default, max(4, 2 * _CPU_COUNT))
        elif bps <= 1e8:
            value = 16
        else:
            value = default
        return self._resolved("io_concurrency", dim, plugin, value, "heuristic",
                              bps=round(bps) if bps is not None else None)

    def should_preverify(self, plugin: Optional[str] = None) -> bool:
        """Whether a restore from ``plugin`` fingerprints its destinations
        (to skip the reads of those that already hold the content) rather
        than just reading: the env mode, else the learned value, else True
        unless this plugin's measured read rate beats the measured hash
        rate by ``_PREVERIFY_READ_MARGIN`` (no measurement: verify)."""
        mode = preverify_mode()
        if mode != "auto":
            return self._resolved("preverify", "preverify", plugin, mode == "always", "env")
        tuned = self._tuned("preverify", plugin, "read")
        if tuned is not None:
            value, source = tuned
            return self._resolved("preverify", "preverify", plugin, bool(value), source)
        hash_bps = self.hash_bps()
        read_bps = self.read_bps(plugin) if plugin is not None else self.read_bps()
        if hash_bps is None or read_bps is None:
            return self._resolved("preverify", "preverify", plugin, True, "heuristic")
        value = self._banded("preverify", plugin, read_bps, hash_bps * _PREVERIFY_READ_MARGIN)
        return self._resolved("preverify", "preverify", plugin, value, "heuristic",
                              read_bps=round(read_bps), hash_bps=round(hash_bps))

    def should_native_io(self, plugin: Optional[str] = None, op: str = "write") -> bool:
        """The native engine's election under ``NATIVE_IO=auto`` (a
        learned value first). The fs plugin records the engine's rate
        under ``<Plugin>.native``.

        - writes: elected while unmeasured, deposed only when its rate
          falls below ``_NATIVE_FALLBACK_MARGIN`` of the plugin's rate;
        - reads: only on storage measured as latency-bound (below 1
          GB/s), where queue depth hides latency; on page-cache reads the
          engine loses to the mmap and pread paths."""
        dim = f"native.{op}"
        tuned = self._tuned(dim, plugin, op)
        if tuned is not None:
            value, source = tuned
            return self._resolved("native", dim, plugin, bool(value), source)
        table = self._read_bps if op == "read" else self._write_bps
        with self._lock:
            native = table.get(f"{plugin}.native") if plugin else None
            base = table.get(plugin) if plugin else None
        if op == "read":
            if base is None or not self._banded(dim, plugin, base, _STREAM_READ_LATENCY_BPS):
                return self._resolved("native", dim, plugin, False, "heuristic")
            value = native is None or native >= _NATIVE_FALLBACK_MARGIN * base
            return self._resolved("native", dim, plugin, value, "heuristic")
        if native is None or base is None:
            return self._resolved("native", dim, plugin, True, "heuristic")
        return self._resolved("native", dim, plugin, native >= _NATIVE_FALLBACK_MARGIN * base,
                              "heuristic", native_bps=round(native), base_bps=round(base))

    def should_coop_restore(self, plugin: Optional[str] = None) -> bool:
        """Cooperative fan-out's election (``fanout.py``, under
        ``TORCHSNAPSHOT_GPU_COOP_RESTORE=auto``): partitioned reads and
        peer redistribution win about N-fold where storage bandwidth is the
        bottleneck, but on page-cache reads the socket copy costs more than
        a re-read. No recorded read rate is no evidence: direct reads."""
        return self._knee_gate("coop_restore", plugin)

    def should_planned_reshard(self, plugin: Optional[str] = None) -> bool:
        """The planned reshard's election (``reshard.py``, under
        ``TORCHSNAPSHOT_GPU_RESHARD=auto``): one storage read and minimal
        peer bundles in place of R reads win where storage, not the host
        network, is the bottleneck; the same knee as fan-out."""
        return self._knee_gate("planned_reshard", plugin)

    def should_seed_restore(self, plugin: Optional[str] = None) -> bool:
        """The fleet seeding tier's election (``distrib.py``, under
        ``TORCHSNAPSHOT_GPU_SEED_RESTORE=auto``): chunks from peers that
        already hold them beat a direct read where storage, not the host
        network, is the bottleneck; the same knee as fan-out. The election
        is per replica (every seed miss falls back to a direct read), so
        decisions may differ across the fleet safely."""
        return self._knee_gate("seed_restore", plugin)

    def _knee_gate(self, gate: str, plugin: Optional[str]) -> bool:
        """The shared latency-bound election: the learned value, else the
        measured read rate below the 1 GB/s knee, with the dead band."""
        tuned = self._tuned(gate, plugin, "read")
        if tuned is not None:
            value, source = tuned
            return self._resolved(gate, gate, plugin, bool(value), source)
        bps = self.read_bps(plugin) if plugin is not None else self.read_bps()
        value = bps is not None and self._banded(gate, plugin, bps, _STREAM_READ_LATENCY_BPS)
        return self._resolved(gate, gate, plugin, value, "heuristic",
                              read_bps=round(bps) if bps is not None else None)

    # --------------------------------------------------- the closed loop

    def note_world(self, world_size: int) -> None:
        self._tuner.note_world(world_size)

    def _trial_dims(self, op: str, plugin: str) -> Dict[str, Dict[str, Any]]:
        """The dimensions this direction may perturb, with their incumbent
        values and env bounds. An env-pinned knob is never perturbed, and
        the engine choice joins only once the native engine has a measured
        rate for this plugin."""
        dims: Dict[str, Dict[str, Any]] = {}
        if not os.environ.get(SUB_CHUNK_ENV_VAR, "").strip():
            lo = _env_int(SUB_CHUNK_MIN_ENV_VAR, _DEFAULT_SUB_CHUNK_MIN_BYTES)
            hi = max(lo, _env_int(SUB_CHUNK_MAX_ENV_VAR, _DEFAULT_SUB_CHUNK_MAX_BYTES))
            dims[f"sub_chunk.{op}"] = {"value": self.sub_chunk_bytes(plugin, op=op),
                                       "kind": "geom", "lo": lo, "hi": hi, "quantum": 1 << 20}
        if not os.environ.get(IO_CONCURRENCY_ENV_VAR, "").strip():
            dims[f"io_concurrency.{op}"] = {"value": self.io_concurrency(op, plugin),
                                            "kind": "geom", "lo": 1, "hi": _IO_CONCURRENCY_CAP,
                                            "quantum": 1}
        with self._lock:
            table = self._read_bps if op == "read" else self._write_bps
            has_native = f"{plugin}.native" in table
        if has_native:
            dims[f"native.{op}"] = {"value": self.should_native_io(plugin, op=op),
                                    "kind": "toggle"}
        return dims

    def begin_io_op(self, op: str, plugin: str) -> None:
        """The pipelines' entry hook: under ``auto``/``fresh`` with a
        scored incumbent, arm at most one perturbation before the op's
        elections, and publish the profile key (and the trial's dimension)
        to the heartbeat. ``never`` costs one env check."""
        mode = _autotune.autotune_mode()
        if mode == "never":
            return
        key = self._tuner.key_for(plugin, op)
        if mode in ("auto", "fresh") and key is not None:
            self._tuner.maybe_arm(op, plugin, self._trial_dims(op, plugin))
        active = self._tuner.active_trial()
        trial_dim = (active["dim"] if active is not None and active["op"] == op
                     and active["plugin"] == plugin else None)
        health.update(profile=key or "-", trial=trial_dim)

    def observe_verdict(self, op: str, plugin: str, world_size: int,
                        attribution: Optional[Dict[str, Any]],
                        aggregate: Optional[Dict[str, Any]] = None,
                        root: Optional[str] = None, rank: int = 0) -> None:
        """Score one committed op's merged critical-path verdict against
        the incumbent profile, on every rank (the merged attribution is
        the same on all); rank 0 also appends the profile record to
        ``root``'s history journal. The score is the op's end-to-end rate
        (bytes over the wall) from the fleet aggregate, else the binding
        window's rate; an unattributed op (bus off) is skipped, and trials
        arm only after storage-bound verdicts."""
        mode = _autotune.autotune_mode()
        if mode == "never":
            return
        op_kind = "read" if op == "restore" else "write"
        self._tuner.note_world(world_size)
        binding = (attribution or {}).get("binding") or {}
        category = binding.get("category")
        gbps = (aggregate or {}).get("read_gbps" if op_kind == "read" else "write_gbps")
        if not isinstance(gbps, (int, float)) or gbps <= 0:
            gbps = binding.get("gbps")
        if (not isinstance(category, str) or not category
                or not isinstance(gbps, (int, float)) or gbps <= 0):
            telemetry.counter_add("profile_skips", 1)
            aborted = self._tuner.abort_trial(op_kind, plugin)
            telemetry.record_learn(op=op, plugin=plugin, skipped=True, trial_aborted=aborted)
            return
        storage_bound = telemetry.critpath.classify_category(category) == "storage"
        result = self._tuner.observe(op_kind, plugin, category, float(gbps),
                                     learn=(mode != "pin"), arm=storage_bound)
        telemetry.record_learn(op=op, **{k: v for k, v in result.items()
                                         if k not in ("settings", "op")})
        if root is not None and rank == 0 and mode != "pin":
            record = self._tuner.profile_record(result["key"])
            if record is not None:
                record["op"] = op_kind
                telemetry.history.append_record(root, record)

    def load_profiles(self, root: str) -> int:
        """Adopt the last persisted profile per key from ``root``'s history
        journal, once per root per governor; ``fresh`` and ``never`` skip.
        Returns the number adopted."""
        mode = _autotune.autotune_mode()
        if mode in ("never", "fresh") or not root:
            return 0
        with self._lock:
            if root in self._profile_roots:
                return 0
            self._profile_roots.add(root)
        try:
            records = telemetry.history.load_profiles(root)
        except Exception:  # noqa: BLE001 - profiles are advisory
            logger.debug("profile load skipped", exc_info=True)
            return 0
        loaded = self._tuner.load(records)
        if loaded:
            logger.debug("autotune: warm-started %d profile(s) from %s", loaded, root)
        return loaded

    def profiles(self) -> Dict[str, Dict[str, Any]]:
        """Live convergence state per profile key."""
        return self._tuner.profiles()


_governor: Optional[IOGovernor] = None
_governor_lock = threading.Lock()


def io_governor() -> IOGovernor:
    global _governor
    if _governor is None:
        with _governor_lock:
            if _governor is None:
                _governor = IOGovernor()
    return _governor


def reset_io_governor() -> IOGovernor:
    """Replace the process governor with a fresh one (tests, benchmarks)."""
    global _governor
    with _governor_lock:
        _governor = IOGovernor()
        return _governor


def preload_profiles(path: str, world_size: Optional[int] = None) -> None:
    """Load the learned profiles of ``path``'s root (the snapshot's
    parent directory, where the history journal lives) into the process
    governor before the op's first election (scheduler.py:838-858 of the
    JAX package). One env check when autotuning is off; a path with no
    local root loads nothing; never raises into the op."""
    if _autotune.autotune_mode() == "never":
        return
    governor = io_governor()
    if world_size:
        governor.note_world(world_size)
    try:
        from .storage_plugin import local_fs_root

        local = local_fs_root(path)
        if local is None:
            return
        governor.load_profiles(os.path.dirname(os.path.abspath(local.rstrip("/"))))
    except Exception:  # noqa: BLE001 - profiles are advisory
        logger.debug("profile preload skipped", exc_info=True)


def _feed_governor_rates(kind: str, key: Optional[str], nbytes: int, seconds: float) -> None:
    """The one entry for measured rates: ``kind`` is "write", "read" or
    "hash"; ``key`` the plugin (or ``<Plugin>.native``). The JAX package
    feeds its governor through the bus's rate listeners; here the governor
    is fed directly (it decides the same with the bus on or off), and
    the bus records the ``rate:`` event (``telemetry.record_rate``, with
    no listener registered)."""
    telemetry.record_rate(kind, key, nbytes, seconds)
    governor = io_governor()
    if kind == "write":
        governor.record_write(key or "", nbytes, seconds)
    elif kind == "read":
        governor.record_read(key or "", nbytes, seconds)
    elif kind == "hash":
        governor.record_hash(nbytes, seconds)


# What the pipelines streamed in this process: "entries_streamed" (writes),
# "entries_stream_read", "stream_read_restarts". The telemetry counters of
# the same names count only with the bus on; this tally counts always
# (tests and chip_smoke.py read it).
stream_counts: "Counter[str]" = Counter()


def _count_stream(name: str) -> None:
    stream_counts[name] += 1
    telemetry.counter_add(name, 1)


def _available_memory_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def get_local_world_size(pg=None) -> int:
    """The processes of ``pg`` (a ``PGWrapper``) on this host: as
    ``pg_wrapper.init_process_group`` counted them, else by a hostname
    all-gather (scheduler.py:881-887 of the JAX package)."""
    if pg is None or pg.get_world_size() == 1:
        return 1
    known = getattr(getattr(pg, "pg", None), "local_world_size", None)
    if known is not None:
        return known
    hostname = socket.gethostname()
    return max(1, pg.all_gather_object(hostname).count(hostname))


def get_process_memory_budget_bytes(pg=None) -> int:
    """This process's host memory budget: the env override, else its
    share of the available memory among the processes of ``pg`` on this
    host (see :func:`get_local_world_size`)."""
    env = os.environ.get(MEMORY_BUDGET_ENV_VAR)
    if env is not None:
        return int(env)
    return min(
        int(_available_memory_bytes() * _AVAILABLE_MEMORY_MULTIPLIER) // get_local_world_size(pg),
        _MAX_PER_RANK_MEMORY_BUDGET_BYTES,
    )


class _MemoryBudget:
    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = budget_bytes
        self.available = budget_bytes

    def acquire(self, nbytes: int) -> None:
        self.available -= nbytes

    def release(self, nbytes: int) -> None:
        self.available += nbytes


class _Throughput:
    """Bytes moved and wall time since construction, for the rate fed to
    the governor and the MB/s log line (scheduler.py:1209-1234 of the
    JAX package)."""

    def __init__(self, op: str = "", rank: int = 0) -> None:
        self.op = op
        self.rank = rank
        self.begin = telemetry.monotonic()
        self.total_bytes = 0

    def add(self, nbytes: int) -> None:
        self.total_bytes += nbytes

    def elapsed(self) -> float:
        return max(telemetry.monotonic() - self.begin, 1e-9)

    def log_summary(self) -> None:
        elapsed = self.elapsed()
        logger.info("[rank %d] %s %.1f MB in %.2fs (%.1f MB/s)", self.rank, self.op,
                    self.total_bytes / 1e6, elapsed, self.total_bytes / 1e6 / elapsed)


PROGRESS_ENV_VAR = "TORCHSNAPSHOT_GPU_PROGRESS_S"


def progress_interval_s() -> float:
    """``TORCHSNAPSHOT_GPU_PROGRESS_S``: the reporter's cadence in seconds,
    5.0 when unset or when it does not parse (scheduler.py:1072-1080 of
    the JAX package)."""
    raw = os.environ.get(PROGRESS_ENV_VAR, "").strip()
    try:
        return float(raw) if raw else 5.0
    except ValueError:
        return 5.0


def _rss_bytes() -> int:
    """The resident size for the progress log, 0 when it cannot be read."""
    try:
        return rss_profiler.rss_bytes()
    except OSError:
        return 0


class _ProgressReporter:
    """Periodic pipeline progress (scheduler.py:1048-1206 of the JAX
    package): request counts, bytes staged and written (or consumed),
    the budget left and the RSS delta. An asyncio task on the pipeline's
    loop; each tick (every ``interval_s``) logs the table at INFO,
    records a ``progress`` flight event and feeds the heartbeat's fields.
    The read pipeline has no staging phase, so its staging columns are
    absent."""

    def __init__(self, op: str, rank: int, total: int, budget: "_MemoryBudget",
                 interval_s: Optional[float] = None) -> None:
        self.op = op
        self.rank = rank
        self.total = total
        # Payload bytes of this pipeline when known (the heartbeat's ETA).
        self.total_bytes = 0
        self.budget = budget
        self.interval_s = progress_interval_s() if interval_s is None else interval_s
        self.staged_count = 0
        self.staged_bytes = 0
        # "written" entries for writes, "consumed" reads for reads.
        self.completed_count = 0
        self.completed_bytes = 0
        self.inflight_staging = 0
        self.inflight_io = 0
        self._begin = telemetry.monotonic()
        self._rss_begin = _rss_bytes()
        self._task: Optional[asyncio.Task] = None
        # The bus event id the live binding hint has read up to.
        self._binding_since_id = 0

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.interval_s)
                self.log_table()
        except asyncio.CancelledError:
            pass

    def log_table(self) -> None:
        elapsed = telemetry.monotonic() - self._begin
        telemetry.gauge_set(f"{self.op}_inflight_staging", self.inflight_staging)
        telemetry.gauge_set(f"{self.op}_inflight_io", self.inflight_io)
        telemetry.gauge_set("budget_free_bytes", self.budget.available)
        is_read = self.op == "read"
        done_word = "consumed" if is_read else "written"
        cols = [f"{self.total} total"]
        if not is_read:
            cols += [f"{self.inflight_staging} staging", f"{self.staged_count} staged"]
        cols.append(f"{self.inflight_io} in {'flight' if is_read else 'io'}")
        cols.append(f"{self.completed_count} {done_word}")
        vols = [] if is_read else [f"{self.staged_bytes / 1e9:.2f} GB staged"]
        vols.append(f"{self.completed_bytes / 1e9:.2f} GB {done_word}")
        logger.info(
            "[rank %d] %s progress +%.0fs | reqs: %s | %s | budget free %.2f/%.2f GB | "
            "rss delta %+.2f GB", self.rank, self.op, elapsed, ", ".join(cols), ", ".join(vols),
            self.budget.available / 1e9, self.budget.budget_bytes / 1e9,
            (_rss_bytes() - self._rss_begin) / 1e9,
        )
        flightrec.record(
            "progress", op=self.op, total=self.total, done=self.completed_count,
            done_bytes=self.completed_bytes, staged_bytes=self.staged_bytes,
            inflight_staging=self.inflight_staging, inflight_io=self.inflight_io,
        )
        fields: Dict[str, Any] = {"total_entries": self.total,
                                  "done_entries": self.completed_count,
                                  "inflight_io": self.inflight_io}
        if self.total_bytes:
            fields["total_bytes"] = self.total_bytes
        if is_read:
            fields["read_bytes"] = self.completed_bytes
        else:
            fields["staged_bytes"] = self.staged_bytes
            fields["written_bytes"] = self.completed_bytes
        binding = self._live_binding(is_read)
        if binding is not None:
            fields["binding"] = binding
        health.update(**fields)

    def _live_binding(self, is_read: bool) -> Optional[str]:
        """What this rank is bound on, for the heartbeat: with the bus on,
        ``critpath.live_binding`` over the spans since the last tick; else
        (or with no span yet) the queues' shape."""
        if telemetry.enabled():
            evs = telemetry.events(since_id=self._binding_since_id)
            if evs:
                self._binding_since_id = max(e.get("id", 0) for e in evs)
                binding = telemetry.critpath.live_binding(evs)
                if binding is not None:
                    return binding
        if self.inflight_io > 0 and self.inflight_staging == 0:
            return "storage_read" if is_read else "storage_write"
        if self.inflight_staging > 0 and self.inflight_io == 0:
            return "stage_copy" if not is_read else None
        return None


class _WritePipeline:
    def __init__(
        self,
        write_req: WriteReq,
        sub_chunk_bytes: Optional[int] = None,
        storage: Optional[StoragePlugin] = None,
    ) -> None:
        self.write_req = write_req
        self.staging_cost_bytes = write_req.buffer_stager.get_staging_cost_bytes()
        self.buf = None
        self.buf_size_bytes = 0
        # The streaming election: the stager opts in for this sub-chunk
        # size, and the budget then charges the plugin's declared window.
        self.sub_chunk_bytes = sub_chunk_bytes
        self.streamed = sub_chunk_bytes is not None and write_req.buffer_stager.can_stream(
            sub_chunk_bytes
        )
        if self.streamed:
            self.admission_cost_bytes = min(
                self.staging_cost_bytes,
                storage.stream_admission_cost(self.staging_cost_bytes, sub_chunk_bytes),
            )
        else:
            self.admission_cost_bytes = self.staging_cost_bytes

    async def stage_buffer(self, executor) -> "_WritePipeline":
        faultinject.site("scheduler.stage")
        with telemetry.span("stage", path=self.write_req.path, bytes=self.staging_cost_bytes):
            self.buf = await self.write_req.buffer_stager.stage_buffer(executor)
            self.buf_size_bytes = memoryview(self.buf).nbytes
        if self.write_req.buffer_stager.io_skipped:
            telemetry.counter_add("bytes_deduped", self.staging_cost_bytes)
        else:
            telemetry.counter_add("bytes_staged", self.buf_size_bytes)
        return self

    @staticmethod
    async def _timed_write_chunks(chunks, plugin_key: str):
        """The streamed write's per-sub-chunk latency (scheduler.py:959-985
        of the JAX package): the time from asking for a sub-chunk to
        handing it to the plugin is one pipeline step, whose p99 shows the
        stalls an average hides. Installed while the bus is on."""
        try:
            while True:
                t0 = telemetry.monotonic()
                try:
                    chunk = await chunks.__anext__()
                except StopAsyncIteration:
                    return
                telemetry.histogram_observe("write.sub_chunk_s", telemetry.monotonic() - t0,
                                            key=plugin_key)
                yield chunk
        finally:
            await chunks.aclose()

    async def stream_write(self, storage: StoragePlugin, executor) -> "_WritePipeline":
        """Staging and the storage write in one task: the stager yields
        sub-chunks as they land on the host and the plugin writes each
        while the next stages. When it returns the entry is written."""
        faultinject.site("scheduler.stage")
        chunks = self.write_req.buffer_stager.stage_stream(executor, self.sub_chunk_bytes)
        if telemetry.enabled():
            chunks = self._timed_write_chunks(chunks, type(storage).__name__)
        try:
            # The forensics guard is per entry, not per sub-chunk: one
            # registry insert and remove a storage op feeds the
            # watchdog's own p99 baseline.
            with forensics.storage_op("storage_write", path=self.write_req.path), \
                    telemetry.span("stream_write", path=self.write_req.path,
                                   bytes=self.staging_cost_bytes,
                                   sub_chunk_bytes=self.sub_chunk_bytes):
                await storage.write_stream(WriteStream(
                    path=self.write_req.path, nbytes=self.staging_cost_bytes, chunks=chunks))
        finally:
            # Unwinds the stager's generator (its staging slabs and side
            # stream copies) when the plugin stopped early.
            await chunks.aclose()
        self.buf_size_bytes = self.staging_cost_bytes
        telemetry.counter_add("bytes_staged", self.staging_cost_bytes)
        _count_stream("entries_streamed")
        return self

    async def write_buffer(self, storage: StoragePlugin) -> "_WritePipeline":
        # A payload an incremental base already holds is not written.
        if not self.write_req.buffer_stager.io_skipped:
            t0 = telemetry.monotonic() if telemetry.enabled() else None
            with forensics.storage_op("storage_write", path=self.write_req.path), \
                    telemetry.span("storage_write", path=self.write_req.path,
                                   bytes=self.buf_size_bytes):
                await storage.write(WriteIO(path=self.write_req.path, buf=self.buf))
            if t0 is not None:
                telemetry.histogram_observe("write.entry_s", telemetry.monotonic() - t0,
                                            key=type(storage).__name__)
        self.buf = None  # release the staged buffer eagerly
        return self


async def _cancel_all(tasks: Set[asyncio.Task]) -> None:
    for task in tasks:
        task.cancel()
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)


class PendingIOWork:
    """Storage writes still in flight after staging completed."""

    def __init__(
        self,
        ready_for_io: List[_WritePipeline],
        io_tasks: Set[asyncio.Task],
        storage: StoragePlugin,
        budget: _MemoryBudget,
        executor: ThreadPoolExecutor,
        throughput: _Throughput,
        reporter: Optional[_ProgressReporter] = None,
    ) -> None:
        self._reporter = reporter
        self._ready_for_io = ready_for_io
        self._io_tasks = io_tasks
        self._storage = storage
        self._budget = budget
        self._executor = executor
        self._throughput = throughput

    def _dispatch_io(self) -> None:
        loop = asyncio.get_running_loop()
        cap = io_governor().io_concurrency("write", type(self._storage).__name__)
        while self._ready_for_io and len(self._io_tasks) < cap:
            pipeline = self._ready_for_io.pop(0)
            self._io_tasks.add(loop.create_task(pipeline.write_buffer(self._storage)))
            if self._reporter is not None:
                self._reporter.inflight_io += 1

    async def complete(self) -> None:
        reporter = self._reporter
        if reporter is not None:
            # The reporter's task lives on the loop that drains the writes
            # (async_take's commit thread runs another loop).
            reporter.start()
        try:
            with telemetry.span("io_drain"):
                while self._io_tasks or self._ready_for_io:
                    self._dispatch_io()
                    done, self._io_tasks = await asyncio.wait(
                        self._io_tasks, return_when=asyncio.FIRST_COMPLETED
                    )
                    for task in done:
                        nbytes = task.result().buf_size_bytes
                        self._budget.release(nbytes)
                        self._throughput.add(nbytes)
                        telemetry.counter_add("bytes_written", nbytes)
                        telemetry.counter_add("entries_written", 1)
                        if reporter is not None:
                            reporter.inflight_io -= 1
                            reporter.completed_count += 1
                            reporter.completed_bytes += nbytes
        except BaseException:
            await _cancel_all(self._io_tasks)
            self._io_tasks = set()
            self._ready_for_io.clear()
            raise
        finally:
            if reporter is not None:
                reporter.stop()
            self._executor.shutdown(wait=True)
        self._throughput.log_summary()
        # The achieved end-to-end write rate (staging and I/O) sizes the
        # next take's sub-chunks and concurrency.
        _feed_governor_rates(
            "write", type(self._storage).__name__,
            self._throughput.total_bytes, self._throughput.elapsed(),
        )

    def sync_complete(self, event_loop: asyncio.AbstractEventLoop) -> None:
        event_loop.run_until_complete(self.complete())

    async def abort(self) -> None:
        """Cancel the writes in flight and release the executor: a peer
        rank's staging failure aborts the take, and its dispatched writes
        must not run on unawaited (scheduler.py:1330-1345 of the JAX
        package)."""
        self._ready_for_io.clear()
        if self._reporter is not None:
            self._reporter.stop()
        for task in self._io_tasks:
            task.cancel()
        if self._io_tasks:
            await asyncio.gather(*self._io_tasks, return_exceptions=True)
        self._io_tasks = set()
        self._executor.shutdown(wait=True)

    def sync_abort(self, event_loop: asyncio.AbstractEventLoop) -> None:
        event_loop.run_until_complete(self.abort())


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    allow_streaming: bool = False,
) -> PendingIOWork:
    loop = asyncio.get_running_loop()
    executor = ThreadPoolExecutor(max_workers=_CPU_CONCURRENCY)
    budget = _MemoryBudget(memory_budget_bytes)
    throughput = _Throughput("wrote", rank)
    reporter = _ProgressReporter("write", rank, len(write_reqs), budget)
    reporter.start()
    governor = io_governor()
    plugin_key = type(storage).__name__
    # The closed loop arms its trial before the elections below, so this
    # op runs it and the verdict after the commit scores it.
    governor.begin_io_op("write", plugin_key)
    # Only plugins that consume chunks as they come are eligible: the
    # buffered write_stream fallback would hold a whole entry while the
    # budget charged a window.
    sub_chunk = (
        governor.sub_chunk_bytes(plugin_key)
        if allow_streaming and getattr(storage, "supports_streaming", False)
        else None
    )
    io_concurrency = governor.io_concurrency("write", plugin_key)
    # Tenancy admission (tenancy/admission.py): a session armed on this
    # op's storage scales the I/O-slot cap by the tenant's bandwidth share
    # and paces each dispatched request through its token bucket. None on
    # every op without a tenant: the attribute probe is the whole cost.
    admission = getattr(storage, "_tsnap_admission", None)
    if admission is not None:
        io_concurrency = admission.scale_concurrency(io_concurrency)

    async def _paced(coro, nbytes):
        await admission.admit(nbytes, "write", plugin_key)
        return await coro

    # Largest first: better budget packing, and the slowest copies
    # overlap with the I/O of everything else.
    ready_for_staging = sorted(
        (_WritePipeline(req, sub_chunk, storage) for req in write_reqs),
        key=lambda p: p.staging_cost_bytes,
        reverse=True,
    )
    reporter.total_bytes = sum(p.staging_cost_bytes for p in ready_for_staging)
    n_streamed = sum(p.streamed for p in ready_for_staging)
    if n_streamed:
        logger.debug(
            "[rank %d] streaming %d/%d write(s) in %d-byte sub-chunks",
            rank, n_streamed, len(ready_for_staging), sub_chunk,
        )
    staging_tasks: Set[asyncio.Task] = set()
    io_tasks: Set[asyncio.Task] = set()
    ready_for_io: List[_WritePipeline] = []
    inflight_streams = 0

    def dispatch_staging() -> None:
        nonlocal inflight_streams
        deferred: List[_WritePipeline] = []
        while ready_for_staging:
            head = ready_for_staging[0]
            # A stream holds a storage request for its whole life, so
            # streams and buffered writes share one cap.
            if head.streamed and inflight_streams + len(io_tasks) >= io_concurrency:
                deferred.append(ready_for_staging.pop(0))
                continue
            cost = head.admission_cost_bytes
            if cost > budget.available and (
                staging_tasks or io_tasks or ready_for_io or deferred
            ):
                telemetry.counter_add("budget_defers", 1)
                break  # over budget; the starvation escape admits it when idle
            pipeline = ready_for_staging.pop(0)
            budget.acquire(cost)
            reporter.inflight_staging += 1
            if pipeline.streamed:
                inflight_streams += 1
                stream_coro = pipeline.stream_write(storage, executor)
                if admission is not None:
                    stream_coro = _paced(stream_coro, cost)
                staging_tasks.add(loop.create_task(stream_coro))
            else:
                staging_tasks.add(loop.create_task(pipeline.stage_buffer(executor)))
        # Entries deferred for a stream slot keep their place at the head.
        ready_for_staging[:0] = deferred

    def dispatch_io() -> None:
        while ready_for_io and len(io_tasks) + inflight_streams < io_concurrency:
            pipeline = ready_for_io.pop(0)
            io_coro = pipeline.write_buffer(storage)
            if admission is not None:
                # Pacing runs inside the slot: a throttled tenant's request
                # holds its (share-scaled) slot while it waits.
                io_coro = _paced(io_coro, pipeline.admission_cost_bytes)
            io_tasks.add(loop.create_task(io_coro))
            reporter.inflight_io += 1

    dispatch_staging()
    try:
        while staging_tasks or ready_for_staging:
            done, _ = await asyncio.wait(
                staging_tasks | io_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                pipeline = task.result()
                if task in staging_tasks:
                    staging_tasks.discard(task)
                    reporter.inflight_staging -= 1
                    reporter.staged_count += 1
                    reporter.staged_bytes += pipeline.buf_size_bytes
                    if pipeline.streamed:
                        # Staged and written: release the window.
                        inflight_streams -= 1
                        budget.release(pipeline.admission_cost_bytes)
                        throughput.add(pipeline.buf_size_bytes)
                        telemetry.counter_add("bytes_written", pipeline.buf_size_bytes)
                        telemetry.counter_add("entries_written", 1)
                        reporter.completed_count += 1
                        reporter.completed_bytes += pipeline.buf_size_bytes
                        continue
                    budget.release(pipeline.staging_cost_bytes - pipeline.buf_size_bytes)
                    ready_for_io.append(pipeline)
                else:
                    io_tasks.discard(task)
                    budget.release(pipeline.buf_size_bytes)
                    throughput.add(pipeline.buf_size_bytes)
                    telemetry.counter_add("bytes_written", pipeline.buf_size_bytes)
                    telemetry.counter_add("entries_written", 1)
                    reporter.inflight_io -= 1
                    reporter.completed_count += 1
                    reporter.completed_bytes += pipeline.buf_size_bytes
            dispatch_io()
            dispatch_staging()
    except BaseException:
        reporter.stop()
        await _cancel_all(staging_tasks | io_tasks)
        executor.shutdown(wait=True)
        raise
    # The drain restarts the reporter on its own loop.
    reporter.stop()
    logger.debug("[rank %d] staged %d write(s)", rank, len(write_reqs))
    return PendingIOWork(ready_for_io, io_tasks, storage, budget, executor, throughput, reporter)


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
    allow_streaming: bool = True,
) -> None:
    # A blocking caller waits for the writes anyway, so streaming costs
    # it nothing.
    pending = event_loop.run_until_complete(
        execute_write_reqs(
            write_reqs, storage, memory_budget_bytes, rank, allow_streaming=allow_streaming
        )
    )
    pending.sync_complete(event_loop)


class _ReadPipeline:
    def __init__(
        self,
        read_req: ReadReq,
        sub_chunk_bytes: Optional[int] = None,
        stream_all: bool = False,
        coop_plan=None,
        peer_sub_chunk: Optional[int] = None,
    ) -> None:
        self.read_req = read_req
        self.cost_bytes = read_req.buffer_consumer.get_consuming_cost_bytes()
        # The peer role (fanout.py): SendRole (this rank reads and
        # forwards), RecvRole (the bytes arrive from a peer) or None.
        self.coop_role = coop_plan.take_role(read_req) if coop_plan is not None else None
        self.coop_gen = 1
        self.peer_sub_chunk = peer_sub_chunk
        self.peer_streamed = False
        # Shared by the peer-fed entries: caps their direct fallbacks at
        # the I/O concurrency (set by execute_read_reqs).
        self.fallback_gate: Optional[asyncio.Semaphore] = None
        self.sub_chunk_bytes = sub_chunk_bytes
        self.streamed = False
        self.admission_cost_bytes = self.cost_bytes
        br = read_req.byte_range
        empty = br is not None and br[1] <= br[0]
        consumer = read_req.buffer_consumer
        if self.is_recv:
            # Peer-fed: no storage I/O unless it falls back (buffered), so
            # the storage election does not apply; the peer channel always
            # yields chunks, and the consumer alone decides to stream.
            self.sub_chunk_bytes = None
            if peer_sub_chunk is not None and not empty and consumer.can_stream(peer_sub_chunk):
                self.peer_streamed = True
                self.admission_cost_bytes = min(
                    self.cost_bytes, consumer.stream_admission_cost(peer_sub_chunk)
                )
            return
        # The streaming election: the consumer opts in for this sub-chunk
        # size and declares its window. A consumer that would hold the
        # whole payload anyway, or that says streaming does not pay on
        # memory-speed storage, streams only under ``stream_all`` (forced,
        # or latency-bound storage): on page-cache reads the buffered mmap
        # path's fewer copies win.
        if sub_chunk_bytes is not None and not empty and consumer.can_stream(sub_chunk_bytes):
            window = min(self.cost_bytes, consumer.stream_admission_cost(sub_chunk_bytes))
            if stream_all or (window < self.cost_bytes and consumer.streams_on_fast_storage()):
                self.admission_cost_bytes = window
                self.streamed = True

    @property
    def is_recv(self) -> bool:
        return self.coop_role is not None and self.coop_role.is_recv

    @property
    def coop_order(self) -> int:
        """Dispatch class: peer-fed entries first (no storage I/O, and
        opening them early drains the inboxes the owners fill), then owned
        entries (peers wait on them), then plain reads."""
        if self.coop_role is None:
            return 2
        return 0 if self.coop_role.is_recv else 1

    def _recharge(self, budget: Optional[_MemoryBudget]) -> None:
        """The entry is about to hold its whole payload (a buffered retry
        or fallback) while the budget charged a window: charge the
        difference."""
        delta = self.cost_bytes - self.admission_cost_bytes
        if delta > 0 and budget is not None:
            budget.acquire(delta)
            self.admission_cost_bytes = self.cost_bytes

    # ---------------------------------------------------- peer-fed path

    async def _peer_stream_consume(self, role, consumer, executor, throughput: _Throughput) -> None:
        source = role.stream()

        async def counted():
            async for chunk in source:
                n = memoryview(chunk).nbytes
                throughput.add(n)
                telemetry.counter_add("bytes_read", n)
                count_peer("bytes_from_peers", n)
                yield chunk

        chunks = counted()
        try:
            await consumer.consume_stream(
                ReadStream(path=self.read_req.path, nbytes=self.cost_bytes, chunks=chunks), executor
            )
        finally:
            await chunks.aclose()
            await source.aclose()

    async def _peer_read_and_consume(
        self, executor, throughput: _Throughput, budget: Optional[_MemoryBudget]
    ) -> bool:
        """Consume this entry from its owner's forwarded frames. False when
        they cannot be delivered or fail verification (the consumer
        verifies them as it verifies storage bytes); the caller then reads
        the entry directly: a peer failure costs one re-read, never a
        hang."""
        role = self.coop_role
        consumer = self.read_req.buffer_consumer
        path = self.read_req.path
        try:
            if self.peer_streamed:
                try:
                    with telemetry.span("consume", path=path, bytes=self.cost_bytes):
                        await self._peer_stream_consume(role, consumer, executor, throughput)
                    telemetry.counter_add("entries_read", 1)
                    count_peer("entries_from_peers", 1)
                    return True
                except StreamRestartRequired as e:
                    # The owner's storage stream restarted: the final
                    # generation arrives whole and is taken buffered.
                    logger.warning(
                        "peer-fed stream of %s restarting through the buffered path: %s", path, e
                    )
                    _count_stream("stream_read_restarts")
                    self._recharge(budget)
            with telemetry.span("peer_recv", cat="fanout", path=path):
                buf = await role.buffered()
            n = memoryview(buf).nbytes
            throughput.add(n)
            telemetry.counter_add("bytes_read", n)
            count_peer("bytes_from_peers", n)
            with telemetry.span("consume", path=path, bytes=n):
                await consumer.consume_buffer(buf, executor)
            telemetry.counter_add("entries_read", 1)
            count_peer("entries_from_peers", 1)
            return True
        except (IOError, IntegrityError) as e:
            # IOError: the transport family (PeerTransferError, short or
            # long transfers); IntegrityError: the peer's bytes failed the
            # checksum. Storage may still hold good bytes: read them. The
            # degraded path is accounted like a storage retry: the
            # classified kind and the history attributes on the exception.
            from .storage_plugins.retry import attach_fallback_history

            kind = attach_fallback_history(e)
            logger.warning(
                "peer-fed read of %s from rank %s failed (%s: %s); falling back to a "
                "direct storage read", path, role.owner, type(e).__name__, e,
            )
            count_peer("fanout_fallbacks", 1)
            count_peer(f"fanout_fallbacks.{type(e).__name__}", 1)
            flightrec.record("fanout.fallback", key=path, owner=role.owner, kind=kind,
                             error=type(e).__name__)
            self._recharge(budget)
            return False

    # ------------------------------------------------- owner forwarding

    async def _forward_buffer(self, role, buf) -> None:
        """Forward a buffered owner read to the subscribers in frames of
        the peer sub-chunk size (receivers keep their streamed window)."""
        mv = memoryview(buf).cast("B")
        step = self.peer_sub_chunk or _DEFAULT_SUB_CHUNK_BYTES
        n = 0
        for lo in range(0, mv.nbytes, step):
            await role.chunk(self.coop_gen, n, mv[lo : lo + step])
            n += 1
        await role.end(self.coop_gen, mv.nbytes, n)

    async def _stream_read_and_consume(
        self, storage: StoragePlugin, executor, throughput: _Throughput
    ) -> bool:
        """The storage read and the consume in one: the plugin yields
        sub-chunks as it reads them and the consumer takes each while the
        next is read. An owner also forwards each sub-chunk, one send
        ahead of its own consume. False when the stream asks for a restart
        from offset 0 (the caller then reads the entry buffered; an owner
        first starts a new generation, so receivers drop what they got)."""
        read_io = ReadIO(path=self.read_req.path, byte_range=self.read_req.byte_range)
        consumer = self.read_req.buffer_consumer
        role = self.coop_role
        send = role if role is not None and role.is_send else None
        sent = {"n": 0, "bytes": 0}
        plugin_key = type(storage).__name__

        async def counted(chunks):
            pending_send = None
            observe = telemetry.enabled()
            try:
                while True:
                    t0 = telemetry.monotonic() if observe else None
                    try:
                        chunk = await chunks.__anext__()
                    except StopAsyncIteration:
                        break
                    if t0 is not None:
                        telemetry.histogram_observe("read.sub_chunk_s",
                                                    telemetry.monotonic() - t0, key=plugin_key)
                    n = memoryview(chunk).nbytes
                    throughput.add(n)
                    telemetry.counter_add("bytes_read", n)
                    if send is not None:
                        telemetry.counter_add("bytes_from_storage", n)
                        if pending_send is not None:
                            await pending_send
                        pending_send = asyncio.get_running_loop().create_task(
                            send.chunk(self.coop_gen, sent["n"], chunk)
                        )
                        sent["n"] += 1
                        sent["bytes"] += n
                    yield chunk
                if pending_send is not None:
                    await pending_send
                    pending_send = None
            finally:
                if pending_send is not None:
                    # Unwinding mid-stream: let the frame in flight land whole.
                    try:
                        await pending_send
                    except Exception:  # noqa: BLE001 - unwind path
                        pass

        try:
            with forensics.storage_op("storage_read", path=self.read_req.path):
                stream = await storage.read_stream(read_io, self.sub_chunk_bytes)
                source = counted(stream.chunks)
                try:
                    with telemetry.span("stream_read", path=stream.path, bytes=stream.nbytes,
                                        sub_chunk_bytes=self.sub_chunk_bytes):
                        await consumer.consume_stream(
                            ReadStream(path=stream.path, nbytes=stream.nbytes, chunks=source),
                            executor,
                        )
                finally:
                    await source.aclose()
                    aclose = getattr(stream.chunks, "aclose", None)
                    if aclose is not None:
                        await aclose()
        except StreamRestartRequired as e:
            logger.warning(
                "streamed read of %s restarting through the buffered path: %s",
                self.read_req.path, e,
            )
            _count_stream("stream_read_restarts")
            if send is not None:
                self.coop_gen += 1
                await send.restart(self.coop_gen)
            return False
        if send is not None:
            await send.end(self.coop_gen, sent["bytes"], sent["n"])
        telemetry.counter_add("entries_read", 1)
        _count_stream("entries_stream_read")
        return True

    async def _buffered_read_and_consume(
        self, storage: StoragePlugin, executor, throughput: _Throughput, budget
    ) -> None:
        self._recharge(budget)
        read_io = ReadIO(path=self.read_req.path, byte_range=self.read_req.byte_range)
        t0 = telemetry.monotonic() if telemetry.enabled() else None
        with forensics.storage_op("storage_read", path=self.read_req.path), \
                telemetry.span("storage_read", path=self.read_req.path) as sp:
            await storage.read(read_io)
            sp.set(bytes=memoryview(read_io.buf).nbytes)
        if t0 is not None:
            telemetry.histogram_observe("read.entry_s", telemetry.monotonic() - t0,
                                        key=type(storage).__name__)
        n = memoryview(read_io.buf).nbytes
        throughput.add(n)
        telemetry.counter_add("bytes_read", n)
        telemetry.counter_add("entries_read", 1)
        role = self.coop_role
        if role is not None and role.is_send:
            telemetry.counter_add("bytes_from_storage", n)
            # Forward before the local consume: the subscribers' decode
            # starts while this rank's consumer works.
            await self._forward_buffer(role, read_io.buf)
        with telemetry.span("consume", path=self.read_req.path, bytes=n):
            await self.read_req.buffer_consumer.consume_buffer(read_io.buf, executor)

    async def read_and_consume(
        self,
        storage: StoragePlugin,
        executor,
        throughput: _Throughput,
        budget: Optional[_MemoryBudget] = None,
    ) -> "_ReadPipeline":
        if self.is_recv:
            if await self._peer_read_and_consume(executor, throughput, budget):
                return self
            # A dual-mode consumer (reshard.PlannedRecvConsumer, fed a
            # region bundle by its peer) is told first, so the re-read of
            # the same request decodes as stored bytes. The fallback is a
            # storage request that dispatch never counted: it takes a slot
            # of the gate, so a mass peer failure cannot flood storage.
            on_fallback = getattr(self.read_req.buffer_consumer, "on_peer_fallback", None)
            if on_fallback is not None:
                on_fallback()
            if self.fallback_gate is not None:
                async with self.fallback_gate:
                    await self._buffered_read_and_consume(storage, executor, throughput, budget)
            else:
                await self._buffered_read_and_consume(storage, executor, throughput, budget)
            return self
        if self.streamed and await self._stream_read_and_consume(storage, executor, throughput):
            return self
        await self._buffered_read_and_consume(storage, executor, throughput, budget)
        return self


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    coop=None,
    preempt=None,
) -> None:
    """Read and consume ``read_reqs`` under the memory budget. ``coop``
    (a ``fanout.CoopKeyPlan`` or ``reshard.ComposedRestorePlan``) gives
    each request its peer role. ``preempt`` (a page-in session's
    background batches) returns True while a demand fault is in flight:
    this execution then keeps at most one request in flight, so its I/O
    slots yield to the fault without a pause that could deadlock it."""
    loop = asyncio.get_running_loop()
    budget = _MemoryBudget(memory_budget_bytes)
    throughput = _Throughput("read", rank)
    reporter = _ProgressReporter("read", rank, len(read_reqs), budget)
    governor = io_governor()
    plugin_key = type(storage).__name__
    governor.begin_io_op("read", plugin_key)
    # Only plugins that produce chunks as they read are eligible, and each
    # consumer opts in per entry; the sub-chunk size follows the measured
    # read bandwidth.
    mode = stream_reads_mode()
    sub_chunk = (
        governor.sub_chunk_bytes(plugin_key, op="read")
        if mode != "never" and getattr(storage, "supports_streaming_reads", False)
        else None
    )
    read_bps = governor.read_bps(plugin_key)
    stream_all = mode == "always" or (
        read_bps is not None and read_bps < _STREAM_READ_LATENCY_BPS
    )
    # The peer frame size does not depend on the plugin: the peer channel
    # always yields chunks, and owners cut buffered forwards at it too.
    peer_chunk = governor.sub_chunk_bytes(plugin_key, op="read") if coop is not None else None
    pending = [_ReadPipeline(req, sub_chunk, stream_all, coop, peer_chunk) for req in read_reqs]
    # Peer-fed entries first, then owned ones, then plain reads; largest
    # first within a class.
    pending.sort(key=lambda p: (p.coop_order, -p.cost_bytes))
    reporter.total_bytes = sum(p.cost_bytes for p in pending)
    n_streamed = sum(p.streamed for p in pending)
    if n_streamed:
        logger.debug(
            "[rank %d] streaming %d/%d read(s) in %d-byte sub-chunks",
            rank, n_streamed, len(pending), sub_chunk,
        )
    io_concurrency = governor.io_concurrency("read", plugin_key)
    # Tenancy admission, read side: the scaled slot cap and per-request
    # pacing. Peer-fed entries are never paced: they issue no storage
    # request (their direct fallbacks are).
    admission = getattr(storage, "_tsnap_admission", None)
    if admission is not None:
        io_concurrency = admission.scale_concurrency(io_concurrency)

    async def _paced(coro, nbytes):
        await admission.admit(nbytes, "read", plugin_key)
        return await coro

    if coop is not None:
        fallback_gate = asyncio.Semaphore(io_concurrency)
        for p in pending:
            if p.is_recv:
                p.fallback_gate = fallback_gate
    tasks: Set[asyncio.Task] = set()
    inflight_recv = 0
    with ThreadPoolExecutor(max_workers=_CPU_CONCURRENCY) as executor:

        def launch(pipeline: _ReadPipeline) -> None:
            nonlocal inflight_recv
            budget.acquire(pipeline.admission_cost_bytes)
            reporter.inflight_io += 1
            if pipeline.is_recv:
                inflight_recv += 1
            read_coro = pipeline.read_and_consume(storage, executor, throughput, budget)
            if admission is not None and not pipeline.is_recv:
                read_coro = _paced(read_coro, pipeline.admission_cost_bytes)
            tasks.add(loop.create_task(read_coro))

        def dispatch() -> None:
            while pending:
                if preempt is not None and tasks and preempt():
                    break
                head = pending[0]
                # Peer-fed entries take no I/O slot: they issue no storage
                # request while they wait (their fallbacks take the gate's).
                if not head.is_recv and len(tasks) - inflight_recv >= io_concurrency:
                    break
                if head.admission_cost_bytes > budget.available and tasks:
                    # Over budget. If only peer-fed entries are in flight,
                    # nothing local will release budget, and the owned and
                    # plain reads that feed the world must not wait behind
                    # them: admit the first of those over budget.
                    if inflight_recv == len(tasks):
                        idx = next((i for i, p in enumerate(pending) if not p.is_recv), None)
                        if idx is not None:
                            launch(pending.pop(idx))
                            continue
                    telemetry.counter_add("budget_defers", 1)
                    break
                launch(pending.pop(0))

        reporter.start()
        try:
            dispatch()
            while pending or tasks:
                done, _ = await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
                for task in done:
                    tasks.discard(task)
                    pipeline = task.result()
                    budget.release(pipeline.admission_cost_bytes)
                    reporter.inflight_io -= 1
                    reporter.completed_count += 1
                    reporter.completed_bytes += pipeline.cost_bytes
                    if pipeline.is_recv:
                        inflight_recv -= 1
                dispatch()
        except BaseException:
            await _cancel_all(tasks)
            raise
        finally:
            reporter.stop()
    logger.debug("[rank %d] read %d request(s)", rank, len(read_reqs))
    throughput.log_summary()
    # The achieved read rate feeds the preverify gate, the read sub-chunk
    # size, the streaming election and the peer elections of the next
    # restore.
    _feed_governor_rates("read", plugin_key, throughput.total_bytes, throughput.elapsed())


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    event_loop: asyncio.AbstractEventLoop,
    coop=None,
    preempt=None,
) -> None:
    event_loop.run_until_complete(
        execute_read_reqs(read_reqs, storage, memory_budget_bytes, rank, coop=coop,
                          preempt=preempt)
    )
