"""Deterministic fault injection for the snapshot pipeline.

Counterpart of ``torchsnapshot_tpu/faultinject.py`` (pure Python; the port
keeps its own copy). Named injection sites sit at the I/O boundaries of
the fs plugin, the native I/O engine, the scheduler, the commit point, the
coordination store, the peer channel and the planned reshard, and a seeded
fault plan decides, deterministically,
which hits of which sites misbehave and how. With no plan (the default) each :func:`site` /
:func:`mutate` call is one check of a module global.

Plan grammar (``TORCHSNAPSHOT_GPU_FAULT_PLAN``, or :func:`configure`)::

    PLAN    := RULE (';' RULE)* [';' 'seed=' INT]
    RULE    := SITE '@' TRIGGER '=' ACTION [':' ARG]
    TRIGGER := N            -- exactly the Nth hit of the site (1-based)
             | N '+'        -- the Nth hit and every one after it
             | 'p' FLOAT    -- each hit independently with probability FLOAT
    ACTION  := 'transient'  -- raise InjectedTransientError (retryable class)
             | 'permanent'  -- raise InjectedPermanentError (OSError class)
             | 'delay'      -- sleep ARG seconds (default 0.05)
             | 'corrupt'    -- flip one byte (ARG = offset; default seeded)
             | 'truncate'   -- keep ARG fraction of the bytes (default 0.5)
             | 'kill'       -- SIGKILL this process at the site

Example: ``TORCHSNAPSHOT_GPU_FAULT_PLAN='fs.pread@3=corrupt;seed=7'``
flips one byte of the third streamed sub-chunk read. ``corrupt`` and
``truncate`` act only at data sites (calls through :func:`mutate`).
"""

from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

FAULT_PLAN_ENV_VAR = "TORCHSNAPSHOT_GPU_FAULT_PLAN"

# The site registry: every injection point of the package, by name. A
# site is "data" when its call passes payload bytes through mutate()
# (corrupt/truncate act there) and "control" when it only raises, delays
# or kills. Only the sites this package wires are registered.
SITES: Dict[str, str] = {
    # filesystem plugin
    "fs.write": "data",           # buffered temp-file write
    "fs.pwrite": "data",          # streamed sub-chunk positional write
    "fs.read": "data",            # buffered / mmap read
    "fs.pread": "data",           # streamed sub-chunk positional read
    "fs.native_pwrite": "data",   # native-engine (io_uring) sub-chunk write
    "fs.native_pread": "data",    # native-engine (io_uring) sub-chunk read
    # S3 plugin (storage_plugins/s3.py)
    "s3.put": "data",             # single-request PUT
    "s3.put_part": "data",        # multipart part upload
    "s3.get": "data",             # (ranged) GET
    # GCS plugin (storage_plugins/gcs.py)
    "gcs.resumable_feed": "data",  # chunk fed to the resumable upload
    "gcs.get": "data",            # (ranged) download
    # pipeline
    "scheduler.stage": "control",  # per-entry staging admission
    "commit.metadata": "data",    # the .snapshot_metadata commit point
    # coordination store (dist_store.py)
    "dist_store.rpc": "control",  # every KV-store client round trip
    "dist_store.serve_op": "control",  # server-side dispatch of one op
    "dist_store.replica_rpc": "control",  # leader->replica op-log message
    "dist_store.lease_renew": "control",  # leader lease-renewal round
    "peer.send_frame": "data",    # fan-out peer channel, sender side
    "peer.recv_frame": "control",  # fan-out peer channel, receiver side
    # planned reshard (reshard.py): the owner's bundle just before it
    # reaches the peer channel
    "reshard.peer_xfer": "data",
    # two-tier mirror (storage_plugins/mirror.py): before each buffered
    # primary read, so a raise here drives the mirror failover
    "mirror.primary_read": "control",
    # delta journal (journal.py): the append site sits inside one
    # record's frame, after its 8-byte prefix reached the disk, so kill
    # leaves a torn record and corrupt/truncate mangle bytes whose CRCs
    # were computed first; the replay site sees a payload just read,
    # before its CRC check
    "journal.append": "data",
    "journal.replay": "data",
    # geo-replication (georep.py): the epoch blob as it leaves the
    # shipper (the remote apply's CRC check must catch corruption before
    # any remote byte changes) and the remote apply after the segment
    # bytes landed, before the epoch metadata commit
    "georep.ship": "data",
    "georep.apply": "control",
    # fleet distribution tier (distrib.py): the seeded chunk as it
    # leaves the seeder (corrupt is caught by the receiver's
    # content-address re-hash, kill is the mid-transfer seeder death)
    # and the epoch blob as it leaves the rolling-update pusher
    "distrib.seed_xfer": "data",
    "distrib.epoch_push": "data",
    # tenancy (tenancy/): the quota gate before any payload I/O and the
    # admission-table registration
    "tenancy.quota_check": "control",
    "tenancy.admission": "control",
    # lazy page-in restore (pagein.py): the engine's two batch kinds
    "pagein.prefetch": "control",
    "pagein.fault": "control",
}

KNOWN_SITES = frozenset(SITES)

_CONTROL_ACTIONS = frozenset({"transient", "permanent", "delay", "kill"})
_DATA_ACTIONS = frozenset({"corrupt", "truncate"})


class InjectedFault(Exception):
    """Marker base for every injected error (tests/chaos filter on it)."""


class InjectedTransientError(InjectedFault, ConnectionError):
    """An injected *retryable* failure (a ConnectionError): paths with
    retries retry it, the others abort."""


class InjectedPermanentError(InjectedFault, OSError):
    """An injected *non-retryable* failure: a plain OSError."""


@dataclass
class _Rule:
    site: str
    action: str
    arg: Optional[float]
    nth: Optional[int]        # exact hit number (1-based)
    open_ended: bool          # nth and every hit after
    prob: Optional[float]     # probabilistic trigger

    def matches(self, hit: int, rng: random.Random) -> bool:
        if self.prob is not None:
            return rng.random() < self.prob
        assert self.nth is not None
        if self.open_ended:
            return hit >= self.nth
        return hit == self.nth


def _parse_rule(text: str) -> _Rule:
    head, sep, action_part = text.partition("=")
    if not sep:
        raise ValueError(f"fault rule {text!r}: expected SITE@TRIGGER=ACTION")
    site_name, sep, trigger = head.partition("@")
    site_name = site_name.strip()
    if not sep or not trigger:
        raise ValueError(f"fault rule {text!r}: expected SITE@TRIGGER=ACTION")
    if site_name not in KNOWN_SITES:
        raise ValueError(
            f"fault rule {text!r}: unknown site {site_name!r} "
            f"(registered sites: {', '.join(sorted(KNOWN_SITES))})"
        )
    action, _, arg_str = action_part.partition(":")
    action = action.strip()
    if action not in _CONTROL_ACTIONS | _DATA_ACTIONS:
        raise ValueError(
            f"fault rule {text!r}: unknown action {action!r} (expected "
            "transient/permanent/delay/corrupt/truncate/kill)"
        )
    arg: Optional[float] = None
    if arg_str:
        try:
            arg = float(arg_str)
        except ValueError:
            raise ValueError(
                f"fault rule {text!r}: non-numeric action argument {arg_str!r}"
            ) from None
    trigger = trigger.strip()
    nth: Optional[int] = None
    open_ended = False
    prob: Optional[float] = None
    if trigger.startswith("p"):
        try:
            prob = float(trigger[1:])
        except ValueError:
            raise ValueError(
                f"fault rule {text!r}: malformed probability trigger {trigger!r}"
            ) from None
        if not (0.0 <= prob <= 1.0):
            raise ValueError(
                f"fault rule {text!r}: probability {prob} outside [0, 1]"
            )
    else:
        raw = trigger
        if raw.endswith("+"):
            open_ended = True
            raw = raw[:-1]
        try:
            nth = int(raw)
        except ValueError:
            raise ValueError(
                f"fault rule {text!r}: malformed trigger {trigger!r} "
                "(expected N, N+, or pFLOAT)"
            ) from None
        if nth < 1:
            raise ValueError(f"fault rule {text!r}: hit numbers are 1-based")
    return _Rule(
        site=site_name,
        action=action,
        arg=arg,
        nth=nth,
        open_ended=open_ended,
        prob=prob,
    )


class FaultPlan:
    """A parsed fault schedule: rules grouped by site, a seeded RNG, and
    exact per-site hit counters. Thread-safe: sites fire from the event
    loop and from executor threads alike."""

    def __init__(self, spec: str) -> None:
        self.spec = spec
        seed = 0
        rules: List[_Rule] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                try:
                    seed = int(part[len("seed="):])
                except ValueError:
                    raise ValueError(
                        f"fault plan: malformed seed segment {part!r}"
                    ) from None
                continue
            rules.append(_parse_rule(part))
        if not rules:
            raise ValueError(f"fault plan {spec!r} contains no rules")
        self.seed = seed
        self._rules: Dict[str, List[_Rule]] = {}
        for rule in rules:
            self._rules.setdefault(rule.site, []).append(rule)
        self._rng = random.Random(seed)
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._warned_sites: set = set()

    def hits(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hits)

    def fire(self, name: str, buf: Any) -> Any:
        """Count one hit of ``name`` and apply every matching rule.

        Order within one hit: delays first, then data mutations, then a
        raise/kill — so a rule pair like ``delay + transient`` behaves
        as "slow, then fails". Returns the (possibly mutated) buffer.
        """
        with self._lock:
            hit = self._hits.get(name, 0) + 1
            self._hits[name] = hit
            fired = [
                r
                for r in self._rules.get(name, ())
                if r.matches(hit, self._rng)
            ]
            if not fired:
                return buf
            # Pre-draw the corrupt offset under the lock so concurrent
            # hits stay deterministic given a deterministic interleaving.
            offsets: Dict[int, int] = {}
            for i, rule in enumerate(fired):
                if rule.action == "corrupt" and rule.arg is None:
                    offsets[i] = self._rng.randrange(1 << 30)
        # Flight-record the trip before its action runs: a kill or raise
        # below must leave the trip in the ring (and in any dump). Lazy
        # import: the path with no plan never gets here.
        from .telemetry import flightrec

        flightrec.record("fault.trip", site=name, hit=hit,
                         action=",".join(r.action for r in fired))
        raiser: Optional[_Rule] = None
        for i, rule in enumerate(fired):
            if rule.action == "delay":
                time.sleep(rule.arg if rule.arg is not None else 0.05)
            elif rule.action == "corrupt":
                buf = self._corrupt(name, buf, rule, offsets.get(i))
            elif rule.action == "truncate":
                buf = self._truncate(name, buf, rule)
            elif raiser is None:
                raiser = rule
        if raiser is not None:
            hit_desc = f"{name} hit #{hit}"
            if raiser.action == "kill":
                logger.warning("fault injection: SIGKILL at %s", hit_desc)
                logging.shutdown()
                os.kill(os.getpid(), signal.SIGKILL)
            if raiser.action == "transient":
                raise InjectedTransientError(
                    f"injected transient fault at {hit_desc}"
                )
            raise InjectedPermanentError(
                f"injected permanent fault at {hit_desc}"
            )
        return buf

    def _data_or_warn(self, name: str, buf: Any, rule: _Rule) -> bool:
        if buf is None:
            if name not in self._warned_sites:
                self._warned_sites.add(name)
                logger.warning(
                    "fault plan rule %s@...=%s ignored: %r is a control "
                    "site (no payload bytes to mutate)",
                    name,
                    rule.action,
                    name,
                )
            return False
        return True

    def _corrupt(
        self, name: str, buf: Any, rule: _Rule, drawn_offset: Optional[int]
    ) -> Any:
        if not self._data_or_warn(name, buf, rule):
            return buf
        out = bytearray(memoryview(buf).cast("B"))
        if not out:
            return buf
        if rule.arg is not None:
            idx = min(int(rule.arg), len(out) - 1)
        else:
            idx = (drawn_offset or 0) % len(out)
        out[idx] ^= 0xFF
        logger.warning(
            "fault injection: flipped byte %d of %d at %s", idx, len(out), name
        )
        return out

    def _truncate(self, name: str, buf: Any, rule: _Rule) -> Any:
        if not self._data_or_warn(name, buf, rule):
            return buf
        mv = memoryview(buf).cast("B")
        frac = rule.arg if rule.arg is not None else 0.5
        keep = max(0, min(mv.nbytes, int(mv.nbytes * frac)))
        logger.warning(
            "fault injection: truncated %d -> %d bytes at %s",
            mv.nbytes,
            keep,
            name,
        )
        return mv[:keep]


def _plan_from_env() -> Optional[FaultPlan]:
    spec = os.environ.get(FAULT_PLAN_ENV_VAR, "").strip()
    if not spec:
        return None
    return FaultPlan(spec)


def _plan_from_env_lenient() -> Optional[FaultPlan]:
    """Import-time variant: a mistyped plan must not make the package
    unimportable. Log an error and run without injection; :func:`configure`
    still raises, so tests fail fast on bad plans."""
    try:
        return _plan_from_env()
    except ValueError as e:
        logger.error(
            "ignoring malformed %s (running WITHOUT fault injection): %s",
            FAULT_PLAN_ENV_VAR,
            e,
        )
        return None


_plan: Optional[FaultPlan] = _plan_from_env_lenient()


def configure(spec: Optional[str]) -> None:
    """Install a fault plan programmatically (None disables). Resets the
    hit counters and the seeded RNG — the plan replays from scratch."""
    global _plan
    _plan = FaultPlan(spec) if spec else None


def disable() -> None:
    configure(None)


def active() -> bool:
    return _plan is not None


def active_spec() -> Optional[str]:
    return _plan.spec if _plan is not None else None


def hits() -> Dict[str, int]:
    """Per-site hit counts of the active plan ({} when disabled)."""
    return _plan.hits() if _plan is not None else {}


def site(name: str) -> None:
    """A control injection point. Disabled hot path: one global check."""
    plan = _plan
    if plan is None:
        return
    plan.fire(name, None)


def mutate(name: str, buf: Any) -> Any:
    """A data injection point: returns ``buf`` (mutated under an active
    plan's corrupt/truncate rules; verbatim otherwise). Disabled hot
    path: one global check, no copy."""
    plan = _plan
    if plan is None:
        return buf
    return plan.fire(name, buf)
