"""Closed-loop autotuning for the I/O governor (the port's copy of
``torchsnapshot_tpu/autotune.py``; ``type="profile"`` records are
byte-compatible, so a profile learned by either package loads in the
other).

The governor's election sites (scheduler.IOGovernor) pick sub-chunk
size, I/O concurrency, the native engine, and the latency-bound fast
paths from measured rates — but the rules mapping rate to setting are
still hand-tuned constants. This module closes the loop: the critical-
path verdict of every committed take/restore (telemetry/critpath.py —
the binding category and its achieved GB/s) scores the settings that
produced it, one controlled perturbation at a time.

The controller is a per-profile hill climber:

- **Profile key** ``(storage plugin class, world size, binding
  category)``: a tuned sub-chunk size for a world-8 storage-bound save
  on the fs plugin says nothing about a world-1 pipeline-bound restore,
  so convergence state is kept per key. The binding category is an
  OUTPUT of the op, so the key for the *next* op uses the last verdict
  observed for that (plugin, direction) — a cold process without a
  remembered binding simply stays on the measured-rate heuristics.
- **Perturb-and-read**: at most ONE tunable dimension is perturbed per
  operation (round-robin over the dimensions the op direction owns),
  and only once the incumbent has a score to compare against. After
  commit the verdict's GB/s is compared to the incumbent's smoothed
  score: clearly better (beyond the hysteresis band) adopts the trial
  value and keeps the climb direction; clearly worse reverts and flips
  it; in between reverts but still folds the rate into the incumbent
  score (alpha 0.5, the governor's EWMA discipline) so one noisy save
  can neither flip an election nor freeze learning.
- **Persisted profiles**: converged settings ride the per-root history
  journal (telemetry/history.py) as ``type="profile"`` records — loaded
  back at governor construction so a fresh process on a known host
  warm-starts from the learned optimum instead of the static defaults.

This module is PURE CONTROL LOGIC — no telemetry, storage, or env-var
side effects — so the perturb/score/revert loop is unit-testable with
synthetic verdicts. The governor (scheduler.py) owns the wiring: env
precedence, flight events, heartbeat fields, and journal appends.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

AUTOTUNE_ENV_VAR = "TORCHSNAPSHOT_GPU_AUTOTUNE"

#: Adopt/revert dead band around the incumbent score: a trial must beat
#: (or lose to) the incumbent by this fraction to move the setting — the
#: same noise argument as the governor's rate smoothing, applied to the
#: verdict plane.
HYSTERESIS = 0.05
#: Incumbent-score smoothing (the governor's alpha-0.5 pattern): one
#: anomalous verdict moves the score halfway at most.
SCORE_ALPHA = 0.5
#: Perturbation trail kept per profile (and persisted): enough to read
#: the recent convergence story in ``explain --profiles`` without
#: growing journal records unboundedly.
MAX_TRIAL_HISTORY = 8


def autotune_mode() -> str:
    """THE parser for ``TORCHSNAPSHOT_GPU_AUTOTUNE`` — every consumer
    (election precedence, trial arming, verdict feedback, profile
    loading) goes through here so the recognized spellings can never
    drift. ``never`` disables the whole plane (elections fall back to
    env -> measured-rate heuristics, one env check of cost); ``pin``
    applies loaded profiles but runs no trials and persists nothing
    (a frozen fleet); ``fresh`` relearns from scratch, ignoring stored
    profiles (a changed host); default ``auto`` loads, applies,
    perturbs, and persists."""
    raw = os.environ.get(AUTOTUNE_ENV_VAR, "auto").strip().lower()
    if raw in ("0", "false", "off", "no", "never"):
        return "never"
    if raw in ("pin", "pinned", "freeze", "frozen"):
        return "pin"
    if raw in ("fresh", "reset", "relearn"):
        return "fresh"
    return "auto"


class Election:
    """One resolved governor decision: what was chosen, by which
    precedence tier, for which site. Every election site builds exactly
    this record (scheduler.IOGovernor._resolved), so the decision trail
    rendered by the JAX package's ``explain -v`` / ``--profiles`` has one
    shape."""

    __slots__ = ("site", "dim", "plugin", "value", "source", "profile", "inputs")

    def __init__(
        self,
        site: str,
        dim: str,
        plugin: Optional[str],
        value: Any,
        source: str,
        profile: Optional[str] = None,
        inputs: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.site = site
        self.dim = dim
        self.plugin = plugin
        self.value = value
        #: ``env`` (operator override) > ``trial`` (armed perturbation) >
        #: ``profile`` (learned setting) > ``heuristic`` (measured-rate
        #: cold-start fallback — today's logic).
        self.source = source
        self.profile = profile
        self.inputs = inputs or {}

    def as_fields(self) -> Dict[str, Any]:
        fields: Dict[str, Any] = {
            "site": self.site,
            "dim": self.dim,
            "value": self.value,
            "source": self.source,
        }
        if self.plugin:
            fields["plugin"] = self.plugin
        if self.profile:
            fields["profile"] = self.profile
        fields.update(self.inputs)
        return fields


def profile_key(plugin: str, world_size: int, binding: str) -> str:
    """The profile identity: settings converge per (storage class,
    world size, binding category)."""
    return f"{plugin}|w{world_size}|{binding}"


class _TuneState:
    """Convergence state for one profile key."""

    __slots__ = ("settings", "score", "takes", "trials", "direction", "fresh")

    def __init__(self) -> None:
        self.settings: Dict[str, Any] = {}
        self.score: Optional[float] = None  # smoothed verdict GB/s
        self.takes = 0
        self.trials: List[Dict[str, Any]] = []
        self.direction: Dict[str, int] = {}  # hill-climb direction per dim
        #: A/B pacing: True when the score was refreshed by an UNTRIALED
        #: op at the incumbent settings since the last trial. Trials arm
        #: only against a fresh baseline — comparing a perturbation to a
        #: score measured under different settings (an older default, a
        #: drifted heuristic) is how a hill climber wedges below a stale
        #: anchor.
        self.fresh = False


class AutoTuner:
    """The perturb/score/revert controller behind IOGovernor.

    Thread-safe the way the governor's rate tables are (one lock, short
    critical sections); all methods are cheap enough for election sites
    on the dispatch hot path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: Dict[str, _TuneState] = {}
        self._world = 1
        #: Last observed binding category per (plugin, op direction) —
        #: the op's profile key is derived from the PREVIOUS verdict.
        self._binding: Dict[Tuple[str, str], str] = {}
        #: The armed perturbation, at most one across the process:
        #: {"key", "dim", "value", "base", "op", "plugin"}.
        self._trial: Optional[Dict[str, Any]] = None
        self._round_robin: Dict[str, int] = {}

    # ------------------------------------------------------------ context

    def note_world(self, world_size: int) -> None:
        with self._lock:
            self._world = max(1, int(world_size))

    def key_for(self, plugin: str, op: str) -> Optional[str]:
        """Profile key the NEXT ``op``-direction operation on ``plugin``
        belongs to, or None while no binding verdict has been observed
        (cold start: heuristics)."""
        with self._lock:
            binding = self._binding.get((plugin, op))
            if binding is None:
                return None
            return profile_key(plugin, self._world, binding)

    # ---------------------------------------------------------- elections

    def resolve(self, dim: str, plugin: str, op: str) -> Optional[Tuple[Any, str]]:
        """(value, source) for an election site, or None when neither a
        trial nor a learned profile covers this dimension (the site then
        falls back to its measured-rate heuristic)."""
        with self._lock:
            trial = self._trial
            if (
                trial is not None
                and trial["dim"] == dim
                and trial["plugin"] == plugin
                and trial["op"] == op
            ):
                return trial["value"], "trial"
            binding = self._binding.get((plugin, op))
            if binding is None:
                return None
            state = self._states.get(profile_key(plugin, self._world, binding))
            if state is None or dim not in state.settings:
                return None
            return state.settings[dim], "profile"

    # ------------------------------------------------------------- trials

    def maybe_arm(
        self, op: str, plugin: str, dims: Dict[str, Dict[str, Any]]
    ) -> Optional[Dict[str, Any]]:
        """Arm at most one perturbation for this operation.

        ``dims`` maps dimension name -> descriptor: ``{"value": current
        incumbent, "kind": "geom"|"toggle", "lo": ..., "hi": ...,
        "quantum": ...}``. Trials arm only against a FRESH incumbent
        score — one measured by an untrialed op at the current settings
        since the last trial — so trials and clean baselines alternate
        (A/B pacing) and a perturbation is never judged against a score
        another configuration earned. Only one trial exists process-wide
        — "perturb exactly one dimension per take". Returns the armed
        trial (a copy) or None."""
        with self._lock:
            if self._trial is not None or not dims:
                return None
            binding = self._binding.get((plugin, op))
            if binding is None:
                return None
            key = profile_key(plugin, self._world, binding)
            state = self._states.get(key)
            if state is None or state.score is None or not state.fresh:
                return None
            names = sorted(dims)
            start = self._round_robin.get(key, 0)
            for i in range(len(names)):
                dim = names[(start + i) % len(names)]
                desc = dims[dim]
                base = state.settings.get(dim, desc["value"])
                value = self._perturbed(state, dim, base, desc)
                if value is None or value == base:
                    continue
                self._round_robin[key] = (start + i + 1) % len(names)
                self._trial = {
                    "key": key,
                    "dim": dim,
                    "value": value,
                    "base": base,
                    "op": op,
                    "plugin": plugin,
                }
                return dict(self._trial)
            return None

    @staticmethod
    def _perturbed(
        state: _TuneState, dim: str, base: Any, desc: Dict[str, Any]
    ) -> Optional[Any]:
        if desc.get("kind") == "toggle":
            return not bool(base)
        # Geometric step (double/halve), quantized and clamped to the
        # env bounds — the same granularity the heuristics move in.
        direction = state.direction.get(dim, 1)
        quantum = int(desc.get("quantum", 1))
        lo = int(desc.get("lo", quantum))
        hi = int(desc.get("hi", 1 << 62))
        for _ in range(2):  # one direction flip if clamped into place
            raw = base * 2 if direction > 0 else base / 2
            value = max(quantum, (int(raw) // quantum) * quantum)
            value = min(max(value, lo), hi)
            if value != base:
                state.direction[dim] = direction
                return value
            direction = -direction
        return None

    def abort_trial(self, op: str, plugin: str) -> bool:
        """Discard an armed trial without scoring it (unattributed take,
        binding flipped mid-experiment). The incumbent stays."""
        with self._lock:
            trial = self._trial
            if trial is not None and trial["op"] == op and trial["plugin"] == plugin:
                self._trial = None
                return True
            return False

    def active_trial(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._trial) if self._trial is not None else None

    # ------------------------------------------------------------ feedback

    def observe(
        self,
        op: str,
        plugin: str,
        binding: str,
        gbps: float,
        learn: bool = True,
        arm: bool = True,
    ) -> Dict[str, Any]:
        """Score one committed operation's verdict.

        Returns what happened — ``{"key", "verdict", "score", ...}`` —
        for the governor to record/persist. ``learn=False`` (pin mode)
        only refreshes the binding memory so profile keys keep
        resolving. ``arm=False`` (the governor passes the verdict's
        class: op NOT storage-bound) scores but never unlocks the next
        trial — perturbing storage knobs cannot improve an op the
        pipeline is gating, and a stage-bound save's throughput says
        nothing about the storage dimension a trial would probe."""
        with self._lock:
            self._binding[(plugin, op)] = binding
            key = profile_key(plugin, self._world, binding)
            if not learn:
                return {"key": key, "verdict": "pinned", "gbps": gbps}
            state = self._states.setdefault(key, _TuneState())
            state.takes += 1
            trial = self._trial
            result: Dict[str, Any] = {
                "key": key,
                "plugin": plugin,
                "op": op,
                "binding": binding,
                "gbps": round(gbps, 4),
                "takes": state.takes,
            }
            if trial is not None and trial["op"] == op and trial["plugin"] == plugin:
                self._trial = None
                if trial["key"] != key:
                    # The binding flipped under the experiment: the
                    # verdict scores a different profile than the trial
                    # perturbed — inconclusive, incumbent stays.
                    result["verdict"] = "aborted"
                    result["trial"] = {"dim": trial["dim"], "to": trial["value"]}
                else:
                    incumbent = state.score if state.score is not None else gbps
                    state.fresh = False  # next baseline must re-measure
                    if gbps > incumbent * (1.0 + HYSTERESIS):
                        state.settings[trial["dim"]] = trial["value"]
                        verdict = "kept"
                        state.score = incumbent + SCORE_ALPHA * (gbps - incumbent)
                        # The score was just refreshed by a measurement
                        # AT the adopted settings — still a valid
                        # baseline, so consecutive keeps chain take-to-
                        # take (fast climb out of a bad region) while
                        # reverted/neutral trials force a clean
                        # re-baseline first.
                        state.fresh = arm
                    elif gbps < incumbent * (1.0 - HYSTERESIS):
                        # Clearly worse: revert (settings were never
                        # mutated while the trial was armed — reverting
                        # is simply NOT adopting), flip the climb
                        # direction, and do NOT fold the degraded rate
                        # into the incumbent's score — the rejected
                        # value produced it.
                        state.direction[trial["dim"]] = -state.direction.get(
                            trial["dim"], 1
                        )
                        verdict = "reverted"
                    else:
                        # Within the noise band: keep the incumbent (no
                        # flip-flop), but let the rate refresh the score.
                        verdict = "neutral"
                        state.score = incumbent + SCORE_ALPHA * (gbps - incumbent)
                    result["verdict"] = verdict
                    result["trial"] = {
                        "dim": trial["dim"],
                        "from": trial["base"],
                        "to": trial["value"],
                        "verdict": verdict,
                        "gbps": round(gbps, 4),
                        "incumbent_gbps": round(incumbent, 4),
                    }
                    state.trials.append(result["trial"])
                    del state.trials[:-MAX_TRIAL_HISTORY]
            else:
                # Clean (untrialed) take at the incumbent settings:
                # baseline/refresh the score and unlock the next trial
                # (storage-bound verdicts only — see ``arm``).
                state.score = (
                    gbps
                    if state.score is None
                    else state.score + SCORE_ALPHA * (gbps - state.score)
                )
                state.fresh = arm
                result["verdict"] = "scored"
            result["score"] = round(state.score, 4) if state.score is not None else None
            result["settings"] = dict(state.settings)
            return result

    # --------------------------------------------------------- persistence

    def profile_record(self, key: str) -> Optional[Dict[str, Any]]:
        """The journal form of one profile — a ``type="profile"`` line
        for the per-root history journal. Deliberately carries NO
        ``wall_s`` field, so ``history.load_history`` (the trend/
        regression reader) never sees profile records."""
        with self._lock:
            state = self._states.get(key)
            if state is None:
                return None
            plugin, world, binding = key.split("|", 2)
            return {
                "type": "profile",
                "ts": round(time.time(), 3),
                "plugin": plugin,
                "world_size": int(world.lstrip("w") or 1),
                "binding": binding,
                "settings": dict(state.settings),
                "score_gbps": round(state.score, 4)
                if state.score is not None
                else None,
                "takes": state.takes,
                "trials": list(state.trials),
            }

    def load(self, records: List[Dict[str, Any]]) -> int:
        """Warm-start from persisted profile records (newest last; the
        last record per key wins). Records with no binding category are
        skipped — a bus-off take must not poison learning with a None
        key. Returns the number of profiles adopted."""
        loaded = 0
        for rec in records:
            if not isinstance(rec, dict) or rec.get("type") != "profile":
                continue
            plugin = rec.get("plugin")
            binding = rec.get("binding")
            if not plugin or not binding or not isinstance(binding, str):
                continue
            try:
                world = int(rec.get("world_size") or 1)
            except (TypeError, ValueError):
                continue
            settings = rec.get("settings")
            if not isinstance(settings, dict):
                continue
            key = profile_key(plugin, world, binding)
            with self._lock:
                state = self._states.setdefault(key, _TuneState())
                state.settings.update(settings)
                score = rec.get("score_gbps")
                if isinstance(score, (int, float)):
                    state.score = float(score)
                try:
                    state.takes = max(state.takes, int(rec.get("takes") or 0))
                except (TypeError, ValueError):
                    pass
                trials = rec.get("trials")
                if isinstance(trials, list):
                    state.trials = trials[-MAX_TRIAL_HISTORY:]
                # Re-seed the binding memory so the first op of the new
                # process resolves its profile key without waiting for
                # a verdict. Binding categories are direction-specific
                # (…_write vs …_read / pipeline categories tagged by the
                # op that produced them), so map through the record's op
                # direction when present, else infer from the category.
                op = rec.get("op")
                if op not in ("write", "read"):
                    op = "read" if "read" in binding else "write"
                self._binding.setdefault((plugin, op), binding)
            loaded += 1
        return loaded

    def profiles(self) -> Dict[str, Dict[str, Any]]:
        """Snapshot of every profile's convergence state (explain/
        introspection)."""
        with self._lock:
            return {
                key: {
                    "settings": dict(state.settings),
                    "score_gbps": round(state.score, 4)
                    if state.score is not None
                    else None,
                    "takes": state.takes,
                    "trials": list(state.trials),
                }
                for key, state in self._states.items()
            }
