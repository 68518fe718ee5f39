"""The flight-recorder event taxonomy: every recordable event, by name.

The flight recorder (flightrec.py) is always on, so its event stream is
an OPERATOR INTERFACE, not debug logging: the timeline merge matches
these names across rank dumps, post-mortem runbooks grep for them, and
tests assert on them. A name invented ad hoc at a call site would be
invisible to all three — so the taxonomy is pinned here, equal to the
JAX package's, and ``tests/test_torch_flightrec.py`` checks that every
``flightrec.record(...)`` literal of the port is registered.

Unlike fault-injection sites, one event name MAY have several call sites
(``collective.enter`` fires from every collective verb); what must be
unique is the meaning, which the registry row documents.

Causal keys: events carry whatever coordination identity the layer has —
``ns``/``cseq`` (the PGWrapper namespace + collective sequence, shared
by all ranks of one collective), ``epoch`` (store leadership), ``gen``
(the commit-fence generation) — so the cross-rank merge can align
timelines without comparable clocks.
"""

from __future__ import annotations

from typing import Dict

EVENTS: Dict[str, str] = {
    # operation lifecycle (snapshot.py)
    "op.begin": "a take/restore began on this rank (op, rank, path)",
    "op.abort": "a take/restore raised (op, error, kind) — triggers a dump",
    "phase": "op phase transition (_PhaseTimer.mark: name, op, dur_s)",
    "progress": "periodic pipeline progress sample (scheduler reporter)",
    # collectives (pg_wrapper.py)
    "collective.enter": "entered a KV-store collective (kind, ns, cseq, deadline_s)",
    "collective.exit": "left a collective (kind, ns, cseq, ok[, error])",
    # coordination store (dist_store.py)
    "store.failover": "client adopted a new store leader (epoch, leader, cause)",
    "store.epoch": "a standby assumed leadership / a leader was deposed (epoch, role)",
    "store.lease": "leader lease renewal round (epoch, replicas)",
    # storage degradation (storage_plugins/)
    "retry.attempt": "transient storage error scheduled for retry (kind, op, attempt)",
    "retry.exhausted": "retry budget exhausted; error propagates (kind, op, attempts)",
    "mirror.failover": "primary-tier read failed over to the mirror (path, kind)",
    # cooperative restore (fanout.py)
    "fanout.fallback": "peer-fed unit degraded to a direct storage read (key, owner)",
    # planned reshard (reshard.py)
    "reshard.plan": "one entry's minimal-movement reshard plan computed "
    "(shards, planned, owned, recv)",
    # commit protocol (snapshot.py)
    "fence.plant": "rank 0 planted the commit fence (gen)",
    "commit.decision": "fenced commit decision (gen, found, ok) — StaleCommitError when not ok",
    # adaptive tuning (scheduler.IOGovernor consumers)
    "governor.elect": "an IOGovernor election was made (site, decision fields, "
    "measured rates at decision time) — recorded wherever the governor "
    "picks streaming on/off, sub-chunk size, I/O concurrency, the "
    "preverify gate, or cooperative restore",
    "governor.learn": "the autotuner scored a committed op's critical-"
    "path verdict against the incumbent profile (key, trial dim, "
    "kept/reverted/neutral verdict, GB/s) — or skipped an unattributed "
    "op (skipped=True, counted as profile_skips)",
    # native I/O engine (native_io.py / io_preparers/array.py)
    "native.degrade": "the native I/O tier degraded (site, cause) — the "
    "capability probe failed at startup or the staging pool fell back to "
    "Python slabs mid-run",
    # cross-cutting
    "fault.trip": "a fault-injection rule fired (site, hit, action)",
    "preempt.signal": "a termination signal was observed (signum)",
    "flight.dump": "ring dump header (rank, reason, events, dropped)",
    # stall forensics (forensics.py)
    "forensic.dump": "the hang watchdog dumped thread stacks (rank, "
    "trigger, reason) — self-triggered or remote-requested",
    # delta journal (journal.py)
    "journal.open": "rank 0 planted a journal epoch fence (gen, epoch)",
    "journal.commit": "a journal epoch committed — metadata published, "
    "fence cleared (gen, epoch, records)",
    "journal.replay": "committed journal epochs replayed onto a restored "
    "base (gen, epochs, records, truncated)",
    # fleet distribution tier (distrib.py)
    "distrib.register": "a chunk this replica now holds was registered "
    "in the seed catalog (digest, nbytes, depth, holder)",
    "distrib.fetch": "a chunk arrived from a seeding peer and verified "
    "its content address (digest, nbytes, parent, depth)",
    "distrib.push": "one committed journal epoch was pushed to a live "
    "replica and acked (gen, epoch, nbytes, target, dup)",
    # tenancy (tenancy/)
    "tenant.admit": "a tenant-scoped op registered in the admission "
    "table and got its bandwidth share (tenant, op, priority, share)",
    "tenant.evict": "quota retention reclaimed a tenant's oldest "
    "step(s) (tenant, evicted, used, quota)",
    # lazy page-in restore (pagein.py)
    "pagein.begin": "a lazy restore returned with its hot set resident "
    "and handed the tail to the page-in engine (units, bytes, ttfi_s)",
    "pagein.fault": "a demand fault jumped the prefetch queue for a "
    "deferred leaf (path, state, direct)",
    "pagein.complete": "every deferred leaf landed — the lazy restore "
    "reached eager-equivalent residency (units, faulted, wall_s)",
    # cross-region geo-replication (georep.py)
    "georep.ship": "a base snapshot or epoch blob left the shipper for "
    "the remote tier (kind, step, nbytes, tier, dur_s)",
    "georep.apply": "a shipped epoch was verified and folded onto the "
    "remote tier — or refused (epoch, gen, nbytes, tier, ok)",
    "georep.lag": "the shipper fell behind — a ship cycle failed and the "
    "backlog is aging (tier, backlog_epochs, lag_s, error)",
}

FLIGHT_EVENTS = frozenset(EVENTS)

# ------------------------------------------------------------- histograms
#
# The latency-histogram instrument (core.histogram_observe) is the same
# kind of operator interface the flight-recorder events are: fleet merges
# sum bucket-wise by NAME, the stats/explain renderings and the live
# /metrics exporter expose families by NAME, and dashboards alert on
# them. So the names are pinned here, and check_event_taxonomy.py
# enforces that every ``histogram_observe(...)`` call in the package uses
# a registered literal and that every registered name is wired somewhere.
# The optional ``key`` argument (storage-plugin class, collective verb)
# becomes a label and is free-form; the FAMILY name is not.

HISTOGRAM_NAMES: Dict[str, str] = {
    "write.sub_chunk_s": "per-sub-chunk stage+write handoff latency on a "
    "streamed write (scheduler; key = storage plugin)",
    "read.sub_chunk_s": "per-sub-chunk delivery latency on a streamed or "
    "peer-fed read (scheduler; key = storage plugin or 'peer')",
    "write.entry_s": "buffered per-entry storage write latency "
    "(scheduler; key = storage plugin)",
    "read.entry_s": "buffered per-entry storage read latency "
    "(scheduler; key = storage plugin)",
    "storage.op_s": "per-storage-operation latency in the cloud retry "
    "tier (retry/_retrying; key = '<Plugin>.<op>')",
    "collective.wait_s": "wall time inside one KV-store collective "
    "(pg_wrapper; key = collective verb)",
}

HISTOGRAMS = frozenset(HISTOGRAM_NAMES)
