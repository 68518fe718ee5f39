"""Checkpoint telemetry of the port: the event bus, the flight recorder,
the exports, the cross-rank merge and the heartbeats.

Counterpart of ``torchsnapshot_tpu/telemetry`` (its core: ``core.py``,
``taxonomy.py``, ``flightrec.py``, ``export.py``, ``aggregate.py`` and
``health.py``), a copy under the port's env prefix. Enable the bus with
``TORCHSNAPSHOT_GPU_TELEMETRY=1``; the flight recorder is on unless
``TORCHSNAPSHOT_GPU_FLIGHTREC=0``. The attribution, forensics, history
and ``/metrics`` planes (``critpath``, ``forensics``, ``history``,
``promexp``) are not ported yet.

Typical programmatic use::

    from torchsnapshot_tpu_torch import telemetry
    telemetry.set_enabled(True)
    Snapshot.take(path, app_state)
    summary = telemetry.last_summary()       # plain dict
    telemetry.write_chrome_trace("take.json")  # load in Perfetto
"""

from .core import (  # noqa: F401
    HISTOGRAM_BOUNDS,
    TELEMETRY_ENV_VAR,
    OpRecorder,
    Span,
    annotate_next_op,
    begin_op,
    counter_add,
    counters,
    dropped_events,
    enabled,
    event,
    events,
    gauge_set,
    gauges,
    histogram_observe,
    histogram_quantile,
    histograms,
    last_fleet,
    last_summary,
    monotonic,
    record_rate,
    refresh_from_env,
    register_rate_listener,
    reset,
    set_enabled,
    set_last_fleet,
    span,
)
from .export import (  # noqa: F401
    TELEMETRY_SUMMARY_FNAME,
    TRACE_DIR,
    build_summary_document,
    chrome_trace,
    chrome_trace_json,
    fmt_bytes,
    render_openmetrics,
    render_summary_document,
    trace_path_for_rank,
    write_chrome_trace,
)
from .aggregate import merge_histograms, merge_summaries  # noqa: F401

# The always-on planes: the flight recorder (bounded ring, abort dumps,
# the blackbox merge; its event registry is ``taxonomy``) and the
# heartbeats over the coordination store. Namespaced, as the pipeline
# calls them (flightrec.record, health.update, ...).
from . import flightrec, health, taxonomy  # noqa: F401, E402


def record_election(**fields) -> None:
    """Record one I/O governor election on both planes: the flight
    recorder (``governor.elect``) and, with the bus on, a
    ``cat="governor"`` instant that the op's summary folds into
    ``summary["governor"]``."""
    flightrec.record("governor.elect", **fields)
    event("governor_elect", cat="governor", **fields)
