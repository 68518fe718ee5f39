"""Live OpenMetrics exporter: a stdlib-only HTTP endpoint Prometheus can
scrape while a take/restore is IN FLIGHT (the port's copy of
``torchsnapshot_tpu/telemetry/promexp.py``; its families are the JAX
package's).

``export.render_openmetrics`` exposes a finished take's persisted
summary; this module is the live complement — the same exposition format served
from the process's CURRENT telemetry state: counters, gauges, the
latency histograms, and the health-plane heartbeat fields (phase, bytes,
binding resource), so a dashboard shows a fleet mid-save instead of only
post-hoc summaries.

Off by default. ``TORCHSNAPSHOT_GPU_METRICS_PORT=<port>`` arms it: the
first operation to begin (Snapshot.take/async_take/restore call
:func:`maybe_start`) binds the port and serves ``GET /metrics`` from a
daemon thread for the life of the process. Port ``0`` binds an ephemeral
port (tests; :attr:`MetricsExporter.port` reports the real one).

Design rules:

- **Stdlib only** (``http.server``): the exporter must not add a
  dependency, and must import cleanly in hermetic containers.
- **Read-only and lock-light.** A scrape snapshots the bus under its
  existing lock (the same ``counters()``/``gauges()``/``histograms()``
  surface every consumer uses) — it can never block the pipeline beyond
  one dict copy.
- **One formatter.** Histogram families render through
  ``export.om_histogram_lines`` — the exact code path
  ``export.render_openmetrics`` uses — so the live and post-hoc expositions cannot
  drift apart.
- **Never fails the op.** ``maybe_start`` swallows bind errors with a
  log line: a port collision must not take down a training job.
"""

from __future__ import annotations

import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from . import core, health
from .export import (
    _om_label_str,
    om_family_name,
    om_histogram_lines,
)

logger = logging.getLogger(__name__)

METRICS_PORT_ENV_VAR = "TORCHSNAPSHOT_GPU_METRICS_PORT"

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: Heartbeat fields exported as numeric gauges (the rest — op, phase,
#: binding — are strings and ride the info-style sample's labels).
_HEARTBEAT_NUMERIC = (
    "step",
    "total_entries",
    "done_entries",
    "inflight_io",
    "staged_bytes",
    "written_bytes",
    "read_bytes",
    "total_bytes",
    "georep_lag_s",
    "georep_backlog",
)


def render_live(rank: Optional[int] = None) -> str:
    """The current process's telemetry state as one OpenMetrics
    exposition: counter/gauge/histogram families from the bus plus the
    health-plane heartbeat state. Valid (ends in ``# EOF``) even with
    the bus disabled and empty — a scrape between ops is normal."""
    labels: Dict[str, Any] = {}
    if rank is not None:
        labels["rank"] = rank
    lines = []
    for name, value in sorted(core.counters().items()):
        family = om_family_name(name)
        lines.append(f"# TYPE {family} counter")
        lines.append(f"{family}_total{_om_label_str(labels)} {value:g}")
    for name, value in sorted(core.gauges().items()):
        family = om_family_name(name)
        lines.append(f"# TYPE {family} gauge")
        lines.append(f"{family}{_om_label_str(labels)} {value:g}")
    for name, by_key in sorted(core.histograms().items()):
        lines.extend(om_histogram_lines(name, by_key, extra_labels=labels))
    state = health.current_state()
    if state:
        info_labels = dict(labels)
        for key in ("op", "phase", "binding"):
            if state.get(key) is not None:
                info_labels[key] = state[key]
        family = om_family_name("heartbeat")
        lines.append(f"# TYPE {family} gauge")
        lines.append(f"{family}{_om_label_str(info_labels)} 1")
        for key in _HEARTBEAT_NUMERIC:
            value = state.get(key)
            if isinstance(value, (int, float)):
                family = om_family_name(f"heartbeat_{key}")
                lines.append(f"# TYPE {family} gauge")
                lines.append(f"{family}{_om_label_str(labels)} {value:g}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "torchsnapshot-tpu-torch-metrics"

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = render_live(rank=self.server._tsnap_rank).encode("utf-8")
        except Exception:  # noqa: BLE001 - a scrape must never crash
            logger.exception("metrics render failed")
            self.send_error(500)
            return
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("metrics scrape: " + fmt, *args)


class MetricsExporter:
    """A running /metrics endpoint. Created via :func:`start_exporter`
    (or :func:`maybe_start` from the env gate); ``port`` is the bound
    port (meaningful with an ephemeral port request), ``stop()`` shuts
    the server down (tests — production exporters live as long as the
    process)."""

    def __init__(self, port: int, rank: Optional[int] = None) -> None:
        self._server = ThreadingHTTPServer(("", port), _Handler)
        self._server.daemon_threads = True
        self._server._tsnap_rank = rank
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="tsnap-metrics",
            daemon=True,
        )
        self._thread.start()

    def set_rank(self, rank: Optional[int]) -> None:
        self._server._tsnap_rank = rank

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001
            pass
        self._thread.join(timeout=5.0)


_exporter: Optional[MetricsExporter] = None
_exporter_lock = threading.Lock()


def start_exporter(port: int, rank: Optional[int] = None) -> MetricsExporter:
    """Start (or return the already-running) exporter. Raises OSError on
    a bind failure — callers that must not fail go through
    :func:`maybe_start`."""
    global _exporter
    with _exporter_lock:
        if _exporter is None:
            _exporter = MetricsExporter(port, rank=rank)
            logger.info(
                "live metrics exporter serving on :%d/metrics", _exporter.port
            )
        elif rank is not None:
            _exporter.set_rank(rank)
        return _exporter


def active_exporter() -> Optional[MetricsExporter]:
    return _exporter


def stop_exporter() -> None:
    """Tear the exporter down (tests)."""
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            _exporter.stop()
            _exporter = None


def maybe_start(rank: Optional[int] = None) -> Optional[MetricsExporter]:
    """Env-gated idempotent start, called at op begin: no env var (the
    default) means no listener, no thread, no port; a malformed value or
    bind failure logs and returns None — observability never fails the
    operation."""
    raw = os.environ.get(METRICS_PORT_ENV_VAR, "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", METRICS_PORT_ENV_VAR, raw)
        return None
    if port < 0:
        return None
    try:
        return start_exporter(port, rank=rank)
    except OSError:
        logger.exception(
            "live metrics exporter failed to bind port %d (continuing)", port
        )
        return None
