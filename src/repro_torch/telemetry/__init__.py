"""Unified telemetry: span timelines, metrics registry, drift monitors.

The counterpart of ``repro.telemetry``, copied (the port imports nothing
of the JAX package): a pure-stdlib package threaded through comm / program
/ planner / serving.

* :mod:`repro_torch.telemetry.spans` -- nested span timelines with Chrome-trace
  (Perfetto) and plain-text exports; ingests live CommEvents.
* :mod:`repro_torch.telemetry.metrics` -- counters / gauges / fixed-bucket
  histograms with JSON-lines and Prometheus text exports; default-off
  module helpers plus per-component registries.
* :mod:`repro_torch.telemetry.drift` -- rolling meas_over_est residuals per
  (flow, stage, domain) with structured profile-staleness warnings.
"""
from repro_torch.telemetry.drift import (DEFAULT_BAND, DriftMonitor,
                                   ProfileStalenessWarning, active_monitor,
                                   install_monitor)
from repro_torch.telemetry.metrics import (DECLARED, REGISTRY, MetricsRegistry,
                                     active_registry, inc, observe,
                                     scoped_metrics, set_gauge)
from repro_torch.telemetry.metrics import disable as disable_metrics
from repro_torch.telemetry.metrics import enable as enable_metrics
from repro_torch.telemetry.metrics import enabled as metrics_enabled
from repro_torch.telemetry.spans import (Tracer, current_tracer, maybe_instant,
                                   maybe_span)

__all__ = [
    "DECLARED", "DEFAULT_BAND", "DriftMonitor", "MetricsRegistry",
    "ProfileStalenessWarning", "REGISTRY", "Tracer", "active_monitor",
    "active_registry", "current_tracer", "disable_metrics",
    "enable_metrics", "inc", "install_monitor", "maybe_instant",
    "maybe_span", "metrics_enabled", "observe", "scoped_metrics",
    "set_gauge",
]
