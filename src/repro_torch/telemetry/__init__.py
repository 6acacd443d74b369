"""Observability of the sim stack (port of ``repro/telemetry``'s
``metrics.py`` and ``trace.py``): the metrics registry and the fabric
flight recorder.  Zero-cost when disabled: the ambient registry defaults
to a no-op singleton and no recorder is installed."""

from .metrics import (NULL_METRICS, MetricsRegistry, NullRegistry,
                      collecting, get_metrics)
from .trace import (LinkSeriesPolicy, TraceRecorder, get_recorder,
                    recording, validate_trace)

__all__ = ["MetricsRegistry", "NullRegistry", "NULL_METRICS", "get_metrics",
           "collecting",
           "LinkSeriesPolicy", "TraceRecorder", "get_recorder", "recording",
           "validate_trace"]
