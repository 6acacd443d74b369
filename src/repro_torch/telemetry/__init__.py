"""Observability of the sim stack: the metrics registry (port of
``repro/telemetry/metrics.py``).  Zero-cost when disabled: the ambient
registry defaults to a no-op singleton."""

from .metrics import (NULL_METRICS, MetricsRegistry, NullRegistry,
                      collecting, get_metrics)

__all__ = ["MetricsRegistry", "NullRegistry", "NULL_METRICS", "get_metrics",
           "collecting"]
