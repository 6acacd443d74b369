"""Counters, gauges and timers of the sim stack (port of
``repro/telemetry/metrics.py``; no-ops unless something collects).

A :class:`MetricsRegistry` is a plain dict-backed sink: engine walks and
incidence-cache hits (:mod:`repro_torch.core.routing_vec` /
:mod:`repro_torch.core.routing_graph`) and event-loop runs, flows,
epochs and wall time (:mod:`repro_torch.sim.events`).

Two attachment points:

* **per-object**: both routing engines own a registry
  (``router.metrics``);
* **ambient**: :func:`get_metrics` returns the process-wide registry,
  which defaults to the no-op :class:`NullRegistry` singleton, so code
  instruments unconditionally and pays a ``pass`` per event when nothing
  collects.

Enable collection with :func:`collecting`::

    with collecting() as mx:
        simulate_demands(router, dem, 200e-6)
    print(mx.snapshot())
"""

from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["MetricsRegistry", "NullRegistry", "NULL_METRICS",
           "get_metrics", "collecting"]


class MetricsRegistry:
    """Named counters, gauges, and wall-time observations.

    * counters — monotonically incremented event counts (:meth:`inc`);
    * gauges — last-write-wins values (:meth:`gauge`);
    * timers — count/total/min/max wall-time stats (:meth:`observe` or
      the :meth:`timer` context manager).

    All methods are cheap dict operations; :meth:`snapshot` returns a
    JSON-ready dict.
    """

    enabled: bool = True

    def __init__(self):
        self._counters: dict = {}
        self._gauges: dict = {}
        self._timers: dict = {}

    # --------------------------------------------------------- counters ----

    def inc(self, name: str, n: "int | float" = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def set_counter(self, name: str, value: "int | float") -> None:
        self._counters[name] = value

    def value(self, name: str) -> "int | float":
        """Current counter value (0 if never incremented)."""
        return self._counters.get(name, 0)

    # ----------------------------------------------------------- gauges ----

    def gauge(self, name: str, value) -> None:
        self._gauges[name] = value

    # ----------------------------------------------------------- timers ----

    def observe(self, name: str, seconds: float) -> None:
        st = self._timers.get(name)
        if st is None:
            st = self._timers[name] = {"count": 0, "total_s": 0.0,
                                       "min_s": float("inf"), "max_s": 0.0}
        st["count"] += 1
        st["total_s"] += seconds
        st["min_s"] = min(st["min_s"], seconds)
        st["max_s"] = max(st["max_s"], seconds)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    # ------------------------------------------------------------- views ----

    def snapshot(self) -> dict:
        """JSON-ready view: ``{"counters": ..., "gauges": ...,
        "timers": ...}`` (timers rounded to stay diff-friendly)."""
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "timers": {k: {"count": v["count"],
                           "total_s": round(v["total_s"], 6),
                           "min_s": round(v["min_s"], 6),
                           "max_s": round(v["max_s"], 6)}
                       for k, v in self._timers.items()},
        }

    def merge(self, other: "MetricsRegistry", prefix: str = "") -> None:
        """Fold ``other``'s counters/gauges/timers into this registry
        (e.g. a router's local registry into the run-wide one)."""
        snap = other.snapshot()
        for k, v in snap["counters"].items():
            self.inc(prefix + k, v)
        for k, v in snap["gauges"].items():
            self.gauge(prefix + k, v)
        for k, st in snap["timers"].items():
            t = self._timers.setdefault(
                prefix + k, {"count": 0, "total_s": 0.0,
                             "min_s": float("inf"), "max_s": 0.0})
            t["count"] += st["count"]
            t["total_s"] += st["total_s"]
            t["min_s"] = min(t["min_s"], st["min_s"])
            t["max_s"] = max(t["max_s"], st["max_s"])


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class NullRegistry(MetricsRegistry):
    """The disabled sink: every method is a no-op, ``enabled`` is False.

    This is the ambient default — instrumented code pays one attribute
    lookup and a ``pass`` per event, and nothing is ever stored.
    """

    enabled = False

    def __init__(self):  # no dicts — nothing is ever stored
        pass

    def inc(self, name, n=1):
        pass

    def set_counter(self, name, value):
        pass

    def value(self, name):
        return 0

    def gauge(self, name, value):
        pass

    def observe(self, name, seconds):
        pass

    def timer(self, name):
        return _NULL_TIMER

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "timers": {}}

    def merge(self, other, prefix=""):
        pass


NULL_METRICS = NullRegistry()

_ambient: MetricsRegistry = NULL_METRICS


def get_metrics() -> MetricsRegistry:
    """The ambient registry (the :class:`NullRegistry` singleton unless a
    :func:`collecting` / ``recording`` scope is active)."""
    return _ambient


@contextmanager
def collecting(registry: "MetricsRegistry | None" = None):
    """Install ``registry`` (default: a fresh one) as the ambient metrics
    sink for the scope; restores the previous sink on exit."""
    global _ambient
    reg = registry if registry is not None else MetricsRegistry()
    prev = _ambient
    _ambient = reg
    try:
        yield reg
    finally:
        _ambient = prev
