"""Fabric flight recorder: spans, counters and Perfetto export (port of
``repro/telemetry/trace.py``).

A :class:`TraceRecorder` journals what the simulated fabric did over
time:

* per-epoch event-loop state (epoch clock, active-flow count, the
  utilization of a selected link subset), journaled by
  :func:`repro_torch.sim.events.simulate_incidence` into rows on the
  simulation's device and copied to the host once a simulation;
* per-flow start/finish spans (budgeted, see below).

Everything exports as Chrome/Perfetto ``trace_event`` JSON
(:meth:`TraceRecorder.export`): open the file at https://ui.perfetto.dev
or ``chrome://tracing``.  Simulated time maps to trace time (1 simulated
second = 1e6 trace microseconds).

Scale is bounded by policy, never silently: a 65K-NIC run journals only
the :class:`LinkSeriesPolicy` link subset (top-K by expected load plus a
seeded reservoir of the other used links), at most ``max_epochs``
journal rows and at most ``max_flow_events`` flow spans; whatever is
dropped is counted in the recorder's metrics
(``trace.dropped_epochs`` / ``trace.dropped_flow_events``).

Enable with :func:`recording`, which also installs the recorder's
:class:`~repro_torch.telemetry.metrics.MetricsRegistry` as the ambient
sink::

    with recording() as rec:
        simulate_demands(router, dem, 200e-6)
    rec.export("sim_trace.json")
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_sim_backend
from .metrics import MetricsRegistry, collecting

__all__ = ["LinkSeriesPolicy", "TraceRecorder", "get_recorder",
           "recording", "validate_trace"]

_US = 1e6   # simulated seconds -> trace_event microseconds


@dataclass(frozen=True)
class LinkSeriesPolicy:
    """Which links get a per-epoch utilization series, and how long.

    ``top_k`` links by expected load (the incidence at the demand-cap
    rates; load first, then id) plus a ``reservoir`` drawn without
    replacement (seeded) from the other *used* links, so a 65K-NIC
    fabric journals a fixed-width series instead of ~72K columns.
    ``max_epochs`` caps the journal rows of one simulation; the rest are
    counted (``trace.dropped_epochs``).
    """

    top_k: int = 16
    reservoir: int = 8
    seed: int = 0
    max_epochs: int = 4096

    def select(self, inc, rate_caps_gbps,
               backend: "str | None" = None) -> np.ndarray:
        """(K',) sorted global edge ids to journal for one incidence
        (K' <= top_k + reservoir; only used edges qualify).

        The expected loads are summed on the incidence's device with the
        solver ``backend`` and copied to the host once; the ranking and
        the reservoir draw are the reference's numpy code.  Each edge
        adds its entries one by one in entry order from +0.0 (on the
        card at one lane a segment), the bits of the reference's
        ``np.add.at``, so equal loads tie, and rank by id, as in the
        reference on every device and backend."""
        from ..core.routing_vec import ordered_sum

        caps = torch.as_tensor(rate_caps_gbps, dtype=torch.float64,
                               device=inc.device).broadcast_to(
                                   (inc.n_flows,))
        plan = dataclasses.replace(inc.edge_plan(), lanes=1) \
            if inc.device.type == "cuda" else None
        load = ordered_sum(caps[inc.flow] * inc.frac, inc.edge, inc.n_edges,
                           resolve_sim_backend(backend), plan).cpu().numpy()
        used = np.flatnonzero(load > 0)
        if used.size == 0:
            return used
        order = used[np.lexsort((used, -load[used]))]
        top = order[:self.top_k]
        rest = np.setdiff1d(used, top, assume_unique=False)
        if rest.size and self.reservoir > 0:
            rng = np.random.default_rng(self.seed)
            res = rng.choice(rest, size=min(self.reservoir, rest.size),
                             replace=False)
            top = np.concatenate([top, res])
        return np.sort(top)


class TraceRecorder:
    """Collects trace events and metrics; exports Perfetto JSON.

    Tracks are named ``(process, thread)`` pairs mapped to stable
    ``(pid, tid)`` ids with ``process_name`` / ``thread_name`` metadata.
    """

    def __init__(self, link_policy: "LinkSeriesPolicy | None" =
                 LinkSeriesPolicy(),
                 max_flow_events: int = 256):
        self.metrics = MetricsRegistry()
        self.link_policy = link_policy
        self.max_flow_events = max_flow_events
        self.events: "list[dict]" = []
        self.journals: "list[dict]" = []
        self.notes: "list[dict]" = []
        self._procs: dict = {}
        self._threads: dict = {}
        self._meta: "list[dict]" = []
        self._flow_budget = max_flow_events
        self._wall0 = time.perf_counter()

    # ------------------------------------------------------------ tracks ----

    def track(self, process: str = "sim", thread: str = "main"
              ) -> "tuple[int, int]":
        """(pid, tid) of a named track, registering its display metadata
        on first use."""
        pid = self._procs.get(process)
        if pid is None:
            pid = self._procs[process] = len(self._procs) + 1
            self._meta.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": process}})
        tid = self._threads.get((pid, thread))
        if tid is None:
            tid = self._threads[(pid, thread)] = \
                len([1 for (p, _) in self._threads if p == pid]) + 1
            self._meta.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": thread}})
        return pid, tid

    # ------------------------------------------------------------ events ----

    @property
    def n_events(self) -> int:
        return len(self.events)

    def span(self, name: str, start_s: float, dur_s: float,
             process: str = "sim", thread: str = "main",
             cat: str = "sim", args: "dict | None" = None) -> None:
        """A complete ("X") span on the simulated-time clock."""
        pid, tid = self.track(process, thread)
        ev = {"name": name, "ph": "X", "cat": cat,
              "ts": float(start_s) * _US, "dur": float(dur_s) * _US,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, ts_s: float, process: str = "sim",
                thread: str = "main", cat: str = "sim",
                args: "dict | None" = None) -> None:
        pid, tid = self.track(process, thread)
        ev = {"name": name, "ph": "i", "cat": cat, "s": "t",
              "ts": float(ts_s) * _US, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts_s: float, values: dict,
                process: str = "sim", cat: str = "sim") -> None:
        """A counter ("C") sample; ``values`` maps series name -> value."""
        pid, _ = self.track(process, "main")
        self.events.append({"name": name, "ph": "C", "cat": cat,
                            "ts": float(ts_s) * _US, "pid": pid,
                            "args": {k: float(v)
                                     for k, v in values.items()}})

    @contextmanager
    def wall_span(self, name: str, process: str = "wall",
                  thread: str = "main", cat: str = "wall",
                  args: "dict | None" = None):
        """A span on the host wall clock (relative to the recorder's
        start), for solver wall time rather than simulated time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.span(name, t0 - self._wall0, t1 - t0, process=process,
                      thread=thread, cat=cat, args=args)

    def note_skip(self, name: str, reason: str) -> None:
        """Explicit record that a suite path produced no trace."""
        self.notes.append({"name": name, "traced": False,
                           "reason": reason})

    # ------------------------------------------------- sim-layer hooks ----

    def record_flow_sim(self, res, label: str = "flows") -> None:
        """Per-flow transfer spans of a
        :class:`~repro_torch.sim.events.FlowSimResult` (budgeted to
        ``max_flow_events`` in all, longest transfers first).  Its
        start, finish and size tensors are copied to the host once."""
        start, finish, size = (t.cpu().numpy() for t in (
            res.start_s, res.finish_s, res.size_bytes))
        done = np.flatnonzero(np.isfinite(finish))
        take = done
        if take.size > self._flow_budget:
            transfer = finish[done] - start[done]
            keep = np.argsort(-transfer, kind="stable")[:self._flow_budget]
            take = np.sort(done[keep])
            self.metrics.inc("trace.dropped_flow_events",
                             int(done.size - take.size))
        self._flow_budget -= int(take.size)
        tags = getattr(res, "tags", None)
        for f in take.tolist():
            args = {"bytes": float(size[f])}
            if tags is not None and tags[f] is not None:
                args["tag"] = str(tags[f])
            self.span(f"flow[{f}]", float(start[f]),
                      float(finish[f] - start[f]),
                      process="sim", thread=label, cat="flow",
                      args=args)
        stalled = int(finish.size - done.size)
        if stalled:
            self.metrics.inc("sim.stalled_flows", stalled)

    def record_epoch_journal(self, t_s, dt_s, active, edge_ids, util,
                             label: str = "epochs",
                             dropped: int = 0) -> None:
        """Per-epoch journal rows (host arrays): epoch clock, step,
        active-flow count, per-selected-link utilization.  Stored raw in
        :attr:`journals` and emitted as counter samples."""
        t_s = np.asarray(t_s, dtype=np.float64)
        self.journals.append({
            "label": label,
            "t_s": t_s.tolist(),
            "dt_s": np.asarray(dt_s, dtype=np.float64).tolist(),
            "active_flows": np.asarray(active).astype(int).tolist(),
            "edge_ids": np.asarray(edge_ids).astype(int).tolist(),
            "util": np.asarray(util, dtype=np.float64).tolist(),
            "dropped_epochs": int(dropped),
        })
        if dropped:
            self.metrics.inc("trace.dropped_epochs", int(dropped))
        ids = [f"e{int(e)}" for e in np.asarray(edge_ids).tolist()]
        for i in range(t_s.shape[0]):
            self.counter("active_flows", float(t_s[i]),
                         {label: int(np.asarray(active)[i])})
            if ids:
                self.counter("link_util", float(t_s[i]),
                             dict(zip(ids, np.asarray(util)[i])))

    # ------------------------------------------------------------ export ----

    def to_json(self) -> dict:
        """The Perfetto ``trace_event`` payload (JSON object format)."""
        return {
            "traceEvents": self._meta + self.events,
            "displayTimeUnit": "ms",
            "otherData": {
                "generated_by": "repro_torch.telemetry",
                "clock": "1 simulated second = 1e6 trace us "
                         "(wall tracks use host wall clock)",
                "skipped": self.notes,
                "metrics": self.metrics.snapshot(),
            },
        }

    def export(self, path: "str | None" = None) -> dict:
        payload = self.to_json()
        if path is not None:
            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
                f.write("\n")
        return payload


def validate_trace(payload: dict) -> "list[str]":
    """Schema-check a ``trace_event`` payload; returns the problems
    (empty = valid).  Covers the phases this module emits (M/X/i/C)."""
    problems = []
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    required = {"M": ("name", "ph", "pid", "args"),
                "X": ("name", "ph", "ts", "dur", "pid", "tid"),
                "i": ("name", "ph", "ts", "pid", "tid", "s"),
                "C": ("name", "ph", "ts", "pid", "args")}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in required:
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        for key in required[ph]:
            if key not in ev:
                problems.append(f"event {i} (ph={ph}): missing {key!r}")
        for key in ("ts", "dur"):
            if key in ev and (not isinstance(ev[key], (int, float))
                              or ev[key] < 0):
                problems.append(f"event {i}: bad {key}={ev[key]!r}")
    return problems


_recorder: "TraceRecorder | None" = None


def get_recorder() -> "TraceRecorder | None":
    """The ambient recorder (None unless a :func:`recording` scope is
    active): the sim layer consults it, so tracing changes no
    signature."""
    return _recorder


@contextmanager
def recording(recorder: "TraceRecorder | None" = None):
    """Install ``recorder`` (default: a fresh one) as the ambient flight
    recorder and its metrics registry as the ambient metrics sink."""
    global _recorder
    rec = recorder if recorder is not None else TraceRecorder()
    prev = _recorder
    _recorder = rec
    try:
        with collecting(rec.metrics):
            yield rec
    finally:
        _recorder = prev
