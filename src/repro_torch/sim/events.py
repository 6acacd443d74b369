"""Event-driven flow-level simulation loop (port of
``repro/sim/events.py``).

Finite flows start, share the fabric max-min fairly and complete; the
loop advances time between start and completion events and re-solves
the fair shares every epoch (:func:`repro_torch.sim.fairshare.waterfill`).
The epochs are those of the reference's jitted loop: ``eps = 1e-9``
completion threshold, the ``4F + 8`` epoch bound, arrival batching at
``start <= t * (1 + 1e-12) + 1e-18``, a ``dt = 0`` epoch that stalls
flows whose fair share is 0, and per-flow ``start_s`` offsets.

Sizes are bytes, rates Gbps, times seconds.  A flow's FCT is its
transfer time plus the path alpha term
``t_nic + sw_hops * t_switch + (sw_hops + 2) * t_prop``.

Flows may carry opaque tags (:class:`FlowSpec`), which ride into the
results (``FlowSimResult.tags``, ``simulate_demands``'s ``per_tag``
row).  :func:`simulate_flows` and :func:`simulate_flow_batches` run
:class:`FlowSpec` lists, the latter through the router's pair-level
incidence cache.  Each run adds to the ambient metrics
(:func:`repro_torch.telemetry.get_metrics`): ``sim.runs``,
``sim.flows``, ``sim.epochs`` and the ``sim.wall_s`` timer.

Under a flight recorder (:func:`repro_torch.telemetry.recording`) each
simulation journals one row per epoch (:class:`_Journal`) and its
per-flow transfer spans, as the reference's numpy loop does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device, resolve_sim_backend
from ..core.netsim import DEFAULT_NET, NetParams, gbps_to_Bps
from ..core.routing_vec import DemandArrays
from ..kernels.segment_fairshare import make_plan
from ..telemetry import get_metrics, get_recorder
from .fairshare import (FlowIncidence, SolveProblem, _seg_sum,
                        _waterfill_scale, flow_incidence, waterfill)

F64 = torch.float64


@dataclass(frozen=True)
class FlowSpec:
    """One finite flow: ``size_bytes`` from switch ``src`` to ``dst``.
    ``tag`` is an opaque attribution handle (a tenant id, a ``(tenant,
    request)`` tuple) carried into the per-flow results; it does not
    change the simulation."""

    src: int
    dst: int
    size_bytes: float
    start_s: float = 0.0
    tag: object = None


def flows_to_demands(flows: "list[FlowSpec]", device=None) -> DemandArrays:
    """The (src, dst) rows of ``flows`` as a demand matrix on ``device``
    (default ``cuda``), 1 Gbps each."""
    dev = resolve_device(device)
    return DemandArrays(
        torch.tensor([f.src for f in flows], dtype=torch.int64, device=dev),
        torch.tensor([f.dst for f in flows], dtype=torch.int64, device=dev),
        torch.ones(len(flows), dtype=F64, device=dev))


@dataclass
class FlowSimResult:
    """Per-flow outcome of one fabric simulation (tensors on the
    simulation's device)."""

    start_s: torch.Tensor        # (F,)
    finish_s: torch.Tensor       # (F,) transfer-complete time (inf = stalled)
    fct_s: torch.Tensor          # (F,) finish - start + path alpha term
    latency_s: torch.Tensor      # (F,) the per-flow path alpha term
    size_bytes: torch.Tensor     # (F,)
    edge_bytes: torch.Tensor     # (E,) bytes carried per edge
    incidence: FlowIncidence
    backend: str
    makespan_s: float = 0.0      # last finish (stalled flows excluded)
    n_epochs: int = 0
    waterfill_rounds: int = 0    # water-filling rounds over all epochs
    tags: "np.ndarray | None" = None   # (F,) object: opaque flow tags

    @property
    def stalled(self) -> torch.Tensor:
        return ~torch.isfinite(self.finish_s)

    def tag_mask(self, tag) -> np.ndarray:
        """(F,) bool: the flows whose tag equals ``tag``."""
        if self.tags is None:
            raise ValueError("simulation was run without flow tags")
        return np.array([t == tag for t in self.tags], dtype=bool)

    def flow_records(self) -> "list[dict]":
        """Per-flow records (start, finish, FCT, size, tag, stalled)."""
        n = int(self.size_bytes.shape[0])
        tags = self.tags if self.tags is not None \
            else np.full(n, None, dtype=object)
        start, finish, fct, size = (t.cpu().numpy() for t in (
            self.start_s, self.finish_s, self.fct_s, self.size_bytes))
        return [{"flow": f, "tag": tags[f], "start_s": float(start[f]),
                 "finish_s": float(finish[f]), "fct_s": float(fct[f]),
                 "size_bytes": float(size[f]),
                 "stalled": bool(~np.isfinite(finish[f]))}
                for f in range(n)]

    def transfer_s(self) -> torch.Tensor:
        return self.finish_s - self.start_s

    def fct_percentiles(self, qs=(50, 95, 99)) -> dict:
        """FCT percentiles of the finished flows (numpy's linear
        interpolation, on a host copy)."""
        fct = self.fct_s.cpu().numpy()
        ok = fct[np.isfinite(self.finish_s.cpu().numpy())]
        if ok.size == 0:
            return {f"p{q}": None for q in qs}
        return {f"p{q}": float(np.percentile(ok, q)) for q in qs}

    def slowdown(self, rate_caps_gbps) -> torch.Tensor:
        """(F,) FCT over the uncontended FCT at each flow's own rate cap
        (1.0 = no contention)."""
        caps = torch.as_tensor(rate_caps_gbps, dtype=F64,
                               device=self.fct_s.device
                               ).broadcast_to(self.size_bytes.shape)
        bneck = self.incidence.bottleneck_gbps(self.backend)
        ideal = (self.size_bytes / gbps_to_Bps(torch.minimum(caps, bneck))
                 + self.latency_s)
        return self.fct_s / ideal

    def delivered_gbps(self) -> float:
        """Aggregate delivered injection rate over the makespan."""
        done = np.isfinite(self.finish_s.cpu().numpy())
        total = self.size_bytes.cpu().numpy()[done].sum()
        return float(total * 8 / 1e9 / self.makespan_s) \
            if self.makespan_s > 0 else 0.0


def _normalize_tags(tags, F: int) -> "np.ndarray | None":
    """(F,) object array of opaque flow tags, or None when absent."""
    if tags is None:
        return None
    tag_list = list(tags)
    if len(tag_list) != F:
        raise ValueError(f"expected {F} tags, got {len(tag_list)}")
    out = np.empty(F, dtype=object)
    out[:] = tag_list
    return out


def path_latency(inc: FlowIncidence, net: NetParams = DEFAULT_NET,
                 backend: "str | None" = None) -> torch.Tensor:
    """(F,) per-flow path alpha term from the incidence hop counts
    (+2 access hops, as ``netsim.avg_latency`` counts them)."""
    sw = inc.switch_hops(backend)
    return net.t_nic + sw * net.t_switch + (sw + 2.0) * net.t_prop_per_hop


class _Journal:
    """The epoch journal of one simulation, kept on its device.

    ``sel`` (host, sorted global edge ids) come from the recorder's
    :class:`~repro_torch.telemetry.LinkSeriesPolicy`.  The entries of
    the incidence whose edge is selected form a sub-incidence, kept in
    entry order, with its segment plan built once.  Each epoch the loop
    hands over its clock ``t``, its step ``dt`` and its rates, and
    :meth:`write` fills row ``n`` (the epoch count the loop holds on the
    host, so no host read): ``(t, dt)`` and the active-flow count, and
    one segment sum of ``rates[flow] * frac`` over the selected edges in
    entry order (the reference's ``_journal_util``), divided by the
    capacities, 0 where a capacity is 0.  :meth:`record` copies the rows
    to the host once.  Epochs past ``max_epochs`` are counted, not
    written.
    """

    def __init__(self, inc: FlowIncidence, sel, max_epochs: int,
                 backend: str):
        dev = inc.device
        self.sel, self.backend = sel, backend
        K = self.K = int(sel.size)
        slot = torch.full((inc.n_edges,), -1, dtype=torch.int64,
                          device=dev)
        slot[torch.as_tensor(sel, dtype=torch.int64, device=dev)] = \
            torch.arange(K, device=dev)
        entry_slot = slot[inc.edge]
        keep = torch.nonzero(entry_slot >= 0).squeeze(1)
        self.flow, self.frac = inc.flow[keep], inc.frac[keep]
        self.ids = entry_slot[keep]
        self.plan = make_plan(self.ids, K) \
            if backend == "cuda" and K else None
        # x / inf = 0 for the loads (finite, >= 0): 0 where a capacity is
        # 0, as the reference's where(cap > 0, loads / cap, 0)
        cap = inc.capacity[slot >= 0]
        self.cap = torch.where(cap > 0, cap, torch.inf)
        rows = min(max(0, max_epochs), 4 * inc.n_flows + 8)
        self.clock = torch.zeros((rows, 3), dtype=F64, device=dev)
        self.util = torch.zeros((rows, K), dtype=F64, device=dev)
        self.n_epochs = 0

    def write(self, t, dt, act, rates) -> None:
        """Journal one epoch: clock ``t`` and step ``dt`` (0-d device
        tensors), the active mask ``act`` and the epoch's rates, 0 off
        ``act`` (a flow stalled this epoch had rate 0): the reference's
        rates of the active flows."""
        n = self.n_epochs
        self.n_epochs += 1
        if n >= self.clock.shape[0]:
            return
        row = self.clock[n]
        torch.stack((t, dt), out=row[:2])
        torch.sum(act, 0, dtype=F64, out=row[2])
        if self.K:
            loads = _seg_sum(rates[self.flow] * self.frac, self.ids, self.K,
                             self.backend, self.plan)
            torch.div(loads, self.cap, out=self.util[n])

    def record(self, recorder) -> None:
        n = min(self.n_epochs, self.clock.shape[0])
        rows = torch.cat((self.clock[:n], self.util[:n]), 1).cpu().numpy()
        recorder.record_epoch_journal(
            rows[:, 0], rows[:, 1], rows[:, 2].astype(np.int64), self.sel,
            rows[:, 3:], dropped=self.n_epochs - n)


def _event_loop(prob: SolveProblem, size, caps, start, tol: float,
                journal: "_Journal | None" = None):
    """The epochs of one simulation: ``(finish, used_edge_bytes,
    n_epochs, waterfill_rounds)``; each epoch also goes to ``journal``
    where one is given."""
    F = size.shape[0]
    thresh = 1e-9 * size.clamp_min(1.0)
    t = start.min()
    remaining = size.clone()
    finish = torch.where(size == 0, start, torch.inf)
    stalled = torch.zeros(F, dtype=torch.bool, device=size.device)
    edge_bytes = torch.zeros(prob.n_edges, dtype=F64, device=size.device)
    n_epochs = rounds = 0
    for _ in range(4 * F + 8):
        open_f = (remaining > thresh) & ~stalled
        active = open_f & (start <= t * (1 + 1e-12) + 1e-18)
        pend = open_f & ~active
        has_pending = bool(pend.any())
        pending_min = torch.where(pend, start, torch.inf).min()
        if not bool(active.any()):
            if not has_pending:
                return finish, edge_bytes, n_epochs, rounds
            t = pending_min
            continue
        rates, converged, r = waterfill(prob, caps, active, tol)
        if not converged:
            raise RuntimeError("water-filling failed to converge "
                               f"({F} flows, {prob.n_edges} edges)")
        rounds += r
        rates = torch.where(active, rates, 0.0)
        dead = active & (rates <= 0)
        act = active
        if not has_pending and bool(dead.any()):
            stalled = stalled | dead
            act = active & ~dead
        Bps = rates * (1e9 / 8.0)
        if bool(act.any()):
            per_dt = torch.where(
                act, remaining / Bps.clamp_min(1e-30), torch.inf)
            dt = per_dt.min()
            if has_pending:
                dt = torch.minimum(dt, pending_min - t)
        else:
            # everything active just stalled: the reference's dt = 0 epoch
            dt = torch.zeros((), dtype=F64, device=size.device)
        if journal is not None:
            journal.write(t, dt, act, rates)
        moved = Bps * dt
        remaining = (remaining - moved).clamp_min(0.0)
        t = t + dt
        finish = torch.where(act & (remaining <= thresh), t, finish)
        edge_bytes = edge_bytes + prob.edge_sum(moved[prob.flow] * prob.frac)
        n_epochs += 1
    raise RuntimeError(f"flow sim failed to converge ({F} flows)")


def simulate_incidence(inc: FlowIncidence, size_bytes, rate_caps_gbps,
                       start_s=None, net: NetParams = DEFAULT_NET,
                       backend: "str | None" = None,
                       device=None, tags=None) -> FlowSimResult:
    """Run the event loop over a prebuilt incidence tensor.

    ``size_bytes`` / ``rate_caps_gbps`` / ``start_s`` broadcast to (F,).
    Active flows whose fair share is 0 (every path crosses a
    zero-capacity edge) are marked stalled (``finish_s = inf``).
    ``inc`` is moved to ``device`` (default ``cuda``).  ``tags``
    (length F, opaque) ride into ``FlowSimResult.tags``.

    Under a flight recorder (:func:`repro_torch.telemetry.recording`)
    with a link policy, the loop journals one row per epoch: the clock,
    the step, the active-flow count and the utilization of the policy's
    selected edges (a few small launches an epoch, one segment sum among
    them, and no host read), and the recorder gets the journal once at
    the end; with or without a policy it gets the per-flow transfer
    spans.  With no recorder the
    loop is the unrecorded one, launch for launch, and recording changes
    no output bit.
    """
    backend = resolve_sim_backend(backend)
    dev = resolve_device(device)
    inc = inc.to(dev)
    F = inc.n_flows
    tag_arr = _normalize_tags(tags, F)
    t0_wall = time.perf_counter()

    def vec(x):
        return torch.as_tensor(x, dtype=F64, device=dev).broadcast_to(
            (F,)).clone()

    size, caps = vec(size_bytes), vec(rate_caps_gbps)
    start = torch.zeros(F, dtype=F64, device=dev) if start_s is None \
        else vec(start_s)
    if bool((size < 0).any()) or bool((caps <= 0).any()):
        raise ValueError("sizes must be >= 0 and rate caps > 0")
    prob = SolveProblem.build(inc, backend)
    rec = get_recorder()
    journal = None
    if rec is not None and rec.link_policy is not None:
        pol = rec.link_policy
        journal = _Journal(inc, pol.select(inc, caps, backend),
                           pol.max_epochs, backend)
    edge_bytes = torch.zeros(inc.n_edges, dtype=F64, device=dev)
    if F == 0:
        finish, n_epochs, rounds = size.clone(), 0, 0
    else:
        tol = 1e-12 * _waterfill_scale(inc, caps)
        finish, used_bytes, n_epochs, rounds = _event_loop(
            prob, size, caps, start, tol, journal)
        edge_bytes[prob.used] = used_bytes
    if journal is not None:
        journal.record(rec)
    lat = path_latency(inc, net, backend)
    done = torch.isfinite(finish)
    makespan = float((finish[done] - start.min()).max()) \
        if bool(done.any()) else 0.0
    mx = get_metrics()
    mx.inc("sim.runs")
    mx.inc("sim.flows", F)
    mx.inc("sim.epochs", n_epochs)
    mx.observe("sim.wall_s", time.perf_counter() - t0_wall)
    res = FlowSimResult(
        start_s=start, finish_s=finish, fct_s=finish - start + lat,
        latency_s=lat, size_bytes=size, edge_bytes=edge_bytes,
        incidence=inc, backend=backend, makespan_s=makespan,
        n_epochs=n_epochs, waterfill_rounds=rounds, tags=tag_arr)
    if rec is not None:
        rec.record_flow_sim(res)
    return res


def simulate_demands(router, demands, flow_time_s: float,
                     mode: str = "minimal", net: NetParams = DEFAULT_NET,
                     backend: "str | None" = None,
                     inc: "FlowIncidence | None" = None,
                     start_s=None, tags=None) -> dict:
    """Measured-FCT summary of one traffic matrix at its offered rates.

    Each demand row becomes one flow sized to transfer for exactly
    ``flow_time_s`` at its offered Gbps (uncontended, every FCT is
    ``flow_time_s + alpha`` and the slowdown is 1.0).  ``inc`` may come
    from a demand matrix with the same (src, dst) rows.  Runs on the
    router's device.  Returns the flat row the sim suite writes: the
    reference's columns plus ``sim_nnz`` and ``sim_waterfill_rounds``;
    with ``tags`` (length F, opaque) also the reference's ``per_tag``
    breakdown (flow counts and FCT percentiles keyed by ``str(tag)``).
    """
    gbps = demands.gbps.to(router.device, F64)
    if inc is None:
        inc = flow_incidence(router, demands, mode, backend=backend)
    res = simulate_incidence(inc, gbps_to_Bps(gbps) * flow_time_s, gbps,
                             start_s=start_s, net=net, backend=backend,
                             device=router.device, tags=tags)
    pct = res.fct_percentiles()
    slow = res.slowdown(gbps).cpu().numpy()
    ok = np.isfinite(res.finish_s.cpu().numpy())
    offered = float(gbps.cpu().numpy().sum())

    def us(p):
        return round(p * 1e6, 3) if p is not None else None

    row = {
        "sim_flows": int(inc.n_flows),
        "sim_epochs": res.n_epochs,
        "sim_stalled": int((~ok).sum()),
        "sim_delivered_fraction":
            round(res.delivered_gbps() / offered, 6) if offered else 1.0,
        "fct_p50_us": us(pct["p50"]),
        "fct_p95_us": us(pct["p95"]),
        "fct_p99_us": us(pct["p99"]),
        "slowdown_mean": round(float(slow[ok].mean()), 4) if ok.any()
            else None,
        "slowdown_p99": round(float(np.percentile(slow[ok], 99)), 4)
            if ok.any() else None,
        "sim_nnz": inc.nnz,
        "sim_waterfill_rounds": res.waterfill_rounds,
    }
    if res.tags is not None:
        fct_all = res.fct_s.cpu().numpy()
        per_tag: dict = {}
        for tag in dict.fromkeys(res.tags.tolist()):   # stable order
            mine = res.tag_mask(tag)
            fct = fct_all[mine & ok]
            per_tag[str(tag)] = {
                "flows": int(mine.sum()),
                "stalled": int((mine & ~ok).sum()),
                "fct_p50_us": round(float(np.percentile(fct, 50)) * 1e6, 3)
                if fct.size else None,
                "fct_p99_us": round(float(np.percentile(fct, 99)) * 1e6, 3)
                if fct.size else None,
            }
        row["per_tag"] = per_tag
    return row


def _default_rate_cap(router) -> float:
    """One NIC port's bandwidth on this plane."""
    return router.topo.port_gbps if hasattr(router, "topo") \
        else router.graph.link_gbps


def _flow_tags(flows: "list[FlowSpec]"):
    tags = [f.tag for f in flows]
    return tags if any(t is not None for t in tags) else None


def simulate_flows(router, flows: "list[FlowSpec]", mode: str = "minimal",
                   rate_cap_gbps=None, net: NetParams = DEFAULT_NET,
                   backend: "str | None" = None) -> FlowSimResult:
    """Simulate a list of :class:`FlowSpec` on one plane's fabric, on the
    router's device.  Routes come from the router's ``mode`` path
    spread; ``rate_cap_gbps`` defaults to the plane's port bandwidth."""
    dem = flows_to_demands(flows, device=router.device)
    inc = flow_incidence(router, dem, mode, backend=backend)
    if rate_cap_gbps is None:
        rate_cap_gbps = _default_rate_cap(router)
    return simulate_incidence(
        inc, np.array([f.size_bytes for f in flows]), rate_cap_gbps,
        np.array([f.start_s for f in flows]), net=net, backend=backend,
        device=router.device, tags=_flow_tags(flows))


@dataclass
class BatchSimResult:
    """Outcome of a serialized sequence of flow batches: batch ``k``
    spans ``batch_start_s[k]`` to ``batch_finish_s[k]`` on the shared
    fabric clock, ``results[k]`` is its :class:`FlowSimResult` (None for
    an empty batch)."""

    batch_start_s: np.ndarray    # (K,)
    batch_finish_s: np.ndarray   # (K,)
    makespan_s: float
    results: "list[FlowSimResult | None]"

    def batch_span_s(self) -> np.ndarray:
        return self.batch_finish_s - self.batch_start_s


def simulate_flow_batches(router, batches: "list[list[FlowSpec]]",
                          mode: str = "minimal", rate_cap_gbps=None,
                          gap_s: float = 0.0, net: NetParams = DEFAULT_NET,
                          backend: "str | None" = None) -> BatchSimResult:
    """Run dependent flow batches back to back on one plane's fabric.

    Batch ``k`` is admitted at the transfer finish of batch ``k-1`` plus
    ``gap_s``; within a batch each flow's ``start_s`` is relative to the
    admission.  Batches never overlap on the fabric, so simulating them
    one by one and carrying the clock is exact.  Incidences come through
    the router's pair-level cache (``incidence_cached``), so a pair
    reused across batches is walked once.
    """
    if rate_cap_gbps is None:
        rate_cap_gbps = _default_rate_cap(router)
    t = 0.0
    starts, finishes, results = [], [], []
    for flows in batches:
        starts.append(t)
        if not flows:
            finishes.append(t)
            results.append(None)
            continue
        dem = flows_to_demands(flows, device=router.device)
        inc = flow_incidence(router, dem, mode, backend=backend, cached=True)
        res = simulate_incidence(
            inc, np.array([f.size_bytes for f in flows]), rate_cap_gbps,
            t + np.array([f.start_s for f in flows]), net=net,
            backend=backend, device=router.device, tags=_flow_tags(flows))
        finish = res.finish_s.cpu().numpy()
        if not np.isfinite(finish).all():
            raise RuntimeError("stalled flows in batch: fabric has a "
                               "zero-capacity cut for this phase")
        t = float(finish.max()) + gap_s
        finishes.append(float(finish.max()))
        results.append(res)
    return BatchSimResult(
        batch_start_s=np.asarray(starts), batch_finish_s=np.asarray(finishes),
        makespan_s=finishes[-1] if finishes else 0.0, results=results)
