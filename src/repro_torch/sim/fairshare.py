"""Batched max-min fair bandwidth allocation (port of
``repro/sim/fairshare.py``).

A routed flow set is a *flow-incidence tensor*: COO tensors
``(flow, edge, frac)``, ``frac`` being the fraction of flow ``f``'s rate
that crosses directed edge ``e``, coalesced and sorted by flow.  Fair
shares come from progressive water-filling: every unfrozen flow raises
its rate at the same pace until an edge saturates (freezing every flow
that crosses it) or the flow reaches its demand cap.

This is the reference's in-jit solver, round for round: the same
tolerance (``1e-12 * _waterfill_scale``), the same ``F + E + 2`` round
bound, the same open-edge, freeze and capped rules, solved over the
compressed used-edge set.  Its two segment reductions per round go to
the hand-written kernels (``backend="cuda"``) or to their plain PyTorch
versions (``backend="torch"``).  The host reads one flag per round to
decide whether to go on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from .._device import resolve_device, resolve_sim_backend
from ..core.routing_vec import ordered_sum
from ..kernels.segment_fairshare import (SegmentPlan, make_plan,
                                         segment_min, segment_min_ref,
                                         segment_sum, segment_sum_ref)

F64 = torch.float64


def _seg_sum(values, ids, n: int, backend: str,
             plan: "SegmentPlan | None" = None) -> torch.Tensor:
    if backend == "cuda":
        return segment_sum(values, ids, n, plan=plan)
    return segment_sum_ref(values, ids, n)


def _seg_min(values, ids, n: int, backend: str,
             plan: "SegmentPlan | None" = None) -> torch.Tensor:
    if backend == "cuda":
        return segment_min(values, ids, n, plan=plan)
    return segment_min_ref(values, ids, n)


@dataclass
class FlowIncidence:
    """Per-flow edge usage of a routed flow set, plus edge capacities.

    ``flow`` / ``edge`` / ``frac`` are parallel COO tensors, one entry per
    (flow, edge) pair, sorted by flow; ``capacity`` is the per-edge Gbps.
    ``sum_e frac[f, e]`` is flow ``f``'s expected switch-switch hop count.
    The reductions below take a solver ``backend`` (``cuda``: the kernels;
    ``torch``: the plain versions).
    """

    flow: torch.Tensor       # (NNZ,) int64 flow index, sorted
    edge: torch.Tensor       # (NNZ,) int64 directed-edge id / edge slot
    frac: torch.Tensor       # (NNZ,) float64 fraction of the flow's rate
    n_flows: int
    capacity: torch.Tensor   # (E,) float64 Gbps
    _flow_plan: "SegmentPlan | None" = field(default=None, repr=False,
                                             compare=False)
    _edge_plan: "SegmentPlan | None" = field(default=None, repr=False,
                                             compare=False)

    @property
    def n_edges(self) -> int:
        return int(self.capacity.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.flow.shape[0])

    @property
    def device(self) -> torch.device:
        return self.capacity.device

    def to(self, device) -> "FlowIncidence":
        device = torch.device(device)
        if device == self.device:
            return self
        return FlowIncidence(self.flow.to(device), self.edge.to(device),
                             self.frac.to(device), self.n_flows,
                             self.capacity.to(device))

    def flow_plan(self, backend: str) -> "SegmentPlan | None":
        """Segment plan of the (sorted) flow column, built once."""
        if backend != "cuda":
            return None
        if self._flow_plan is None:
            self._flow_plan = make_plan(self.flow, self.n_flows,
                                        presorted=True)
        return self._flow_plan

    def edge_plan(self) -> SegmentPlan:
        """Segment plan of the edge column over all ``n_edges`` edges: the
        one stable sort of that column, built once.  The solver's
        compressed plan is derived from it (:func:`_compress_edges`)."""
        if self._edge_plan is None:
            self._edge_plan = make_plan(self.edge, self.n_edges)
        return self._edge_plan

    def loads(self, rates_gbps, backend: "str | None" = None
              ) -> torch.Tensor:
        """(E,) offered Gbps per edge when flow ``f`` runs at
        ``rates_gbps[f]`` — the steady-state link loads."""
        backend = resolve_sim_backend(backend)
        rates = torch.as_tensor(rates_gbps, dtype=F64, device=self.device)
        vals = rates[self.flow] * self.frac
        return _seg_sum(vals, self.edge, self.n_edges, backend,
                        self.edge_plan() if backend == "cuda" else None)

    def utilization(self, rates_gbps, backend: "str | None" = None
                    ) -> torch.Tensor:
        l = self.loads(rates_gbps, backend)
        return torch.where(self.capacity > 0, l / self.capacity, 0.0)

    def switch_hops(self, backend: "str | None" = None) -> torch.Tensor:
        """(F,) expected switch-switch hops per flow (0 without a path)."""
        backend = resolve_sim_backend(backend)
        return _seg_sum(self.frac, self.flow, self.n_flows, backend,
                        self.flow_plan(backend))

    def bottleneck_gbps(self, backend: "str | None" = None) -> torch.Tensor:
        """(F,) max rate each flow could sustain alone on an idle fabric:
        ``min_e capacity[e] / frac[f, e]`` (inf without a fabric path)."""
        backend = resolve_sim_backend(backend)
        per_entry = self.capacity[self.edge] / self.frac
        return _seg_min(per_entry, self.flow, self.n_flows, backend,
                        self.flow_plan(backend))

    def edge_share(self, edges, backend: "str | None" = None
                   ) -> torch.Tensor:
        """(F,) fraction of each flow's rate crossing any edge in
        ``edges`` (clipped to 1): the first-order stalled share when those
        edges fail before re-routing (:mod:`repro_torch.sim.failures`).
        Each flow adds its selected entries one by one in entry order
        (``np.add.at``'s bits), through a plan with one lane a segment on
        the card."""
        backend = resolve_sim_backend(backend)
        edges = torch.as_tensor(edges, dtype=torch.int64, device=self.device)
        sel = torch.isin(self.edge, edges)
        flow = self.flow[sel]
        plan = None
        if flow.is_cuda:
            plan = dataclasses.replace(
                make_plan(flow, self.n_flows, presorted=True), lanes=1)
        out = ordered_sum(self.frac[sel], flow, self.n_flows, backend,
                          plan=plan)
        return out.clamp_max(1.0)


def flow_incidence(router, demands, mode: str = "minimal",
                   backend: "str | None" = None,
                   cached: bool = False) -> FlowIncidence:
    """The per-flow incidence tensor of ``demands`` on ``router`` (a
    :func:`repro_torch.core.netsim.make_router` product) in ``mode``
    (``minimal``, or ``valiant`` on the array engine); ``backend``
    (``cuda`` or ``torch``) is the router's reduction backend.
    ``cached=True`` goes through the router's pair-level cache
    (``incidence_cached``): only (src, dst) pairs not seen before are
    walked."""
    if cached and hasattr(router, "incidence_cached"):
        flow, edge, frac = router.incidence_cached(demands, mode,
                                                   backend=backend)
    else:
        flow, edge, frac = router.incidence(demands, mode, backend=backend)
    return FlowIncidence(flow, edge, frac, demands.n,
                         router.edge_capacity().to(F64))


def _waterfill_scale(inc: FlowIncidence, caps: torch.Tensor) -> float:
    cap_max = float(inc.capacity.max()) if inc.n_edges else 0.0
    caps_max = float(caps.max()) if caps.numel() else 0.0
    return max(cap_max, caps_max, 1.0)


def _compress_edges(inc: FlowIncidence):
    """Drop edges no flow crosses before solving.

    An edge with zero incidence weight never opens, so the solve over the
    used-edge subset runs the identical float sequence.  Returns
    ``(used_edge_ids, remapped_edge_col, used_capacities)``, read off the
    incidence's edge plan: the used edges are its non-empty segments.
    """
    offsets = inc.edge_plan().offsets
    used = torch.nonzero(offsets[1:] > offsets[:-1]).squeeze(1)
    remap = torch.empty(inc.n_edges, dtype=torch.int64, device=inc.device)
    remap[used] = torch.arange(used.shape[0], device=inc.device)
    return used, remap[inc.edge], inc.capacity[used]


@dataclass
class SolveProblem:
    """An incidence over its used edges, with the segment plans of both
    of its columns: built once per solve or simulation, read every
    round."""

    flow: torch.Tensor
    edge: torch.Tensor        # compressed edge ids 0..E-1
    frac: torch.Tensor
    capacity: torch.Tensor    # (E,) capacities of the used edges
    used: torch.Tensor        # (E,) global ids of the used edges
    n_flows: int
    backend: str
    edge_plan: "SegmentPlan | None"
    flow_plan: "SegmentPlan | None"

    @property
    def n_edges(self) -> int:
        return int(self.used.shape[0])

    @classmethod
    def build(cls, inc: FlowIncidence, backend: str) -> "SolveProblem":
        used, edge_c, cap_c = _compress_edges(inc)
        edge_plan = None
        if backend == "cuda":
            # the full plan with its empty segments dropped
            edge_plan = inc.edge_plan().keep(used, edge_c)
        return cls(inc.flow, edge_c, inc.frac, cap_c, used, inc.n_flows,
                   backend, edge_plan, inc.flow_plan(backend))

    def edge_sum(self, values: torch.Tensor) -> torch.Tensor:
        return _seg_sum(values, self.edge, self.n_edges, self.backend,
                        self.edge_plan)

    def flow_sum(self, values: torch.Tensor) -> torch.Tensor:
        return _seg_sum(values, self.flow, self.n_flows, self.backend,
                        self.flow_plan)


def waterfill(prob: SolveProblem, caps: torch.Tensor, active: torch.Tensor,
              tol: float) -> "tuple[torch.Tensor, bool, int]":
    """Max-min rates of the ``active`` flows: ``(rates, converged,
    rounds)``, round for round the reference's ``_waterfill_body``."""
    F, E = prob.n_flows, prob.n_edges
    rates = torch.zeros(F, dtype=F64, device=caps.device)
    unfrozen = active.clone()
    cap_left = prob.capacity
    for rounds in range(F + E + 2):
        if not bool(unfrozen.any()):
            return rates, True, rounds
        live = torch.where(unfrozen[prob.flow], prob.frac, 0.0)
        wsum = prob.edge_sum(live)
        open_e = wsum > tol
        delta_e = torch.where(open_e,
                              cap_left / torch.where(open_e, wsum, 1.0),
                              torch.inf)
        delta = torch.where(unfrozen, caps - rates, torch.inf).min()
        if E:
            delta = torch.minimum(delta_e.min(), delta)
        delta = delta.clamp_min(0.0)
        rates = torch.where(unfrozen, rates + delta, rates)
        cap_left = cap_left - delta * wsum
        sat = open_e & (cap_left <= tol)
        on_sat = prob.flow_sum(torch.where(sat[prob.edge], prob.frac,
                                           0.0)) > 0
        capped = rates >= caps - tol
        unfrozen = unfrozen & ~on_sat & ~capped
    return rates, not bool(unfrozen.any()), F + E + 2


def max_min_rates(inc: FlowIncidence, rate_caps_gbps,
                  active=None, backend: "str | None" = None,
                  device=None) -> torch.Tensor:
    """(F,) max-min fair rates by progressive water-filling.

    Every active flow's rate rises at unit pace until an edge saturates
    (``sum_f frac * rate == capacity``; all flows crossing it freeze) or
    the flow reaches its own ``rate_caps_gbps`` cap.  Inactive flows hold
    rate 0.  ``inc`` is moved to ``device`` (default ``cuda``).
    """
    backend = resolve_sim_backend(backend)
    dev = resolve_device(device)
    inc = inc.to(dev)
    F = inc.n_flows
    caps = torch.as_tensor(rate_caps_gbps, dtype=F64,
                           device=dev).broadcast_to((F,))
    if not bool(torch.isfinite(caps).all()):
        raise ValueError("rate caps must be finite (a flow with no fabric "
                         "path would otherwise fill forever)")
    active = (torch.ones(F, dtype=torch.bool, device=dev) if active is None
              else torch.as_tensor(active, dtype=torch.bool, device=dev))
    if F == 0:
        return torch.zeros(0, dtype=F64, device=dev)
    tol = 1e-12 * _waterfill_scale(inc, caps)
    rates, converged, _ = waterfill(SolveProblem.build(inc, backend), caps,
                                    active, tol)
    if not converged:
        raise RuntimeError("water-filling failed to converge "
                           f"({F} flows, {inc.n_edges} edges)")
    return rates
