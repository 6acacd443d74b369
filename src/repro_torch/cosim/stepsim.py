"""Measured training-step time on the simulated fabric (port of
``repro/cosim/stepsim.py``).

Executes a :class:`~repro_torch.cosim.traffic.TrainJob`'s collective
schedule on :mod:`repro_torch.sim`: every phase becomes sprayed,
plane-split flows over the routed fabric, and the result is a *measured*
step time and tokens/sec per topology, next to the alpha-beta closed
forms of :mod:`repro_torch.core.netsim` for the same phases.

Two execution methods per phase:

* ``steady`` (default): ring collectives are steady-state symmetric, so
  one step's flows (all concurrent groups, contention included) are
  sprayed over the planes (:func:`repro_torch.sim.spray.
  simulate_sprayed`, per-flow caps of ``port_gbps x senders``) and
  scaled by the step count;
* ``batches``: the full serialized ring schedule through
  :func:`repro_torch.sim.events.simulate_flow_batches`: step ``k``'s
  flows arrive at step ``k-1``'s delivery time, one plane at full NIC
  rate carrying the even-spray byte share.

Dependent phases never overlap on the fabric, so the step's
communication time is the sum of the phase times (``stagger=True``
stamps each phase's flows with its fabric-clock start offset).

The simulations run on the router's device with its reduction
``backend`` (``cuda``: the hand-written segment kernels; ``torch``: the
plain versions); placement and flow construction are host arithmetic.
Under a flight recorder each phase is one span on the ``step`` track of
``cosim:<topology>`` (the spans tile the step clock and sum to
``comm_s``), with one busy span a plane under it; every call adds the
phase count to the ``cosim.phases`` counter.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.netsim import (DEFAULT_NET, NetParams, _alpha, allgather_time,
                           alltoall_time, make_router, ring_allreduce_time)
from ..core.planes import SprayConfig
from ..core.topology import Topology
from ..sim.events import (FlowSpec, flows_to_demands, path_latency,
                          simulate_flow_batches)
from ..sim.fairshare import flow_incidence
from ..sim.spray import simulate_sprayed
from ..telemetry import get_metrics, get_recorder
from .placement import mphx_rank_layout, phase_step_flows, rank_to_switch
from .traffic import CollectivePhase, TrainJob, decompose_phase

PHASE_METHODS = ("steady", "batches")


def analytic_phase_time(topo: Topology, phase: CollectivePhase,
                        net: NetParams = DEFAULT_NET) -> float:
    """Alpha-beta closed-form time for all calls of one phase."""
    if phase.kind == "allreduce":
        t = ring_allreduce_time(topo, phase.bytes_per_rank, m=phase.size,
                                net=net).total_s
    elif phase.kind in ("allgather", "reducescatter"):
        t = allgather_time(topo, phase.bytes_per_rank, m=phase.size,
                           net=net).total_s
    else:
        t = alltoall_time(topo, phase.bytes_per_rank, net=net).total_s
    return phase.calls * t


@dataclass
class PhaseTime:
    """Measured and analytic time of one collective phase of the step."""

    name: str
    kind: str
    size: int
    calls: int
    steps: int
    n_flows: int
    start_s: float            # fabric-clock offset within the step
    comm_s: float             # measured, all calls
    analytic_s: float         # closed form, all calls

    def row(self) -> dict:
        return {
            "phase": self.name, "kind": self.kind, "group": self.size,
            "calls": self.calls, "steps": self.steps,
            "sim_flows_per_step": self.n_flows,
            "start_us": round(self.start_s * 1e6, 3),
            "measured_us": round(self.comm_s * 1e6, 3),
            "analytic_us": round(self.analytic_s * 1e6, 3),
            "measured_over_analytic": round(self.comm_s / self.analytic_s, 4)
                if self.analytic_s > 0 else None,
        }


@dataclass
class StepResult:
    """Measured training-step outcome of one (job, topology) cell."""

    topology: str
    arch: str
    n_ranks: int
    comm_s: float
    compute_s: float
    step_s: float
    tokens_per_s: float
    analytic_comm_s: float
    phases: "list[PhaseTime]" = field(default_factory=list)

    def row(self) -> dict:
        return {
            "topology": self.topology, "arch": self.arch,
            "n_ranks": self.n_ranks,
            "comm_ms": round(self.comm_s * 1e3, 4),
            "compute_ms": round(self.compute_s * 1e3, 4),
            "step_ms": round(self.step_s * 1e3, 4),
            "tokens_per_s": round(self.tokens_per_s, 1),
            "analytic_comm_ms": round(self.analytic_comm_s * 1e3, 4),
            "comm_over_analytic":
                round(self.comm_s / self.analytic_comm_s, 4)
                if self.analytic_comm_s > 0 else None,
            "comm_fraction": round(self.comm_s / self.step_s, 4)
                if self.step_s > 0 else None,
            "phases": [p.row() for p in self.phases],
        }


def _phase_time_batches(router, flows, steps, caps_gbps, n_planes, net,
                        backend) -> float:
    """Serialized ring schedule: step k's flows arrive when step k-1's
    data is delivered (transfer finish + path alpha + software alpha).

    All planes are identical fabric copies, so one plane is simulated
    carrying the even-spray ``1/n_planes`` byte share at its port rate
    (chunk rounding and plane skew are the ``steady`` method's job).
    """
    # batch admission supplies the serialization clock; the phase-level
    # stagger offset is not re-added once per ring step
    share = [FlowSpec(f.src, f.dst, f.size_bytes / n_planes)
             for f in flows]
    inc = flow_incidence(router, flows_to_demands(share,
                                                  device=router.device),
                         "minimal", backend=backend)
    lat = float(path_latency(inc, net, backend).max())
    gap = lat + net.software_alpha
    res = simulate_flow_batches(router, [share] * steps,
                                rate_cap_gbps=caps_gbps, gap_s=gap, net=net,
                                backend=backend)
    return res.makespan_s + lat + net.software_alpha


def _phase_chain(phase: CollectivePhase, job: TrainJob, layout
                 ) -> "list[tuple[int, int]]":
    """Level-factor chain of the mesh axis a phase runs over (mapped
    placement); phases matching no known axis stay undecomposed."""
    tp = job.mesh.get("tp", 1)
    ep = job.mesh.get("ep", 1)
    dp = job.mesh.get("dp", 1)
    name = {(tp, 1): "tp", (ep, tp): "ep", (dp, tp): "dp"}.get(
        (phase.size, phase.stride))
    chain = layout.factors.get(name) if name else None
    return chain if chain else [(phase.size, phase.stride)]


def simulate_step(topo: Topology, job: TrainJob,
                  cfg: "SprayConfig | None" = None,
                  net: NetParams = DEFAULT_NET,
                  mode: str = "minimal", engine: str = "auto",
                  backend: "str | None" = None,
                  device_tflops: float = 989.0,
                  plane_skew: "list[float] | None" = None,
                  method: str = "steady",
                  stagger: bool = True,
                  placement: str = "linear",
                  router=None, device=None) -> StepResult:
    """Co-simulate one training step of ``job`` on ``topo``.

    Phases run back to back on the fabric clock; each phase's flows are
    built from the rank placement (:mod:`.placement`), sprayed over the
    planes and routed with the topology's ``engine``.  ``plane_skew``
    degrades planes as :func:`repro_torch.sim.spray.simulate_sprayed`
    does (``inf`` = dead plane, its bytes re-sprayed over the
    survivors).  ``device_tflops`` sets the compute term by the 6ND
    model-FLOPs rule.  Intra-switch phases (every group inside one
    switch) cost only their per-step 2-hop alpha.  A stalled flow raises
    ``RuntimeError``.

    ``placement="linear"`` puts rank ``r`` on NIC ``r``;
    ``placement="mapped"`` (MPHX only) places the mesh axes on physical
    levels through :func:`repro_torch.core.mapping.best_mapping`
    (:func:`~repro_torch.cosim.placement.mphx_rank_layout`).

    Runs on ``router``'s device; without a router, on one made for
    ``topo`` and ``engine`` on ``device`` (default ``cuda``).
    ``backend`` (``cuda``: the hand-written kernels, the default;
    ``torch``: the plain versions) is the solver's and the router's.
    """
    if method not in PHASE_METHODS:
        raise ValueError(f"unknown method {method!r}; known {PHASE_METHODS}")
    if job.n_ranks > topo.n_nics:
        raise ValueError(f"job needs {job.n_ranks} ranks but {topo.name} "
                         f"has {topo.n_nics} NICs")
    if router is None:
        router = make_router(topo, engine=engine, device=device)
    phases = list(job.phases)
    if placement == "mapped":
        from ..core.hyperx import MPHX
        if not isinstance(topo, MPHX):
            raise ValueError("placement='mapped' is MPHX-only")
        layout = mphx_rank_layout(topo, job, net=net)
        switch_of = layout.nic // topo.p
        phases = [sub for ph in phases
                  for sub in decompose_phase(ph, _phase_chain(ph, job,
                                                              layout))]
    elif placement == "linear":
        switch_of = rank_to_switch(topo, getattr(router, "graph", None))
    else:
        raise ValueError(f"unknown placement {placement!r}")
    t_acc = 0.0
    rows = []
    analytic_total = 0.0
    rec = get_recorder()
    proc = f"cosim:{topo.name}"
    for phase in phases:
        start = t_acc if stagger else 0.0
        span_start = t_acc      # spans always tile the step clock
        flows, steps, senders = phase_step_flows(
            phase, switch_of, job.n_ranks, start_s=start)
        analytic = analytic_phase_time(topo, phase, net)
        analytic_total += analytic
        # a merged flow aggregates `senders` NIC ports of injection
        caps = topo.port_gbps * senders.astype(np.float64)
        res = None
        if not flows:
            # all groups intra-switch: alpha-only schedule
            comm = phase.calls * steps * _alpha(topo, 2.0, net)
        elif method == "batches":
            n_planes = (cfg or SprayConfig(n_planes=topo.n_planes)).n_planes
            comm = phase.calls * _phase_time_batches(
                router, flows, steps, caps, n_planes, net, backend)
        else:
            res = simulate_sprayed(topo, flows, cfg=cfg, mode=mode,
                                   plane_skew=plane_skew,
                                   rate_cap_gbps=caps, net=net,
                                   backend=backend, router=router)
            if bool(res.stalled.any()):
                raise RuntimeError(
                    f"phase {phase.name}: stalled flows on {topo.name}")
            comm = phase.calls * steps * (res.makespan_s
                                          + net.software_alpha)
        if rec is not None:
            # one span per phase on the step track: their durations sum
            # to comm_s (the trace is the step breakdown)
            rec.span(phase.name, span_start, comm, process=proc,
                     thread="step", cat="phase",
                     args={"kind": phase.kind, "group": phase.size,
                           "calls": phase.calls, "steps": steps,
                           "flows": len(flows), "analytic_s": analytic})
            if res is not None:
                # per-plane busy windows under the phase span
                busy_k = res.plane_transfer_s.max(dim=0).values.tolist()
                for k, busy in enumerate(busy_k):
                    if busy > 0:
                        rec.span(phase.name, span_start,
                                 min(phase.calls * steps * busy, comm),
                                 process=proc, thread=f"plane {k}",
                                 cat="plane")
        rows.append(PhaseTime(phase.name, phase.kind, phase.size,
                              phase.calls, steps, len(flows), start,
                              comm, analytic))
        t_acc += comm
    get_metrics().inc("cosim.phases", len(phases))
    comm_s = t_acc
    compute_s = (6.0 * job.active_params * job.tokens_per_step
                 / (job.n_ranks * device_tflops * 1e12))
    step_s = comm_s + compute_s
    return StepResult(
        topology=topo.name, arch=job.arch, n_ranks=job.n_ranks,
        comm_s=comm_s, compute_s=compute_s, step_s=step_s,
        tokens_per_s=job.tokens_per_step / step_s if step_s > 0 else 0.0,
        analytic_comm_s=analytic_total, phases=rows)
