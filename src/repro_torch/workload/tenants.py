"""Multi-tenant traffic mixing on one simulated fabric (port of
``repro/workload/tenants.py``).

Three tenant kinds share the fabric:

* **serving** (:class:`~repro_torch.workload.serving.ServingTenantSpec`):
  open-loop prefill/decode KV-transfer flows;
* **training** (:class:`TrainingTenantSpec`): a :mod:`repro_torch.cosim`
  phase schedule, each step's collective phases as aggregated
  switch-pair flows (``phase_step_flows`` geometry x steps x calls)
  admitted at their analytic phase-start offsets, repeated per step;
* **background** (:class:`BackgroundTenantSpec`): FatPaths-style
  point-to-point flows with empirical-CDF sizes between the tenant's own
  NICs.

Tenants get disjoint consecutive NIC blocks (allocation order = spec
order) over the fabric's NIC -> switch map, and their flows run in ONE
:func:`repro_torch.sim.events.simulate_incidence` call, every flow
stamped ``tag=(tenant, key)`` so measured FCTs attribute back without
index arithmetic.  All planes are identical fabric copies under even
spray, so one plane simulates each flow's ``1/n_planes`` byte share at
its port-rate injection cap.  The incidences come through the router's
pair-level cache (``flow_incidence(..., cached=True)``), shared by the
mixed run and the isolated ones.

Per-tenant isolation baselines (each tenant alone on the fabric, same
seed-derived trace) give slowdown-vs-isolation.  The draws are numpy's
on the host: one ``SeedSequence(seed)`` spawns a child per tenant, so
adding a tenant never perturbs another tenant's trace, and a seed gives
the reference's flows.  Each mix adds to the ``workload.flows.<tenant>``,
``workload.bytes.<tenant>``, ``workload.requests.<tenant>`` and
``workload.mixes`` counters and, under a flight recorder, one span a
tenant on the ``workload:<topology>`` track of its kind.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .._device import resolve_sim_backend
from ..core.netsim import DEFAULT_NET, NetParams, _alpha, make_router
from ..core.topology import Topology
from ..cosim.placement import phase_step_flows, rank_to_switch
from ..cosim.stepsim import analytic_phase_time
from ..sim.events import FlowSpec, flows_to_demands, simulate_incidence
from ..sim.fairshare import flow_incidence
from ..telemetry import get_metrics, get_recorder
from .arrivals import SizeDist, mmpp_arrivals, poisson_arrivals, sample_sizes
from .serving import ServingTenantSpec, ServingWorkload, build_serving_workload


@dataclass(frozen=True)
class TrainingTenantSpec:
    """One training tenant: a co-sim job issuing its phase schedule."""

    name: str
    arch: str = "mixtral-8x22b"
    n_ranks: int = 16
    n_steps: int = 1
    shape: str = "train_4k"
    device_tflops: float = 989.0

    @property
    def n_nics(self) -> int:
        return self.n_ranks


@dataclass(frozen=True)
class BackgroundTenantSpec:
    """Open-loop point-to-point background flows between own NICs."""

    name: str
    rate_hz: float = 2000.0
    duration_s: float = 0.25
    arrival: str = "poisson"
    burstiness: float = 4.0
    size_bytes: SizeDist = field(
        default_factory=lambda: SizeDist("empirical", name="websearch"))
    n_nics: int = 8


TENANT_SPECS = (ServingTenantSpec, TrainingTenantSpec, BackgroundTenantSpec)


def tenant_of(tag) -> str:
    """Tenant name from a flow tag (``(tenant, key)`` tuple or bare)."""
    return tag[0] if isinstance(tag, tuple) else tag


def tenant_mask(res, name: str) -> np.ndarray:
    """(F,) bool — flows of a simulation belonging to tenant ``name``
    (via the opaque per-flow tags, never index arithmetic)."""
    if res.tags is None:
        raise ValueError("simulation was run without flow tags")
    return np.array([tenant_of(t) == name for t in res.tags], dtype=bool)


def tenant_kind(spec) -> str:
    if isinstance(spec, ServingTenantSpec):
        return "serving"
    if isinstance(spec, TrainingTenantSpec):
        return "training"
    if isinstance(spec, BackgroundTenantSpec):
        return "background"
    raise TypeError(f"unknown tenant spec type {type(spec).__name__}")


@dataclass
class TenantTraffic:
    """One tenant's materialized flows on the shared fabric clock."""

    name: str
    kind: str                      # serving | training | background
    flows: "list[FlowSpec]"        # full (all-planes) bytes
    caps_gbps: np.ndarray          # (F,) per-plane injection caps
    nic_base: int
    n_nics: int
    payload_bytes: float           # total tenant payload incl. intra
    serving: "ServingWorkload | None" = None
    meta: dict = field(default_factory=dict)


def training_traffic(spec: TrainingTenantSpec, topo: Topology,
                     switch_of_nic: np.ndarray, nic_base: int,
                     net: NetParams = DEFAULT_NET) -> TenantTraffic:
    """Aggregated per-phase flows of ``spec`` at analytic offsets.

    Each phase of each step becomes its steady-state switch-pair flows
    (:func:`~repro_torch.cosim.placement.phase_step_flows`) carrying the
    full phase payload (``steps x calls`` times the per-step bytes),
    admitted at the phase's analytic start offset on the isolated
    schedule: under zero contention the phases drain roughly on
    schedule, and a congested fabric shows up as per-flow slowdown.
    """
    from ..cosim.traffic import job_from_model
    from ..experiments.cosuite import default_mesh
    from ..models.registry import get_config

    cfg = get_config(spec.arch)
    moe = cfg.moe
    mesh = default_mesh(spec.arch, spec.n_ranks,
                        moe.n_experts if moe is not None else None)
    job = job_from_model(cfg, shape=spec.shape, **mesh)
    need = nic_base + spec.n_ranks
    if need > switch_of_nic.shape[0]:
        raise ValueError(f"tenant {spec.name!r} needs NICs "
                         f"[{nic_base}, {need}) but fabric has "
                         f"{switch_of_nic.shape[0]}")
    switch_of = switch_of_nic[nic_base:need]
    compute_s = (6.0 * job.active_params * job.tokens_per_step
                 / (job.n_ranks * spec.device_tflops * 1e12))
    flows: "list[FlowSpec]" = []
    caps: "list[float]" = []
    payload = 0.0
    t = 0.0
    for step in range(spec.n_steps):
        for phase in job.phases:
            base, ring_steps, senders = phase_step_flows(
                phase, switch_of, job.n_ranks, start_s=t)
            scale = ring_steps * phase.calls
            for k, f in enumerate(base):
                flows.append(FlowSpec(
                    f.src, f.dst, f.size_bytes * scale, start_s=f.start_s,
                    tag=(spec.name, f"s{step}.{phase.name}.{k}")))
                caps.append(topo.port_gbps * float(senders[k]))
            payload += sum(f.size_bytes * scale for f in base)
            t += analytic_phase_time(topo, phase, net)
        t += compute_s
    return TenantTraffic(
        name=spec.name, kind="training", flows=flows,
        caps_gbps=np.asarray(caps, dtype=np.float64),
        nic_base=nic_base, n_nics=spec.n_ranks, payload_bytes=payload,
        meta={"mesh": dict(job.mesh), "n_steps": spec.n_steps,
              "compute_s": compute_s, "schedule_s": t})


def background_traffic(spec: BackgroundTenantSpec, topo: Topology,
                       switch_of_nic: np.ndarray, nic_base: int,
                       rng: np.random.Generator) -> TenantTraffic:
    """Point-to-point open-loop flows between the tenant's own NICs."""
    need = nic_base + spec.n_nics
    if need > switch_of_nic.shape[0]:
        raise ValueError(f"tenant {spec.name!r} needs NICs "
                         f"[{nic_base}, {need}) but fabric has "
                         f"{switch_of_nic.shape[0]}")
    if spec.arrival == "mmpp":
        arrival = mmpp_arrivals(spec.rate_hz, spec.duration_s, rng,
                                burstiness=spec.burstiness)
    else:
        arrival = poisson_arrivals(spec.rate_hz, spec.duration_s, rng)
    R = arrival.shape[0]
    sizes = sample_sizes(spec.size_bytes, R, rng)
    src_nic = rng.integers(0, spec.n_nics, size=R)
    # destination: a uniformly random OTHER nic of the block
    off = rng.integers(1, max(spec.n_nics, 2), size=R)
    dst_nic = (src_nic + off) % spec.n_nics
    sw = switch_of_nic[nic_base + np.arange(spec.n_nics)]
    flows: "list[FlowSpec]" = []
    caps: "list[float]" = []
    intra = 0.0
    for r in range(R):
        s, d = int(sw[src_nic[r]]), int(sw[dst_nic[r]])
        if s == d:
            intra += float(sizes[r])
            continue
        flows.append(FlowSpec(s, d, float(sizes[r]),
                              start_s=float(arrival[r]),
                              tag=(spec.name, r)))
        caps.append(topo.port_gbps)
    return TenantTraffic(
        name=spec.name, kind="background", flows=flows,
        caps_gbps=np.asarray(caps, dtype=np.float64),
        nic_base=nic_base, n_nics=spec.n_nics,
        payload_bytes=float(sizes.sum()),
        meta={"n_requests": int(R), "intra_bytes": intra})


def build_tenant_traffic(spec, topo: Topology, switch_of_nic: np.ndarray,
                         nic_base: int, rng: np.random.Generator,
                         net: NetParams = DEFAULT_NET) -> TenantTraffic:
    """Materialize one tenant's flows (dispatch on spec type)."""
    if isinstance(spec, ServingTenantSpec):
        w = build_serving_workload(spec, switch_of_nic, nic_base,
                                   topo.port_gbps, rng)
        return TenantTraffic(
            name=spec.name, kind="serving", flows=w.flows,
            caps_gbps=w.caps_gbps, nic_base=nic_base, n_nics=spec.n_nics,
            payload_bytes=w.offered_bytes(), serving=w,
            meta={"n_requests": w.n_requests,
                  "intra_bytes": w.intra_bytes})
    if isinstance(spec, TrainingTenantSpec):
        return training_traffic(spec, topo, switch_of_nic, nic_base, net)
    if isinstance(spec, BackgroundTenantSpec):
        return background_traffic(spec, topo, switch_of_nic, nic_base, rng)
    raise TypeError(f"unknown tenant spec type {type(spec).__name__}")


@dataclass
class MixResult:
    """Outcome of all tenants sharing one fabric.

    ``mixed`` is the shared-fabric simulation (tags = (tenant, key));
    ``isolated[name]`` re-runs that tenant's identical flow trace alone.
    Both are :class:`~repro_torch.sim.events.FlowSimResult` with tensors
    on the simulation's device.  ``alpha_local_s`` is the 2-hop
    intra-switch alpha used for requests whose shards never touched the
    fabric.
    """

    topology: str
    n_planes: int
    traffic: "list[TenantTraffic]"
    mixed: object                  # FlowSimResult
    isolated: dict                 # name -> FlowSimResult
    caps_gbps: np.ndarray          # (F,) concatenated per-plane caps
    alpha_local_s: float
    seed: int

    def tenant(self, name: str) -> TenantTraffic:
        for t in self.traffic:
            if t.name == name:
                return t
        raise KeyError(name)


def _simulate(router, flows, caps, n_planes, net, sim_backend):
    """One plane's simulation of ``flows``' even-spray byte share (host
    division, the reference's bits) through the router's pair cache, on
    the router's device."""
    share = np.array([f.size_bytes for f in flows]) / n_planes
    starts = np.array([f.start_s for f in flows])
    tags = [f.tag for f in flows]
    dem = flows_to_demands(flows, device=router.device)
    inc = flow_incidence(router, dem, "minimal", backend=sim_backend,
                         cached=True)
    return simulate_incidence(inc, share, caps, start_s=starts, net=net,
                              backend=sim_backend, device=router.device,
                              tags=tags)


def run_tenant_mix(topo: Topology, specs: "list", seed: int = 0,
                   engine: str = "auto", sim_backend: "str | None" = None,
                   net: NetParams = DEFAULT_NET,
                   include_isolated: bool = True,
                   router=None, device=None) -> MixResult:
    """Simulate all tenants sharing ``topo``; per-tenant isolation too.

    Runs on ``router``'s device; without a router, on one made for
    ``topo`` and ``engine`` on ``device`` (default ``cuda``).
    ``sim_backend`` (``cuda``: the hand-written kernels, the default;
    ``torch``: the plain versions) is the solver's and the router's.
    Each tenant draws from its own child of ``SeedSequence(seed)`` with
    numpy, in spec order.  Raises :class:`ValueError` when the tenants'
    NIC demand exceeds the fabric or no flow crosses it (the suite turns
    that into an explicit skip record).
    """
    sim_backend = resolve_sim_backend(sim_backend)
    if router is None:
        router = make_router(topo, engine=engine, device=device)
    switch_of = rank_to_switch(topo, getattr(router, "graph", None))
    children = np.random.SeedSequence(seed).spawn(len(specs))
    traffic: "list[TenantTraffic]" = []
    base = 0
    for spec, child in zip(specs, children):
        rng = np.random.default_rng(child)
        t = build_tenant_traffic(spec, topo, switch_of, base, rng, net)
        traffic.append(t)
        base += t.n_nics
    all_flows = [f for t in traffic for f in t.flows]
    if not all_flows:
        raise ValueError("tenant mix produced no fabric flows")
    caps = np.concatenate([t.caps_gbps for t in traffic])
    mx = get_metrics()
    rec = get_recorder()
    mixed = _simulate(router, all_flows, caps, topo.n_planes, net,
                      sim_backend)
    for t in traffic:
        mx.inc(f"workload.flows.{t.name}", len(t.flows))
        mx.inc(f"workload.bytes.{t.name}", t.payload_bytes)
        if t.serving is not None:
            mx.inc(f"workload.requests.{t.name}", t.serving.n_requests)
    mx.inc("workload.mixes")
    if rec is not None:
        proc = f"workload:{topo.name}"
        start_all = mixed.start_s.cpu().numpy()
        finish_all = mixed.finish_s.cpu().numpy()
        for t in traffic:
            m = tenant_mask(mixed, t.name)
            fin = finish_all[m]
            fin = fin[np.isfinite(fin)]
            if fin.size:
                t0 = float(start_all[m].min())
                rec.span(t.name, t0, float(fin.max()) - t0,
                         process=proc, thread=t.kind, cat="tenant",
                         args={"flows": int(m.sum()),
                               "bytes": t.payload_bytes})
    isolated: dict = {}
    if include_isolated:
        off = 0
        for t in traffic:
            n = len(t.flows)
            if n:
                isolated[t.name] = _simulate(
                    router, t.flows, caps[off:off + n], topo.n_planes,
                    net, sim_backend)
            off += n
    return MixResult(
        topology=topo.name, n_planes=topo.n_planes, traffic=traffic,
        mixed=mixed, isolated=isolated, caps_gbps=caps,
        alpha_local_s=_alpha(topo, 2.0, net), seed=seed)
