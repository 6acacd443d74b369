"""Flow-level (alpha-beta) network model (port of
``repro/core/netsim.py``).

* zero-load latency = hops * t_hop + serialization + propagation;
* uniform throughput = the closed-form bisection bound;
* routed throughput = link loads of whole demand matrices on the card:
  :func:`adversarial_throughput_fraction`, :func:`pattern_throughput`
  and :func:`load_sweep` (which, with ``simulate=True``, adds measured
  flow-completion times from :mod:`repro_torch.sim.events`);
* collective completion times (all-reduce, all-gather, all-to-all) with
  plane spraying: the latency term counts hops, so MPHX's smaller
  diameter shows directly; the bandwidth term counts bottleneck bytes.

The closed forms (latencies, throughput bounds, collectives,
:func:`compare_topologies`) are host arithmetic on the topology classes
and touch no tensor.  Times are seconds, sizes bytes, bandwidths Gbps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .._device import resolve_device
from .hyperx import MPHX
from .topology import Topology


@dataclass(frozen=True)
class NetParams:
    """Per-hop and per-endpoint overheads (flow-level constants)."""

    t_switch: float = 300e-9        # per-switch-hop latency (pipeline+SerDes)
    t_nic: float = 600e-9           # endpoint injection/ejection overhead
    t_prop_per_hop: float = 50e-9   # ~10m optics per hop
    software_alpha: float = 1.5e-6  # per collective step software overhead


DEFAULT_NET = NetParams()


def gbps_to_Bps(gbps):
    return gbps * 1e9 / 8.0


def zero_load_latency(topo: Topology, msg_bytes: float = 4096,
                      net: NetParams = DEFAULT_NET,
                      spray: bool = True) -> float:
    """Worst-case (diameter) small-message latency.  With plane spraying
    the message is split across the n planes, so serialization uses the
    full NIC bandwidth B although each plane's port runs at B/n."""
    hops = topo.diameter
    sw_hops = hops - 2
    bw = topo.nic_bw_gbps if spray else topo.port_gbps
    ser = msg_bytes / gbps_to_Bps(bw)
    return (net.t_nic + sw_hops * net.t_switch + hops * net.t_prop_per_hop
            + ser)


def avg_latency(topo: Topology, msg_bytes: float = 4096,
                net: NetParams = DEFAULT_NET) -> float:
    hops = topo.avg_hops()
    sw_hops = max(hops - 2.0, 0.0)
    ser = msg_bytes / gbps_to_Bps(topo.nic_bw_gbps)
    return net.t_nic + sw_hops * net.t_switch + hops * net.t_prop_per_hop + ser


def uniform_throughput_fraction(topo: Topology) -> float:
    """Sustainable fraction of injection bandwidth under uniform random
    traffic, bisection-bound: half the traffic crosses the bisection."""
    inj = topo.n_nics * topo.nic_bw_gbps  # total injection
    cross = inj / 2.0
    cap = 2.0 * topo.bisection_links() * topo.port_gbps  # full duplex
    return min(1.0, cap / cross)


def adversarial_throughput_fraction(topo: Topology, mode: str = "minimal",
                                    dim: int = 0, engine: str = "array",
                                    backend: "str | None" = None,
                                    device=None) -> float:
    """Saturation throughput of the neighbor-shift adversarial pattern
    (MPHX only, the §5.2 scenario), routed by the array engine on
    ``device`` (default ``cuda``); ``backend`` (``cuda`` or ``torch``) is
    the adaptive router's reduction backend.  The reference's
    ``engine="dict"`` (its legacy dict router, ``repro/core/routing.py``)
    is not ported."""
    if not isinstance(topo, MPHX):
        raise TypeError("adversarial model implemented for MPHX")
    if engine != "array":
        raise NotImplementedError(
            f"engine={engine!r}: the legacy dict router "
            "(repro/core/routing.py) is not ported; use engine='array'")
    from .routing_vec import VectorizedHyperXRouter, neighbor_shift_demands

    dev = resolve_device(device)
    offered = topo.nic_bw_gbps
    ll = VectorizedHyperXRouter(topo, device=dev).route(
        neighbor_shift_demands(topo, offered, dim, device=dev), mode=mode,
        backend=backend)
    return ll.saturation_throughput(offered)


def resolve_engine(topo: Topology, engine: str = "auto") -> str:
    """Routing engine for ``topo``: the MPHX array engine where it
    applies (coordinate arithmetic), the generic graph engine
    otherwise."""
    if engine == "auto":
        return "array" if isinstance(topo, MPHX) else "graph"
    if engine not in ("array", "graph"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "array" and not isinstance(topo, MPHX):
        raise ValueError(f"array engine is MPHX-only, got {topo.name}")
    return engine


def make_router(topo: Topology, engine: str = "auto", device=None):
    """The batched router for ``topo`` on ``device`` (default ``cuda``):
    a :class:`~.routing_vec.VectorizedHyperXRouter` or a
    :class:`~.routing_graph.GraphRouter`, which share ``route(demands,
    mode, backend=)``, ``incidence``, ``edge_capacity`` and
    ``mean_switch_hops``."""
    if resolve_engine(topo, engine) == "graph":
        from .routing_graph import GraphRouter

        return GraphRouter(topo, device=device)
    from .routing_vec import VectorizedHyperXRouter

    return VectorizedHyperXRouter(topo, device=device)


def pattern_throughput(topo: Topology, demands, mode: str = "adaptive",
                       engine: str = "auto", simulate: bool = False,
                       backend: "str | None" = None, device=None) -> dict:
    """Saturation throughput of one demand matrix on one plane, routed
    on ``device`` (default ``cuda``) by :func:`make_router`'s engine for
    ``topo``; ``backend`` (``cuda`` or ``torch``) is the reduction
    backend of the router and of the simulator's load accounting.

    ``simulate=True`` also runs the flow simulator's steady-state load
    accounting (:meth:`repro_torch.sim.fairshare.FlowIncidence.
    utilization`) over the same routes and reports the cross-check
    (``max_util_sim`` and the max absolute utilization difference).  It
    needs a static path spread (``minimal``, or ``valiant`` on the array
    engine); the default mode is ``adaptive``, as in the reference, so
    ``simulate=True`` needs an explicit ``mode``.
    """
    if simulate and mode == "adaptive":
        raise ValueError("simulate=True needs a static path spread "
                         "(minimal, or valiant on the array engine); "
                         "adaptive re-routes under load — pass "
                         "mode='minimal'")
    router = make_router(topo, engine=engine, device=device)
    ll = router.route(demands, mode, backend=backend)
    out = {
        "max_util": ll.max_utilization(),
        "mean_util": ll.mean_utilization(),
        "throughput_fraction": ll.saturation_throughput(),
        "total_load_gbps": ll.total_load(),
    }
    if simulate:
        from ..sim.fairshare import flow_incidence

        inc = flow_incidence(router, demands, mode, backend=backend)
        u_sim = inc.utilization(demands.gbps, backend)
        u_analytic = ll.utilization_array()
        out["max_util_sim"] = float(u_sim.max()) if u_sim.numel() else 0.0
        out["sim_max_abs_util_diff"] = (
            float((u_sim - u_analytic).abs().max()) if u_sim.numel()
            else 0.0)
    return out


def latency_under_load(topo: Topology, utilization: float,
                       msg_bytes: float = 4096,
                       net: NetParams = DEFAULT_NET, router=None) -> float:
    """Average message latency at a given bottleneck utilization: each
    switch hop's service time inflates by ``rho / (1 - rho)`` (M/M/1);
    saturated (util >= 1) returns inf.  With a ``router`` the switch-hop
    count is its ``mean_switch_hops()``."""
    if utilization >= 1.0:
        return math.inf
    base = avg_latency(topo, msg_bytes, net)
    sw_hops = (router.mean_switch_hops() if router is not None
               else max(topo.avg_hops() - 2.0, 0.0))
    rho = max(utilization, 0.0)
    return base + sw_hops * net.t_switch * rho / (1.0 - rho)


def load_sweep(topo: Topology, demand_builder, mode: str = "adaptive",
               load_fractions=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
               msg_bytes: float = 4096, net: NetParams = DEFAULT_NET,
               router=None, simulate: bool = False,
               flow_time_s: float = 1e-3,
               sim_backend: "str | None" = None, device=None) -> "list[dict]":
    """Latency/throughput vs offered load for one traffic scenario.

    ``demand_builder(topo, offered_per_nic_gbps) -> DemandArrays``.  The
    per-link utilizations scale linearly with offered load for
    ``minimal`` / ``valiant`` (a fixed path spread), so only their first
    level is routed; ``adaptive`` (the default, as in the reference)
    re-routes at every level.  ``router`` defaults to
    :func:`make_router`'s for ``topo`` (the array engine on MPHX, the
    graph engine otherwise).  ``simulate=True`` adds measured FCT
    columns per level (:func:`repro_torch.sim.events.simulate_demands`):
    each demand pair becomes one flow sized to transfer for
    ``flow_time_s`` at its offered rate.  It needs a static path spread
    (``minimal``, or ``valiant`` on the array engine); with ``adaptive``
    it raises ``ValueError`` before any routing.  ``sim_backend``
    (``cuda`` or ``torch``) is the backend of the fair-share solver and
    of the router's fixed-order reductions.
    """
    if router is None:
        router = make_router(topo, device=device)
    if simulate and mode == "adaptive":
        raise ValueError("simulate=True needs a static path spread "
                         "(minimal, or valiant on the array engine); "
                         "adaptive re-routes under load")
    rows = []
    base_ll = None
    sim_inc = None
    for frac in load_fractions:
        offered = frac * topo.nic_bw_gbps
        demands = None
        if frac == 0:
            max_util = 0.0
        elif mode == "adaptive" or base_ll is None:
            demands = demand_builder(topo, offered)
            ll = router.route(demands, mode, backend=sim_backend)
            if mode != "adaptive":
                base_ll, base_frac = ll, frac
            max_util = ll.max_utilization()
        else:
            max_util = base_ll.max_utilization() * frac / base_frac
        row = {
            "offered_fraction": frac,
            "offered_per_nic_gbps": offered,
            "max_util": round(max_util, 6),
            "throughput_fraction":
                1.0 if max_util == 0 else round(min(1.0, 1.0 / max_util), 6),
            "delivered_fraction": round(min(frac, frac / max_util)
                                        if max_util > 0 else frac, 6),
            "latency_us": (round(latency_under_load(topo, max_util,
                                                    msg_bytes, net,
                                                    router=router) * 1e6, 3)
                           if max_util < 1.0 else None),
        }
        if simulate and frac > 0:
            from ..sim.events import simulate_demands
            from ..sim.fairshare import flow_incidence

            if demands is None:
                demands = demand_builder(topo, offered)
            if sim_inc is None:
                # a static spread does not depend on the offered load —
                # one extraction serves every level of the sweep
                sim_inc = flow_incidence(router, demands, mode,
                                         backend=sim_backend)
            row.update(simulate_demands(router, demands, flow_time_s,
                                        mode=mode, net=net, inc=sim_inc,
                                        backend=sim_backend))
        rows.append(row)
    return rows


# ----------------------------------------------------------------------------
# Collectives (closed forms, host arithmetic)
# ----------------------------------------------------------------------------


@dataclass
class CollectiveEstimate:
    kind: str
    algo: str
    bytes_per_nic: float
    steps: int
    hops_per_step: float
    latency_s: float          # alpha terms
    bandwidth_s: float        # beta  terms

    @property
    def total_s(self) -> float:
        return self.latency_s + self.bandwidth_s

    def row(self) -> dict:
        return {
            "kind": self.kind, "algo": self.algo,
            "bytes_per_nic": int(self.bytes_per_nic),
            "steps": self.steps,
            "latency_us": round(self.latency_s * 1e6, 2),
            "bandwidth_us": round(self.bandwidth_s * 1e6, 2),
            "total_us": round(self.total_s * 1e6, 2),
        }


def _alpha(topo: Topology, hops: float, net: NetParams) -> float:
    sw_hops = max(hops - 2.0, 0.0)
    return (net.software_alpha + net.t_nic + sw_hops * net.t_switch
            + hops * net.t_prop_per_hop)


def ring_allreduce_time(topo: Topology, bytes_per_nic: float,
                        m: "int | None" = None,
                        net: NetParams = DEFAULT_NET) -> CollectiveEstimate:
    """Ring all-reduce over m endpoints: 2(m-1) steps of size S/m.  Ring
    neighbours are placed adjacently, so a step crosses the topology's
    minimum NIC-NIC distance (2 hops under one switch, else 3); the
    bandwidth term uses the full NIC bandwidth (all planes sprayed)."""
    m = m or topo.n_nics
    steps = 2 * (m - 1)
    chunk = bytes_per_nic / m
    # consecutive ring ranks share a switch p at a time
    same_switch = getattr(topo, "p", 1)
    hops = 2.0 if same_switch > 1 else 3.0
    lat = steps * _alpha(topo, hops, net)
    bw = steps * chunk / gbps_to_Bps(topo.nic_bw_gbps)
    return CollectiveEstimate("all_reduce", "ring", bytes_per_nic, steps,
                              hops, lat, bw)


def hierarchical_allreduce_time(topo: MPHX, bytes_per_nic: float,
                                net: NetParams = DEFAULT_NET
                                ) -> CollectiveEstimate:
    """MPHX-native hierarchical all-reduce: a reduce-scatter among the p
    NICs of each switch (2 hops a step), a direct exchange across each
    fully meshed dimension (reduce-scatter and all-gather, one switch hop
    each), then the all-gather among the p NICs.  Every plane carries 1/n
    of the bytes at once (plane spraying)."""
    p = topo.p
    lat = 0.0
    bw = 0.0
    steps = 0
    # stage 0: RS over p endpoints through their shared switch, a ring of p
    if p > 1:
        s = (p - 1)
        steps += 2 * s  # RS now + AG at the end
        lat += 2 * s * _alpha(topo, 2.0, net)
        bw += 2 * s * (bytes_per_nic / p) / gbps_to_Bps(topo.nic_bw_gbps)
    shard = bytes_per_nic / max(p, 1)
    # dimension stages: exchange within the full mesh (1 switch hop)
    for d in topo.dims:
        if d <= 1:
            continue
        # reduce-scatter + all-gather across d peers, direct mesh: 2 steps
        # each moving shard*(d-1)/d bytes
        steps += 2
        lat += 2 * _alpha(topo, 3.0, net)
        bw += 2 * shard * (d - 1) / d / gbps_to_Bps(topo.nic_bw_gbps)
        shard = shard / d
    return CollectiveEstimate("all_reduce", "mphx-hierarchical",
                              bytes_per_nic, steps, 3.0, lat, bw)


def hd_allreduce_time(topo: Topology, bytes_per_nic: float,
                      m: "int | None" = None,
                      net: NetParams = DEFAULT_NET) -> CollectiveEstimate:
    """Recursive halving-doubling all-reduce: 2*log2(m) steps.  Step k
    exchanges with a peer 2^k ranks away; each step is charged the mean
    of the minimum distance and the diameter."""
    m = m or topo.n_nics
    k = max(1, math.ceil(math.log2(m)))
    steps = 2 * k
    hops = (3.0 + float(topo.diameter)) / 2.0
    lat = steps * _alpha(topo, hops, net)
    bw = 2.0 * (m - 1) / m * bytes_per_nic / gbps_to_Bps(topo.nic_bw_gbps)
    return CollectiveEstimate("all_reduce", "halving-doubling",
                              bytes_per_nic, steps, hops, lat, bw)


def alltoall_time(topo: Topology, bytes_per_nic: float,
                  net: NetParams = DEFAULT_NET) -> CollectiveEstimate:
    """All-to-all of S bytes per NIC (total), uniform: bisection-bound."""
    frac = uniform_throughput_fraction(topo)
    eff = gbps_to_Bps(topo.nic_bw_gbps) * frac
    lat = _alpha(topo, float(topo.diameter), net)
    return CollectiveEstimate("all_to_all", "direct", bytes_per_nic, 1,
                              float(topo.diameter), lat, bytes_per_nic / eff)


def allgather_time(topo: Topology, bytes_per_nic: float,
                   m: "int | None" = None,
                   net: NetParams = DEFAULT_NET) -> CollectiveEstimate:
    m = m or topo.n_nics
    steps = m - 1
    hops = 3.0
    lat = steps * _alpha(topo, hops, net)
    bw = steps * (bytes_per_nic) / gbps_to_Bps(topo.nic_bw_gbps)
    return CollectiveEstimate("all_gather", "ring", bytes_per_nic, steps,
                              hops, lat, bw)


def allreduce_time(topo: Topology, bytes_per_nic: float,
                   net: NetParams = DEFAULT_NET) -> CollectiveEstimate:
    """The fastest all-reduce schedule available for the topology."""
    cands = [ring_allreduce_time(topo, bytes_per_nic, net=net),
             hd_allreduce_time(topo, bytes_per_nic, net=net)]
    if isinstance(topo, MPHX):
        cands.append(hierarchical_allreduce_time(topo, bytes_per_nic, net))
    return min(cands, key=lambda c: c.total_s)


def compare_topologies(topos: "list[Topology]", msg_bytes: float = 4096,
                       collective_mb: float = 256.0,
                       net: NetParams = DEFAULT_NET) -> "list[dict]":
    """One closed-form row per topology: diameter, hops, latencies,
    uniform throughput and the best all-reduce."""
    rows = []
    for t in topos:
        ar = allreduce_time(t, collective_mb * 2**20, net)
        rows.append({
            "topology": t.name,
            "diameter": t.diameter,
            "avg_hops": round(t.avg_hops(), 2),
            "zero_load_us": round(zero_load_latency(t, msg_bytes, net) * 1e6,
                                  3),
            "avg_latency_us": round(avg_latency(t, msg_bytes, net) * 1e6, 3),
            "uniform_thpt": round(uniform_throughput_fraction(t), 3),
            f"allreduce_{int(collective_mb)}MB_ms":
                round(ar.total_s * 1e3, 3),
            "allreduce_algo": ar.algo,
        })
    return rows
