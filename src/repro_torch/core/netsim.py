"""Flow-level (alpha-beta) network model: the parts of
``repro/core/netsim.py`` on the simulator's path.

Zero-load latency is ``hops * t_hop + serialization + propagation``;
:func:`load_sweep` adds routed utilization per offered load and, with
``simulate=True``, measured flow-completion times from the event loop
(:mod:`repro_torch.sim.events`).  Times are seconds, sizes bytes,
bandwidths Gbps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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


def avg_latency(topo: Topology, msg_bytes: float = 4096,
                net: NetParams = DEFAULT_NET) -> float:
    hops = topo.avg_hops()
    sw_hops = max(hops - 2.0, 0.0)
    ser = msg_bytes / gbps_to_Bps(topo.nic_bw_gbps)
    return net.t_nic + sw_hops * net.t_switch + hops * net.t_prop_per_hop + ser


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
