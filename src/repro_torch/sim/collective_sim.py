"""Measured collective completion on the simulated fabric (port of
``repro/sim/collective_sim.py``).

Executes the chunked collective schedules of
:mod:`repro_torch.experiments.scenarios` as sprayed flow batches, so the
alpha-beta estimates of :mod:`repro_torch.core.netsim`
(``ring_allreduce_time`` / ``allgather_time`` / ``alltoall_time``) get a
*measured* counterpart: per-step flows route through the real fabric,
share links max-min fairly, and spray over planes with the NIC chunk
schedule (:func:`repro_torch.sim.spray.simulate_sprayed`, whole-chunk
rounding penalties included).

Ring collectives are steady-state symmetric (every step moves the same
flow pattern), so one step is simulated and scaled by the step count.
"""

from __future__ import annotations

import numpy as np

from ..core.hyperx import MPHX
from ..core.netsim import (DEFAULT_NET, NetParams, allgather_time,
                           alltoall_time, make_router, ring_allreduce_time)
from ..core.planes import SprayConfig
from ..core.topology import Topology
from .events import FlowSpec
from .spray import simulate_sprayed

SIM_COLLECTIVES = ("allreduce_ring", "allgather_ring", "alltoall")


def ring_participants(topo: Topology, graph=None) -> np.ndarray:
    """Switch-level ring order: all switches of one MPHX plane, or the
    NIC-bearing switches of a generic graph (the ring demands'
    convention)."""
    if isinstance(topo, MPHX):
        return np.arange(topo.switches_per_plane, dtype=np.int64)
    g = graph if graph is not None else topo.build_graph()
    return np.asarray(g.nic_nodes, dtype=np.int64)


def _step_flows(ring: np.ndarray, step_bytes: float) -> "list[FlowSpec]":
    nxt = np.roll(ring, -1)
    return [FlowSpec(int(s), int(d), step_bytes)
            for s, d in zip(ring, nxt) if s != d]


def _alltoall_flows(topo: Topology, ring: np.ndarray, bytes_per_nic: float,
                    nics_per_switch: int) -> "list[FlowSpec]":
    per_pair = nics_per_switch * bytes_per_nic / max(len(ring) - 1, 1)
    return [FlowSpec(int(s), int(d), per_pair)
            for s in ring for d in ring if s != d]


def simulate_collective(topo: Topology, kind: str, bytes_per_nic: float,
                        cfg: "SprayConfig | None" = None,
                        mode: str = "minimal",
                        net: NetParams = DEFAULT_NET,
                        engine: str = "auto", backend: "str | None" = None,
                        router=None, device=None) -> dict:
    """Measured completion of one collective vs. the analytic estimate.

    ``kind`` is one of :data:`SIM_COLLECTIVES` (the scenario registry's
    collective schedules).  Returns the reference's flat artifact row:
    ``measured_us``, the matching ``analytic_us`` closed form, and their
    ratio (>1 = the fabric under-delivers the alpha-beta model, e.g.
    spray rounding or link contention the closed form ignores).  Runs on
    ``router``'s device; without a router, on one made for ``topo`` on
    ``device`` (default ``cuda``).  ``backend`` is the solver's and the
    router's (``cuda`` or ``torch``).
    """
    if kind not in SIM_COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; "
                         f"known: {SIM_COLLECTIVES}")
    if router is None:
        router = make_router(topo, engine=engine, device=device)
    graph = getattr(router, "graph", None)
    ring = ring_participants(topo, graph)
    nics_per_switch = getattr(topo, "p", None) or (
        graph.nics_per_switch if graph is not None else 1)
    m = int(topo.n_nics)
    if kind == "allreduce_ring":
        steps = 2 * (m - 1)
        step_bytes = bytes_per_nic / m
        flows = _step_flows(ring, step_bytes)
        analytic = ring_allreduce_time(topo, bytes_per_nic, net=net)
    elif kind == "allgather_ring":
        steps = m - 1
        step_bytes = bytes_per_nic
        flows = _step_flows(ring, step_bytes)
        analytic = allgather_time(topo, bytes_per_nic, net=net)
    else:  # alltoall
        steps = 1
        step_bytes = bytes_per_nic
        flows = _alltoall_flows(topo, ring, bytes_per_nic, nics_per_switch)
        analytic = alltoall_time(topo, bytes_per_nic, net=net)
    res = simulate_sprayed(topo, flows, cfg=cfg, mode=mode, net=net,
                           backend=backend, router=router)
    step_s = res.makespan_s + net.software_alpha
    measured = steps * step_s
    return {
        "collective": kind,
        "topology": topo.name,
        "bytes_per_nic": int(bytes_per_nic),
        "steps": steps,
        "step_bytes": int(step_bytes),
        "sim_flows_per_step": len(flows),
        "measured_us": round(measured * 1e6, 3),
        "analytic_us": round(analytic.total_s * 1e6, 3),
        "analytic_algo": analytic.algo,
        "measured_over_analytic":
            round(measured / analytic.total_s, 4)
            if analytic.total_s > 0 else None,
    }
