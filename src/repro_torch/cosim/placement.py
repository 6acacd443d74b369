"""Rank -> NIC -> switch placement and per-phase flow construction (port
of ``repro/cosim/placement.py``).

Ranks are laid out linearly over NICs (rank ``r`` on NIC ``r``), so a
stride-1 mesh axis packs onto as few switches as possible: a TP group of
size <= p disappears into one switch and costs no fabric traffic.  On
MPHX the NIC's switch comes from the coordinate layout (``p`` NICs a
switch a plane); on graph topologies from the switch graph's
``nic_nodes`` order.  :func:`mphx_rank_layout` is the mapping-guided
alternative (:func:`repro_torch.core.mapping.best_mapping`).

Ring collectives are steady-state symmetric, so one step's flows (all
concurrent groups of the phase at once: that is where the contention
is) are built and the step simulation is scaled by the step count.
Parallel rank pairs that land on one switch pair merge into one flow
whose bytes add in rank order, as the reference's dict does.

Host arithmetic on numpy arrays and Python numbers: the flows are
:class:`~repro_torch.sim.events.FlowSpec` lists that the simulator moves
to its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.hyperx import MPHX
from ..core.topology import Topology
from ..sim.events import FlowSpec
from .traffic import CollectivePhase

RING_STEPS = {
    # step count and per-step bytes as a function of (size, bytes_per_rank)
    "allreduce": lambda m, b: (2 * (m - 1), b / m),
    "allgather": lambda m, b: (m - 1, b),
    "reducescatter": lambda m, b: (m - 1, b),
}


def rank_to_switch(topo: Topology, graph=None) -> np.ndarray:
    """(n_nics,) per-plane switch id hosting each rank's NIC."""
    if isinstance(topo, MPHX):
        return np.repeat(np.arange(topo.switches_per_plane, dtype=np.int64),
                         topo.p)
    g = graph if graph is not None else topo.build_graph()
    nodes = np.asarray(g.nic_nodes, dtype=np.int64)
    return np.repeat(nodes, g.nics_per_switch)


@dataclass
class MappedLayout:
    """Mapping-guided placement: rank -> NIC plus per-axis level splits.

    ``factors[axis]`` lists the axis's level factors in fastest-varying
    digit order (switch level first when present): the chain
    :func:`repro_torch.cosim.traffic.decompose_phase` turns into
    hierarchical sub-collectives.  ``dp`` is the concatenation of the
    ``ep`` and residual-dp chains (``ep`` is ``dp``'s fast sub-axis).
    """

    nic: np.ndarray               # (n_ranks,) NIC id per rank
    factors: dict                 # axis name -> list of (f, rank_stride)


def mphx_rank_layout(topo: MPHX, job, net=None) -> MappedLayout:
    """Mapping-guided rank -> NIC layout for MPHX.

    Runs :func:`repro_torch.core.mapping.best_mapping` over the job's
    per-axis traffic (tp / ep / residual-dp axes, bytes summed from the
    phases) and realizes the winning level assignment as a mixed-radix
    NIC numbering: an axis on the switch level varies the NIC port under
    one switch, an axis on dimension ``i`` varies that coordinate.  An
    axis that fits no level raises ``ValueError``.
    """
    from ..core.mapping import AxisTraffic, best_mapping, mphx_levels
    from ..core.netsim import DEFAULT_NET

    net = net or DEFAULT_NET
    tp = job.mesh.get("tp", 1)
    ep = job.mesh.get("ep", 1)
    dp = job.mesh.get("dp", 1)
    dpo = dp // max(ep, 1)
    r = np.arange(job.n_ranks)
    axis_index = {"tp": r % tp, "ep": (r // tp) % max(ep, 1),
                  "dpo": r // (tp * max(ep, 1))}
    axis_size = {"tp": tp, "ep": ep, "dpo": dpo}
    kind_key = {"allreduce": "allreduce_bytes",
                "allgather": "allgather_bytes",
                "reducescatter": "allgather_bytes",
                "alltoall": "alltoall_bytes"}
    traffic = {}
    for ph in job.phases:
        if (ph.size, ph.stride) == (tp, 1):
            name = "tp"
        elif (ph.size, ph.stride) == (ep, tp):
            name = "ep"
        else:
            name = "dpo"   # dp-spanning phases ride the residual-dp axis
        t = traffic.setdefault(name, {"allreduce_bytes": 0.0,
                                      "allgather_bytes": 0.0,
                                      "alltoall_bytes": 0.0, "calls": 1})
        t[kind_key[ph.kind]] += ph.calls * ph.bytes_per_rank
        t["calls"] = max(t["calls"], ph.calls)
    axes = [AxisTraffic(name, axis_size[name], **traffic.get(name, {}))
            for name in ("tp", "ep", "dpo") if axis_size[name] > 1]
    mapping = best_mapping(topo, axes, net=net)
    levels = mphx_levels(topo)
    level_digit = np.zeros((job.n_ranks, len(levels)), dtype=np.int64)
    level_mult = [1] * len(levels)
    axis_stride = {"tp": 1, "ep": tp, "dpo": tp * max(ep, 1)}
    factors = {name: [] for name in ("tp", "ep", "dpo")}
    for ax in axes:   # the traffic-descending order best_mapping used
        rem = axis_index[ax.name].copy()
        stride = axis_stride[ax.name]
        for li, f in mapping.assignment[ax.name]:
            level_digit[:, li] += (rem % f) * level_mult[li]
            level_mult[li] *= f
            factors[ax.name].append((f, stride))
            stride *= f
            rem //= f
    # dp spans the ep chain (fast) then the residual-dp chain
    factors["dp"] = factors["ep"] + factors["dpo"]
    port = level_digit[:, 0]
    dim_of_level = [i for i, d in enumerate(topo.dims) if d > 1]
    coords = np.zeros((job.n_ranks, len(topo.dims)), dtype=np.int64)
    for li, di in enumerate(dim_of_level, start=1):
        coords[:, di] = level_digit[:, li]
    switch = np.zeros(job.n_ranks, dtype=np.int64)
    for di, d in enumerate(topo.dims):
        switch = switch * d + coords[:, di]
    return MappedLayout(switch * topo.p + port, factors)


def group_members(n_ranks: int, size: int, stride: int) -> "list[list[int]]":
    """All groups of a mesh axis with the given (size, stride) tiling."""
    span = size * stride
    if n_ranks % span:
        raise ValueError(f"size*stride {span} does not tile {n_ranks} ranks")
    return [[outer * span + inner + k * stride for k in range(size)]
            for outer in range(n_ranks // span)
            for inner in range(stride)]


def _merge_pairs(pairs: dict, start_s: float
                 ) -> "tuple[list[FlowSpec], np.ndarray]":
    keys = sorted(pairs)
    flows = [FlowSpec(s, d, pairs[(s, d)][0], start_s) for s, d in keys]
    senders = np.array([len(pairs[k][1]) for k in keys], dtype=np.int64)
    return flows, senders


def _add(pairs: dict, s: int, d: int, b: float, rank: int) -> None:
    rec = pairs.setdefault((s, d), [0.0, set()])
    rec[0] += b
    rec[1].add(rank)


def phase_step_flows(phase: CollectivePhase, switch_of: np.ndarray,
                     n_ranks: int, start_s: float = 0.0
                     ) -> "tuple[list[FlowSpec], int, np.ndarray]":
    """(one step's flows across all groups, step count, senders per flow).

    Ring kinds emit each group's rank ``k -> k+1`` neighbour flow for one
    steady-state step; all-to-all emits the full direct exchange (one
    step).  Same-switch rank pairs produce no fabric flow: they ride the
    intra-switch path the 2-hop alpha already covers.  Parallel rank
    pairs on one switch pair merge into one flow carrying the summed
    bytes (added in rank order); the per-flow sender count sizes that
    flow's injection cap (``senders x port_gbps``: a merged flow is an
    aggregate of that many NIC ports).
    """
    groups = group_members(n_ranks, phase.size, phase.stride)
    sw = np.asarray(switch_of).tolist()
    pairs: dict = {}
    if phase.kind in RING_STEPS:
        steps, step_bytes = RING_STEPS[phase.kind](phase.size,
                                                   phase.bytes_per_rank)
        for members in groups:
            m = len(members)
            for k, r in enumerate(members):
                s = sw[r]
                d = sw[members[(k + 1) % m]]
                if s != d:
                    _add(pairs, s, d, step_bytes, r)
        flows, senders = _merge_pairs(pairs, start_s)
        return flows, int(steps), senders
    # alltoall: direct exchange, bytes_per_rank spread over the m-1 peers
    per_peer = phase.bytes_per_rank / max(phase.size - 1, 1)
    for members in groups:
        for r in members:
            s = sw[r]
            for q in members:
                if q == r:
                    continue
                d = sw[q]
                if s != d:
                    _add(pairs, s, d, per_peer, r)
    flows, senders = _merge_pairs(pairs, start_s)
    return flows, 1, senders
