"""Logical mesh -> physical MPHX placement (a copy of
``repro/core/mapping.py``).

A training job's logical mesh axes (tensor, expert and data parallel)
produce distinct collective traffic per axis.  The physical
MPHX(n, p, D_1..D_D) fabric offers hop-count / bandwidth trade-offs per
level: the NICs under one switch (p-way, 2 hops) and each dimension's
full mesh (D_i-way, 3 hops, link multiplicity ``links_i / (D_i - 1)``).

:func:`best_mapping` assigns the logical axes to the physical levels,
scoring each factorization with the alpha-beta model of
:mod:`repro_torch.core.netsim` weighted by the axis's bytes a step: the
bandwidth-hungry axes land on the switch level or a trunked dimension,
the latency-sensitive small-collective axes on the sparse dimensions
(the paper's §5.2 guidance).

Host arithmetic on Python numbers: nothing here touches a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .hyperx import MPHX
from .netsim import DEFAULT_NET, NetParams, _alpha, gbps_to_Bps


@dataclass(frozen=True)
class AxisTraffic:
    """Bytes each device moves per train step for one logical axis."""

    name: str
    size: int                    # axis length (devices)
    allreduce_bytes: float = 0.0  # per step (e.g. grads for data axis)
    allgather_bytes: float = 0.0  # per step (e.g. ZeRO params / TP acts)
    alltoall_bytes: float = 0.0   # per step (EP dispatch)
    calls: int = 1                # collectives issued per step (alpha count)


@dataclass(frozen=True)
class Level:
    """One level of the MPHX physical hierarchy."""

    kind: str                    # "switch" | "dim"
    size: int                    # fanout of the level
    hops: float                  # NIC-to-NIC hops within the level
    rel_bandwidth: float         # per-endpoint-pair bandwidth multiplier


def mphx_levels(topo: MPHX) -> "list[Level]":
    """The switch level, then one level per dimension wider than 1."""
    levels = [Level("switch", topo.p, 2.0, 1.0)]
    for d, links in zip(topo.dims, topo.links_per_dim):
        if d <= 1:
            continue
        # per-plane pairwise trunk / port bandwidth, all planes sprayed
        levels.append(Level("dim", d, 3.0, links / (d - 1)))
    return levels


def axis_time_on_level(ax: AxisTraffic, lvl: Level, topo: MPHX,
                       net: NetParams = DEFAULT_NET) -> float:
    """Alpha-beta time for one axis's per-step traffic on one level."""
    B = gbps_to_Bps(topo.nic_bw_gbps)
    t = 0.0
    m = ax.size
    if ax.allreduce_bytes:
        steps = 2 * (m - 1)
        t += ax.calls * steps * _alpha(topo, lvl.hops, net)
        t += 2 * (m - 1) / m * ax.allreduce_bytes / B
    if ax.allgather_bytes:
        steps = m - 1
        t += ax.calls * steps * _alpha(topo, lvl.hops, net)
        t += (m - 1) / m * ax.allgather_bytes / B
    if ax.alltoall_bytes:
        t += ax.calls * _alpha(topo, lvl.hops, net)
        # direct exchange rides the level's pairwise trunks; the full mesh
        # of a HyperX dim serves A2A at full injection (rel_bandwidth >= 1)
        t += ax.alltoall_bytes / (B * min(lvl.rel_bandwidth * lvl.size /
                                          max(m - 1, 1), 1.0))
    return t


@dataclass
class Mapping:
    assignment: dict             # axis name -> list of (level index, factor)
    time_s: float
    detail: dict = field(default_factory=dict)


def _factorizations(size: int, capacities: "list[int]"):
    """Yield the ways to split ``size`` across levels (a factor a level,
    product ``size``, each factor at most the level's capacity)."""
    if size == 1:
        yield [1] * len(capacities)
        return
    if not capacities:
        return
    f = 1
    while f <= min(size, capacities[0]):
        if size % f == 0:
            for rest in _factorizations(size // f, capacities[1:]):
                yield [f] + rest
        f += 1


def best_mapping(topo: MPHX, axes: "list[AxisTraffic]",
                 net: NetParams = DEFAULT_NET) -> Mapping:
    """Assign each logical axis to physical levels minimizing the summed
    collective time.  Axes are placed greedily from most traffic to
    least, consuming level capacity; within an axis every factorization
    is tried.  An axis that fits no factorization raises ``ValueError``
    naming the remaining capacities."""
    levels = mphx_levels(topo)
    caps = [lvl.size for lvl in levels]
    order = sorted(axes, key=lambda a: -(a.allreduce_bytes
                                         + a.allgather_bytes
                                         + a.alltoall_bytes))
    assignment, detail = {}, {}
    total = 0.0
    for ax in order:
        best = None
        for fac in _factorizations(ax.size, caps):
            # the axis's phases run one level after another: sum the
            # levels it spans (factor > 1)
            t = 0.0
            for f, lvl in zip(fac, levels):
                if f > 1:
                    sub = AxisTraffic(ax.name, f, ax.allreduce_bytes,
                                      ax.allgather_bytes, ax.alltoall_bytes,
                                      ax.calls)
                    t += axis_time_on_level(sub, lvl, topo, net)
            if best is None or t < best[0]:
                best = (t, fac)
        if best is None:
            raise ValueError(
                f"axis {ax.name} (size {ax.size}) does not fit on {topo.name}"
                f" remaining capacity {caps}")
        t, fac = best
        total += t
        assignment[ax.name] = [(i, f) for i, f in enumerate(fac) if f > 1]
        detail[ax.name] = t
        caps = [c // f for c, f in zip(caps, fac)]
    return Mapping(assignment, total, detail)


def traffic_from_model(param_bytes: float, act_bytes_per_layer: float,
                       n_layers: int, ep_bytes: float,
                       mesh_shape: dict) -> "list[AxisTraffic]":
    """Per-axis traffic records from model-level quantities.

    * data axis: one gradient all-reduce of ``param_bytes`` plus the
      ZeRO parameter all-gathers (``param_bytes`` a step);
    * model axis: 2 activation all-gathers and 2 reduce-scatters a layer
      (~4 x the activation bytes a layer) and the EP all-to-all;
    * pod axis: the cross-pod gradient all-reduce of ``param_bytes``.
    """
    axes = []
    if mesh_shape.get("model", 1) > 1:
        axes.append(AxisTraffic(
            "model", mesh_shape["model"],
            allgather_bytes=4 * act_bytes_per_layer * n_layers,
            alltoall_bytes=ep_bytes, calls=4 * n_layers))
    if mesh_shape.get("data", 1) > 1:
        axes.append(AxisTraffic(
            "data", mesh_shape["data"],
            allreduce_bytes=param_bytes,
            allgather_bytes=param_bytes, calls=2 * n_layers))
    if mesh_shape.get("pod", 1) > 1:
        axes.append(AxisTraffic(
            "pod", mesh_shape["pod"], allreduce_bytes=param_bytes, calls=1))
    return axes
