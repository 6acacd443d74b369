"""Vectorized HyperX routing on torch tensors (port of
``repro/core/routing_vec.py``, minimal mode).

A demand matrix is three parallel tensors ``(src, dst, gbps)``; the
directed links of one plane live in a flat *edge-slot* tensor indexed by
``(switch, dimension, target coordinate)`` (:class:`EdgeIndex`); minimal
path enumeration is a walk over the D! dimension orderings shared by all
demands, and link-load accounting is an ``index_add_`` over edge slots
(the reference's ``np.bincount`` / ``.at[].add``).

The reference's ``valiant`` and ``adaptive`` modes are not ported yet
(ROADMAP, queue 1).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

from .._device import resolve_device
from .hyperx import MPHX

F64 = torch.float64
I64 = torch.int64

NOT_PORTED_MODES = ("valiant", "adaptive")


def _mode_not_ported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"routing mode {mode!r} is not ported to repro_torch yet "
        "(ROADMAP.md, queue 1: valiant and adaptive routing); use "
        "mode='minimal'")


@dataclass
class EdgeIndex:
    """Flat index over the directed links of one MPHX plane.

    Slot of the link leaving switch ``u`` along dimension ``i`` toward
    in-dimension coordinate ``c``: ``dim_base[i] + u * dims[i] + c`` with
    ``dim_base[i] = S * sum(dims[:i])``.  Every dim-``i`` slot has capacity
    ``links_per_dim[i] / (dims[i] - 1) * port_gbps``.
    """

    topo: MPHX
    device: torch.device

    def __post_init__(self):
        t = self.topo
        self.D = len(t.dims)
        self.S = t.switches_per_plane
        base = [0]
        for d in t.dims[:-1]:
            base.append(base[-1] + self.S * d)
        self.dim_base = base
        self.n_slots = int(self.S * sum(t.dims))
        stride = [1] * self.D
        for i in range(self.D - 2, -1, -1):
            stride[i] = stride[i + 1] * t.dims[i + 1]
        self.stride = stride
        cap = torch.empty(self.n_slots, dtype=F64, device=self.device)
        for i, (d, l) in enumerate(zip(t.dims, t.links_per_dim)):
            mult = l / (d - 1) if d > 1 else 0.0
            cap[base[i]:base[i] + self.S * d] = mult * t.port_gbps
        self.capacity = cap

    def ids_to_coords(self, ids: torch.Tensor) -> torch.Tensor:
        """(M,) switch ids -> (M, D) coordinates."""
        out = torch.empty((ids.shape[0], self.D), dtype=I64,
                          device=ids.device)
        rem = ids.to(I64)
        for i in range(self.D - 1, -1, -1):
            d = self.topo.dims[i]
            out[:, i] = rem % d
            rem = rem // d
        return out

    def coords_to_ids(self, coords: torch.Tensor) -> torch.Tensor:
        return sum(coords[:, i] * s for i, s in enumerate(self.stride))

    def slots(self, u_ids, dim: int, c_target):
        return self.dim_base[dim] + u_ids * self.topo.dims[dim] + c_target


class ArrayLinkLoads:
    """Per-slot offered Gbps of one routed demand matrix."""

    def __init__(self, index: EdgeIndex, loads: torch.Tensor):
        self.index = index
        self.topo = index.topo
        self.loads = loads

    def capacity_array(self) -> torch.Tensor:
        return self.index.capacity

    def utilization_array(self) -> torch.Tensor:
        cap = self.capacity_array()
        return torch.where(cap > 0, self.loads / cap, 0.0)

    def max_utilization(self) -> float:
        u = self.utilization_array()
        return float(u.max()) if u.numel() else 0.0



@dataclass(frozen=True)
class DemandArrays:
    """A switch-level traffic matrix as three parallel tensors."""

    src: torch.Tensor    # (M,) int64 switch ids
    dst: torch.Tensor    # (M,) int64 switch ids
    gbps: torch.Tensor   # (M,) float64 offered Gbps per (src, dst) pair

    def __post_init__(self):
        if not (self.src.shape == self.dst.shape == self.gbps.shape):
            raise ValueError("src, dst and gbps must have one shape")

    @property
    def n(self) -> int:
        return int(self.src.shape[0])

    def total_gbps(self) -> float:
        return float(self.gbps.sum())


def _per_switch_out(topo: MPHX, offered_per_nic_gbps: float) -> float:
    # one plane's share of each switch's p NICs worth of injection
    return topo.p * offered_per_nic_gbps / topo.n


def uniform_demands(topo: MPHX, offered_per_nic_gbps: float,
                    device=None) -> DemandArrays:
    """All-pairs uniform spray."""
    dev = resolve_device(device)
    S = topo.switches_per_plane
    ar = torch.arange(S, dtype=I64, device=dev)
    s, d = torch.meshgrid(ar, ar, indexing="ij")
    mask = s != d
    src, dst = s[mask], d[mask]
    g = torch.full(src.shape, _per_switch_out(topo, offered_per_nic_gbps)
                   / (S - 1), dtype=F64, device=dev)
    return DemandArrays(src, dst, g)


def neighbor_shift_demands(topo: MPHX, offered_per_nic_gbps: float,
                           dim: int = 0, device=None) -> DemandArrays:
    """+1 shift along ``dim`` (adversarial for minimal routing, §5.2)."""
    dev = resolve_device(device)
    idx = EdgeIndex(topo, dev)
    src = torch.arange(topo.switches_per_plane, dtype=I64, device=dev)
    c = idx.ids_to_coords(src)
    c[:, dim] = (c[:, dim] + 1) % topo.dims[dim]
    dst = idx.coords_to_ids(c)
    g = torch.full(src.shape, _per_switch_out(topo, offered_per_nic_gbps),
                   dtype=F64, device=dev)
    return DemandArrays(src, dst, g)


class VectorizedHyperXRouter:
    """Array engine for routing whole demand matrices over one MPHX plane."""

    def __init__(self, topo: MPHX, device=None):
        self.topo = topo
        self.device = resolve_device(device)
        self.index = EdgeIndex(topo, self.device)

    def _prep(self, demands: DemandArrays):
        src = demands.src.to(self.device, I64)
        dst = demands.dst.to(self.device, I64)
        gbps = demands.gbps.to(self.device, F64)
        return (src, dst, gbps, self.index.ids_to_coords(src),
                self.index.ids_to_coords(dst))

    def _iter_minimal_hops(self, src, cs, cd):
        """Yield ``(slots, mask)`` per hop of every D! full-dimension
        ordering — the one minimal walk behind both :meth:`route_minimal`
        and :meth:`incidence`."""
        idx = self.index
        for perm in itertools.permutations(range(idx.D)):
            cur_id = src.clone()
            cur = cs.clone()
            for i in perm:
                mask = cur[:, i] != cd[:, i]
                if bool(mask.any()):
                    yield idx.slots(cur_id, i, cd[:, i]), mask
                cur_id = cur_id + (cd[:, i] - cur[:, i]) * idx.stride[i]
                cur[:, i] = cd[:, i]

    def route(self, demands: DemandArrays, mode: str = "minimal"
              ) -> ArrayLinkLoads:
        if mode == "minimal":
            return self.route_minimal(demands)
        if mode in NOT_PORTED_MODES:
            raise _mode_not_ported(mode)
        raise ValueError(f"unknown mode {mode}")

    def route_minimal(self, demands: DemandArrays) -> ArrayLinkLoads:
        """Minimal ECMP loads: each of the D! orderings carries
        ``gbps / D!`` (a path over m mismatched dims is induced by D!/m!
        orderings, so it carries ``gbps / m!``)."""
        src, _, gbps, cs, cd = self._prep(demands)
        w = gbps / math.factorial(self.index.D)
        loads = torch.zeros(self.index.n_slots, dtype=F64, device=self.device)
        for slots, mask in self._iter_minimal_hops(src, cs, cd):
            loads.index_add_(0, slots[mask], w[mask])
        return ArrayLinkLoads(self.index, loads)

    def incidence(self, demands: DemandArrays, mode: str = "minimal"):
        """Per-flow edge incidence ``(flow, slot, frac)`` (int64, int64,
        float64 tensors): ``frac`` is the fraction of flow ``flow``'s rate
        carried on edge slot ``slot``.

        Entries are coalesced to one per (flow, slot) and sorted by
        ``flow * n_slots + slot`` — the reference's order, which is the
        summation order of every reduction downstream.
        """
        if mode == "valiant":
            raise _mode_not_ported(mode)
        if mode != "minimal":
            raise ValueError(
                f"no static per-flow incidence for mode {mode!r} "
                "(adaptive re-routes under load); use minimal")
        src, _, _, cs, cd = self._prep(demands)
        w = 1.0 / math.factorial(self.index.D)
        flows, slots_l = [], []
        for slots, mask in self._iter_minimal_hops(src, cs, cd):
            flows.append(mask.nonzero().squeeze(1))
            slots_l.append(slots[mask])
        if not flows:
            z = torch.zeros(0, dtype=I64, device=self.device)
            return z, z.clone(), torch.zeros(0, dtype=F64, device=self.device)
        flow = torch.cat(flows)
        slot = torch.cat(slots_l)
        n_slots = self.index.n_slots
        uniq, inv = torch.unique(flow * n_slots + slot, sorted=True,
                                 return_inverse=True)
        frac = torch.zeros(uniq.numel(), dtype=F64, device=self.device)
        frac.index_add_(0, inv, torch.full(inv.shape, w, dtype=F64,
                                           device=self.device))
        return uniq // n_slots, uniq % n_slots, frac

    def mean_switch_hops(self) -> float:
        """Expected switch-switch minimal hops over uniform NIC pairs."""
        return float(sum((d - 1) / d for d in self.topo.dims if d > 1))

    def edge_capacity(self) -> torch.Tensor:
        """(n_slots,) per-edge-slot capacity in Gbps."""
        return self.index.capacity
