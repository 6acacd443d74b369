"""Vectorized HyperX routing on torch tensors (port of
``repro/core/routing_vec.py``).

A demand matrix is three parallel tensors ``(src, dst, gbps)``; the
directed links of one plane live in a flat *edge-slot* tensor indexed by
``(switch, dimension, target coordinate)`` (:class:`EdgeIndex`).  Three
routing modes, the reference's:

* ``minimal``: ECMP over the D! dimension orderings shared by all
  demands;
* ``valiant``: the minimal paths plus every single-deroute DAL path, the
  load split equally over them;
* ``adaptive``: parallel UGAL/DAL, ``granularity`` quantum rounds in
  which ``sub_batches`` interleaved groups of demands each place one
  quantum on their least-bottlenecked candidate, the loads refreshed
  between groups.

Static link loads are an ``index_add_`` over edge slots (the reference's
``np.bincount``).  The two reductions whose order decides a result, the
adaptive router's load update (a flipped last bit can move a quantum
onto another path) and the coalescing of an incidence's duplicate
``(flow, slot)`` entries, add in a fixed order (:func:`ordered_sum`):
on the CPU in entry order, which is the reference's numpy order bit for
bit; on the card through the segment-sum kernel over a stable sort
(``backend="cuda"``) or its ordered twin (``backend="torch"``), which
agree bit for bit.  Neither uses float64 atomics.
"""

from __future__ import annotations

import itertools
import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device, resolve_sim_backend
from ..kernels.segment_fairshare import (make_plan, segment_sum,
                                         segment_sum_ordered_ref,
                                         segment_sum_ref)
from ..telemetry import MetricsRegistry, get_metrics
from .hyperx import MPHX

F64 = torch.float64
I64 = torch.int64


def div_scalar(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as numpy divides.  On the card ``x / d``
    with a Python number multiplies by its reciprocal, which rounds
    twice; a divisor tensor on ``x``'s device is divided by."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def ordered_sum(values: torch.Tensor, ids: torch.Tensor, n: int,
                backend: str, plan=None) -> torch.Tensor:
    """(n,) sums of ``values`` by ``ids`` in a fixed order.

    On the CPU every bin adds its entries one by one in entry order from
    +0.0 (``index_add_`` into zeros: the bits of the reference's
    ``np.bincount`` and ``np.add.at``), whatever the backend.  On the
    card the entries go in the order of a stable sort of ``ids``: the
    segment-sum kernel (``cuda``) or its ordered twin on the same plan
    (``torch``), which give the same bits.  ``plan`` (a
    :class:`~repro_torch.kernels.segment_fairshare.SegmentPlan` of
    ``ids``, card only) replaces the one built for the call; at one lane
    a segment it adds each bin's entries one by one in entry order, the
    CPU's bits.
    """
    if backend == "cuda":
        return segment_sum(values, ids, n, plan=plan)
    if values.is_cuda:
        return segment_sum_ordered_ref(values, make_plan(ids, n)
                                       if plan is None else plan)
    return segment_sum_ref(values, ids, n)


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

    def slot_to_edge(self, slot: int) -> "tuple[int, int]":
        """Flat slot -> directed (u, v) switch pair."""
        dim = max(i for i, b in enumerate(self.dim_base) if b <= slot)
        u, c = divmod(slot - self.dim_base[dim], self.topo.dims[dim])
        coord = list(self.topo.id_to_coord(u))
        coord[dim] = c
        return u, self.topo.coord_to_id(tuple(coord))


class BaseLinkLoads:
    """Result API shared by the routing engines: per-link ``loads``
    (offered Gbps) and :meth:`capacity_array` (Gbps) on one device."""

    loads: torch.Tensor

    def capacity_array(self) -> torch.Tensor:
        raise NotImplementedError

    def utilization_array(self) -> torch.Tensor:
        cap = self.capacity_array()
        return torch.where(cap > 0, self.loads / cap, 0.0)

    def max_utilization(self) -> float:
        u = self.utilization_array()
        return float(u.max()) if u.numel() else 0.0

    def mean_utilization(self) -> float:
        """Mean utilization over the loaded links."""
        u = self.utilization_array()[self.loads > 0]
        return float(u.mean()) if u.numel() else 0.0

    def saturation_throughput(self, offered_per_nic_gbps: float = 0.0
                              ) -> float:
        mx = self.max_utilization()
        return 1.0 if mx == 0 else min(1.0, 1.0 / mx)

    def total_load(self) -> float:
        return float(self.loads.sum())


class ArrayLinkLoads(BaseLinkLoads):
    """Per-slot offered Gbps of one routed demand matrix."""

    def __init__(self, index: EdgeIndex, loads: torch.Tensor):
        self.index = index
        self.topo = index.topo
        self.loads = loads

    def capacity_array(self) -> torch.Tensor:
        return self.index.capacity

    def to_dict(self) -> "dict[tuple[int, int], float]":
        """Nonzero loads as ``{(u, v): gbps}``."""
        nz = torch.nonzero(self.loads).squeeze(1)
        return {self.index.slot_to_edge(s): float(self.loads[s])
                for s in nz.tolist()}


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


def bit_complement_demands(topo: MPHX, offered_per_nic_gbps: float,
                           device=None) -> DemandArrays:
    """Coordinate-complement permutation (every demand crosses the whole
    fabric); switches that are their own complement send nothing."""
    dev = resolve_device(device)
    idx = EdgeIndex(topo, dev)
    src = torch.arange(topo.switches_per_plane, dtype=I64, device=dev)
    c = idx.ids_to_coords(src)
    top = torch.tensor(topo.dims, dtype=I64, device=dev) - 1
    dst = idx.coords_to_ids(top[None, :] - c)
    keep = dst != src
    g = torch.full(src.shape, _per_switch_out(topo, offered_per_nic_gbps),
                   dtype=F64, device=dev)
    return DemandArrays(src[keep], dst[keep], g[keep])


def transpose_demands(topo: MPHX, offered_per_nic_gbps: float,
                      device=None) -> DemandArrays:
    """Matrix-transpose permutation: swap the first two (equal) dims.
    Defined when the topology has >= 2 dimensions and ``dims[0] ==
    dims[1]``; ``ValueError`` otherwise."""
    if topo.D < 2 or topo.dims[0] != topo.dims[1]:
        raise ValueError(f"transpose undefined for dims={topo.dims}")
    dev = resolve_device(device)
    idx = EdgeIndex(topo, dev)
    src = torch.arange(topo.switches_per_plane, dtype=I64, device=dev)
    c = idx.ids_to_coords(src)
    ct = c.clone()
    ct[:, 0], ct[:, 1] = c[:, 1], c[:, 0]
    dst = idx.coords_to_ids(ct)
    keep = dst != src
    g = torch.full(src.shape, _per_switch_out(topo, offered_per_nic_gbps),
                   dtype=F64, device=dev)
    return DemandArrays(src[keep], dst[keep], g[keep])


def hotspot_demands(topo: MPHX, offered_per_nic_gbps: float, hot: int = 0,
                    hot_fraction: float = 0.5, device=None) -> DemandArrays:
    """Every switch sends ``hot_fraction`` of its load to one hot switch and
    sprays the rest uniformly: the uniform rows, then the hot rows, so a
    ``(src, hot)`` pair appears twice."""
    dev = resolve_device(device)
    uni = uniform_demands(topo, offered_per_nic_gbps * (1 - hot_fraction),
                          device=dev)
    src = torch.arange(topo.switches_per_plane, dtype=I64, device=dev)
    keep = src != hot
    g = torch.full(src.shape, _per_switch_out(topo, offered_per_nic_gbps)
                   * hot_fraction, dtype=F64, device=dev)
    return DemandArrays(
        torch.cat([uni.src, src[keep]]),
        torch.cat([uni.dst, torch.full((int(keep.sum()),), hot, dtype=I64,
                                       device=dev)]),
        torch.cat([uni.gbps, g[keep]]))


def ring_demands(topo: MPHX, offered_per_nic_gbps: float,
                 device=None) -> DemandArrays:
    """Steady-state link pattern of a switch-id-ordered ring collective
    (ring all-reduce / all-gather): switch s -> s+1 mod S at full rate."""
    dev = resolve_device(device)
    S = topo.switches_per_plane
    src = torch.arange(S, dtype=I64, device=dev)
    g = torch.full((S,), _per_switch_out(topo, offered_per_nic_gbps),
                   dtype=F64, device=dev)
    return DemandArrays(src, (src + 1) % S, g)


class IncidenceCacheMixin:
    """Pair-level cache of per-flow incidence extraction.

    A fixed path spread depends only on the (src, dst) switch pair and
    the mode, not on the offered Gbps, so a pair's ``(edges, fracs)``
    rows can be replayed across flow sets: :meth:`incidence_cached`
    walks only pairs never seen before.  The cache's tensors stay on the
    router's device.

    Counters, in the router's own registry (``router.metrics``) and
    mirrored into the ambient one (:func:`repro_torch.telemetry.
    get_metrics`): ``incidence.walks`` counts engine walks (full
    :meth:`incidence` calls), ``incidence.cache_hits`` /
    ``incidence.cache_misses`` the pairs served from / added to the
    cache.  ``incidence_calls`` is a deprecated alias of the walk
    counter.  :meth:`reset_incidence_cache` empties the cache.
    """

    @property
    def metrics(self):
        """This router's private metrics registry (lazy)."""
        m = getattr(self, "_metrics", None)
        if m is None:
            m = self._metrics = MetricsRegistry()
        return m

    @metrics.setter
    def metrics(self, registry) -> None:
        self._metrics = registry

    @property
    def incidence_calls(self) -> int:
        """Deprecated alias of ``metrics.value("incidence.walks")``."""
        return int(self.metrics.value("incidence.walks"))

    @incidence_calls.setter
    def incidence_calls(self, value: int) -> None:
        warnings.warn(
            "incidence_calls is deprecated; use "
            "router.metrics.value('incidence.walks')",
            DeprecationWarning, stacklevel=2)
        self.metrics.set_counter("incidence.walks", int(value))

    def _count_walk(self) -> None:
        self.metrics.inc("incidence.walks")
        get_metrics().inc("incidence.walks")

    def _count_cache(self, hits: int, misses: int) -> None:
        for reg in (self.metrics, get_metrics()):
            reg.inc("incidence.cache_hits", hits)
            reg.inc("incidence.cache_misses", misses)

    def _pair_cache(self, mode: str) -> dict:
        if not hasattr(self, "_inc_cache"):
            self._inc_cache: dict = {}
        return self._inc_cache.setdefault(mode, {})

    def reset_incidence_cache(self) -> None:
        self._inc_cache = {}

    def incidence_cached(self, demands: "DemandArrays", mode: str = "minimal",
                         backend: "str | None" = None):
        """:meth:`incidence`, walking only the (src, dst) pairs not in the
        cache; cached pairs' rows are replayed.  Rows grouped by flow in
        flow order, each flow's rows in its pair's order."""
        cache = self._pair_cache(mode)
        dev = self.device
        src = demands.src.to(dev, I64)
        dst = demands.dst.to(dev, I64)
        n = int(src.shape[0])
        uniq, inv = torch.unique(torch.stack([src, dst], 1), dim=0,
                                 return_inverse=True)
        pairs = [tuple(p) for p in uniq.tolist()]
        miss = [p for p in pairs if p not in cache]
        self._count_cache(hits=len(pairs) - len(miss), misses=len(miss))
        if miss:
            ma = torch.tensor(miss, dtype=I64, device=dev)
            sub = DemandArrays(ma[:, 0], ma[:, 1],
                               torch.ones(len(miss), dtype=F64, device=dev))
            f, s, fr = self.incidence(sub, mode, backend=backend)
            order = torch.sort(f, stable=True).indices
            f, s, fr = f[order], s[order], fr[order]
            bounds = torch.searchsorted(
                f, torch.arange(len(miss) + 1, device=dev)).tolist()
            for j, p in enumerate(miss):
                cache[p] = (s[bounds[j]:bounds[j + 1]],
                            fr[bounds[j]:bounds[j + 1]])
        per_pair = [cache[p] for p in pairs]
        counts = torch.tensor([e.numel() for e, _ in per_pair], dtype=I64,
                              device=dev)
        if n == 0 or int(counts[inv].sum()) == 0:
            z = torch.zeros(0, dtype=I64, device=dev)
            return z, z.clone(), torch.zeros(0, dtype=F64, device=dev)
        flow = torch.repeat_interleave(torch.arange(n, device=dev),
                                       counts[inv])
        rows = inv.tolist()
        edge = torch.cat([per_pair[j][0] for j in rows])
        frac = torch.cat([per_pair[j][1] for j in rows])
        return flow, edge, frac


class VectorizedHyperXRouter(IncidenceCacheMixin):
    """Array engine for routing whole demand matrices over one MPHX plane.

    ``route`` and ``incidence`` take the ``backend`` of their fixed-order
    sums (:func:`ordered_sum`): ``cuda`` (the segment-sum kernel on the
    card, the default) or ``torch`` (its ordered twin).
    """

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

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.index.n_slots, dtype=F64, device=self.device)

    def _iter_minimal_hops(self, src, cs, cd):
        """Yield ``(slots, mask)`` per hop of every D! full-dimension
        ordering: the one minimal walk behind :meth:`route_minimal`,
        :meth:`route_valiant` and :meth:`incidence`."""
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

    def _iter_deroute_hops(self, src, cs, cd, mism):
        """Yield ``(slots, mask)`` per hop of every single-deroute DAL path
        (src -> dim ``i`` := ``via`` -> fix dims in index order), shared by
        :meth:`route_valiant` and :meth:`incidence`."""
        idx = self.index
        for i in range(idx.D):
            for via in range(self.topo.dims[i]):
                mask = mism[:, i] & (cs[:, i] != via) & (cd[:, i] != via)
                if not bool(mask.any()):
                    continue
                yield idx.slots(src, i, torch.full_like(src, via)), mask
                cur_id = src + (via - cs[:, i]) * idx.stride[i]
                cur = cs.clone()
                cur[:, i] = via
                for j in range(idx.D):
                    step = mask & (cur[:, j] != cd[:, j])
                    if bool(step.any()):
                        yield idx.slots(cur_id, j, cd[:, j]), step
                    cur_id = cur_id + (cd[:, j] - cur[:, j]) * idx.stride[j]
                    cur[:, j] = cd[:, j]

    def _mismatch_stats(self, cs, cd):
        """Per demand: mismatched dims (M, D), their count m, the m!
        minimal paths and the single deroutes."""
        mism = cs != cd
        m = mism.sum(dim=1)
        fact = torch.tensor([math.factorial(k)
                             for k in range(self.index.D + 1)],
                            dtype=I64, device=cs.device)
        n_minimal = fact[m]
        spare = torch.tensor([max(d - 2, 0) for d in self.topo.dims],
                             dtype=I64, device=cs.device)
        n_deroute = (mism * spare[None, :]).sum(dim=1)
        return mism, m, n_minimal, n_deroute

    def _valiant_weights(self, src, dst, cs, cd):
        """The valiant split: ``(mism, n_minimal, n_paths)`` with
        ``n_paths`` float64; ``ValueError`` on a ``src == dst`` demand."""
        if bool((src == dst).any()):
            raise ValueError("valiant routing expects src != dst demands")
        mism, _, n_minimal, n_deroute = self._mismatch_stats(cs, cd)
        return mism, n_minimal.to(F64), (n_minimal + n_deroute).to(F64)

    # ------------------------------------------------------------- modes ----

    def route(self, demands: DemandArrays, mode: str = "minimal",
              granularity: int = 8, backend: "str | None" = None
              ) -> ArrayLinkLoads:
        """Link loads of ``demands`` in ``mode``; ``backend`` is the
        adaptive router's reduction backend."""
        if mode == "minimal":
            return self.route_minimal(demands)
        if mode == "valiant":
            return self.route_valiant(demands)
        if mode == "adaptive":
            return self.route_adaptive(demands, granularity, backend=backend)
        raise ValueError(f"unknown mode {mode}")

    def route_minimal(self, demands: DemandArrays) -> ArrayLinkLoads:
        """Minimal ECMP loads: each of the D! orderings carries
        ``gbps / D!`` (a path over m mismatched dims is induced by D!/m!
        orderings, so it carries ``gbps / m!``)."""
        src, _, gbps, cs, cd = self._prep(demands)
        w = gbps / math.factorial(self.index.D)
        loads = self._zeros()
        for slots, mask in self._iter_minimal_hops(src, cs, cd):
            loads.index_add_(0, slots[mask], w[mask])
        return ArrayLinkLoads(self.index, loads)

    def route_valiant(self, demands: DemandArrays) -> ArrayLinkLoads:
        """Minimal + all single-deroute DAL paths, the load split equally
        over them (each of the m! minimal paths and each deroute carries
        ``gbps / n_paths``)."""
        src, dst, gbps, cs, cd = self._prep(demands)
        mism, n_minimal, n_paths = self._valiant_weights(src, dst, cs, cd)
        per_path = gbps / n_paths
        w = per_path * n_minimal / math.factorial(self.index.D)
        loads = self._zeros()
        for slots, mask in self._iter_minimal_hops(src, cs, cd):
            loads.index_add_(0, slots[mask], w[mask])
        for slots, mask in self._iter_deroute_hops(src, cs, cd, mism):
            loads.index_add_(0, slots[mask], per_path[mask])
        return ArrayLinkLoads(self.index, loads)

    # ------------------------------------------------- per-flow incidence ----

    def incidence(self, demands: DemandArrays, mode: str = "minimal",
                  backend: "str | None" = None):
        """Per-flow edge incidence ``(flow, slot, frac)`` (int64, int64,
        float64 tensors) of a fixed-spread mode, ``minimal`` or
        ``valiant``: ``frac`` is the fraction of flow ``flow``'s rate
        carried on edge slot ``slot``.

        Entries are coalesced to one per (flow, slot), their fractions
        summed in a fixed order (:func:`ordered_sum` with ``backend``),
        and sorted by ``flow * n_slots + slot``:
        the reference's order, which is the summation order of every
        reduction downstream.
        """
        if mode not in ("minimal", "valiant"):
            raise ValueError(
                f"no static per-flow incidence for mode {mode!r} "
                "(adaptive re-routes under load); use minimal or valiant")
        backend = resolve_sim_backend(backend)
        self._count_walk()
        src, dst, _, cs, cd = self._prep(demands)
        n_full = math.factorial(self.index.D)
        flows, slots_l, fracs = [], [], []

        def emit(slots, mask, w):
            flows.append(mask.nonzero().squeeze(1))
            slots_l.append(slots[mask])
            fracs.append(w[mask] if torch.is_tensor(w)
                         else torch.full((flows[-1].numel(),), w, dtype=F64,
                                         device=self.device))

        if mode == "minimal":
            for slots, mask in self._iter_minimal_hops(src, cs, cd):
                emit(slots, mask, 1.0 / n_full)
        else:
            mism, n_minimal, n_paths = self._valiant_weights(src, dst, cs, cd)
            w_min = n_minimal / (n_paths * n_full)
            w_der = 1.0 / n_paths
            for slots, mask in self._iter_minimal_hops(src, cs, cd):
                emit(slots, mask, w_min)
            for slots, mask in self._iter_deroute_hops(src, cs, cd, mism):
                emit(slots, mask, w_der)
        if not flows:
            z = torch.zeros(0, dtype=I64, device=self.device)
            return z, z.clone(), torch.zeros(0, dtype=F64, device=self.device)
        n_slots = self.index.n_slots
        key = torch.cat(flows) * n_slots + torch.cat(slots_l)
        frac = torch.cat(fracs)
        del flows, slots_l, fracs
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        del key
        frac = ordered_sum(frac, inv, uniq.numel(), backend)
        return uniq // n_slots, uniq % n_slots, frac

    def mean_switch_hops(self) -> float:
        """Expected switch-switch minimal hops over uniform NIC pairs."""
        return float(sum((d - 1) / d for d in self.topo.dims if d > 1))

    def edge_capacity(self) -> torch.Tensor:
        """(n_slots,) per-edge-slot capacity in Gbps."""
        return self.index.capacity

    # ------------------------------------------------- parallel UGAL/DAL ----

    def _candidate_paths(self, src, cs, cd):
        """Every demand's candidate paths, stacked: ``slots`` (K, M, D+1)
        edge slots (meaningful where the hop is valid), ``valid`` (K, M,
        D+1) hop masks and ``ok`` (K, M), whether candidate ``k`` can
        carry demand ``m``.  The candidates are the reference's, in its
        order: the D! minimal orderings (D hops and an invalid pad; ok
        where a hop is valid), then each (dim, via) single deroute that
        some demand can use (ok where usable)."""
        idx = self.index
        pad_slot = torch.zeros_like(src)
        pad_hop = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
        slots, valid, ok = [], [], []
        for perm in itertools.permutations(range(idx.D)):
            cur_id = src.clone()
            cur = cs.clone()
            s, v = [], []
            for i in perm:
                v.append(cur[:, i] != cd[:, i])
                s.append(idx.slots(cur_id, i, cd[:, i]))
                cur_id = cur_id + (cd[:, i] - cur[:, i]) * idx.stride[i]
                cur[:, i] = cd[:, i]
            slots.append(torch.stack(s + [pad_slot], 1))
            valid.append(torch.stack(v + [pad_hop], 1))
            ok.append(valid[-1].any(dim=1))
        mism = cs != cd
        for i in range(idx.D):
            for via in range(self.topo.dims[i]):
                usable = mism[:, i] & (cs[:, i] != via) & (cd[:, i] != via)
                if not bool(usable.any()):
                    continue
                s = [idx.slots(src, i, torch.full_like(src, via))]
                v = [usable]
                cur_id = src + (via - cs[:, i]) * idx.stride[i]
                cur = cs.clone()
                cur[:, i] = via
                for j in range(idx.D):
                    v.append(usable & (cur[:, j] != cd[:, j]))
                    s.append(idx.slots(cur_id, j, cd[:, j]))
                    cur_id = cur_id + (cd[:, j] - cur[:, j]) * idx.stride[j]
                    cur[:, j] = cd[:, j]
                slots.append(torch.stack(s, 1))
                valid.append(torch.stack(v, 1))
                ok.append(usable)
        return torch.stack(slots), torch.stack(valid), torch.stack(ok)

    def route_adaptive(self, demands: DemandArrays, granularity: int = 8,
                       sub_batches: int = 8, backend: "str | None" = None
                       ) -> ArrayLinkLoads:
        """Parallel UGAL/DAL, the reference's order of operations.

        ``granularity`` quantum rounds; in each, the interleaved groups
        ``arange(b, M, sub_batches)`` in turn place one quantum of every
        demand on its cheapest candidate: cost ``max(util over valid
        hops) + 0.01 * hops``, util ``(load + quantum) / capacity``
        (capacity 0 reads as inf), the first index of ``argmin(cost +
        jitter)`` where the jitter is the reference's own draw
        (``np.random.default_rng(0).random((M, K)) * 1e-5``, made with
        numpy), and only where that cost is finite.  Then for each
        candidate ``k`` in order, ``loads += `` the per-slot sum of the
        quanta its chosen demands put on their valid hops, row-major, in
        a fixed order (:func:`ordered_sum` with ``backend``): on the CPU
        the bits of the reference's numpy backend.
        """
        backend = resolve_sim_backend(backend)
        src, _, gbps, cs, cd = self._prep(demands)
        idx, dev = self.index, self.device
        M = src.shape[0]
        loads = self._zeros()
        if M == 0:
            return ArrayLinkLoads(idx, loads)
        # lay the sub-batches out one after another (each keeps its rows'
        # ascending order), so that each is a slice
        groups = [torch.arange(b, M, sub_batches, device=dev)
                  for b in range(min(sub_batches, M))]
        order = torch.cat(groups)
        src, cs, cd = src[order], cs[order], cd[order]
        quantum = gbps[order] / granularity
        slots, valid, ok = self._candidate_paths(src, cs, cd)
        K, n_slots = slots.shape[0], idx.n_slots
        penalty = 0.01 * valid.sum(dim=2).to(F64)
        safe_cap = torch.where(idx.capacity > 0, idx.capacity, torch.inf)
        jitter = np.random.default_rng(0).random((M, K)) * 1e-5
        jitter = torch.from_numpy(jitter).to(dev)[order]
        spans, lo = [], 0
        for g in groups:
            spans.append((lo, lo + g.numel()))
            lo += g.numel()
        for _ in range(granularity):
            for lo, hi in spans:
                q = quantum[lo:hi]
                sl = slots[:, lo:hi]
                util = (loads[sl] + q[:, None]) / safe_cap[sl]
                util = torch.where(valid[:, lo:hi], util, -torch.inf)
                cost = util.amax(dim=2) + penalty[:, lo:hi]
                costs = torch.where(ok[:, lo:hi], cost, torch.inf)
                choice = (costs.T + jitter[lo:hi]).argmin(dim=1)
                rows = torch.arange(lo, hi, device=dev)
                placeable = torch.isfinite(costs[choice, rows - lo])
                hops = valid[choice, rows] & placeable[:, None]
                keys = (choice[:, None] * n_slots + slots[choice, rows])[hops]
                w = q[:, None].expand(hops.shape)[hops]
                per_cand = ordered_sum(w, keys, K * n_slots, backend)
                for part in per_cand.view(K, n_slots):
                    loads = loads + part
        return ArrayLinkLoads(idx, loads)
