"""Topology-agnostic batched graph routing engine on torch tensors (port
of ``repro/core/routing_graph.py``).

The array engine (:mod:`repro_torch.core.routing_vec`) routes by
coordinate arithmetic and is MPHX-only; this engine routes over any
:class:`~repro_torch.core.topology.SwitchGraph`, which carries the
Table-2 baselines (3-tier Fat-Tree, multi-plane Fat-Tree, Dragonfly,
Dragonfly+):

* the multigraph becomes a CSR adjacency with per-edge multiplicity and
  capacity (:class:`CSRGraph`);
* all-pairs hop distances come from a batched frontier BFS, one
  ``(S, S)`` frontier x adjacency matmul per level;
* a demand matrix is routed by ECMP next-hop splitting: at every switch
  the flow toward a destination splits over the distance-decreasing
  ("downhill") edges in proportion to link multiplicity, pulled level by
  level over the shortest-path DAG toward a batch of ``dst_chunk``
  destinations at once.

Routing modes, the reference's: ``minimal`` (ECMP over the
shortest-path DAG), ``valiant`` (the expected VLB loads: every demand via
a uniform random intermediate switch, both stages minimal) and
``adaptive`` (UGAL: each demand splits between the two, damped over
``rounds`` rounds by comparing ``h_min * (c_min + hop_alpha)`` with
``h_val * (c_val + hop_alpha)``).

Order of operations.  UGAL compares costs with ``<=``, so a result can
hang on a last bit, and every sum here keeps the reference's numpy
order.  The scatter-adds (``np.add.at`` in the reference: the ECMP
denominators, the pull's row scatter, the injections) go through
:func:`repro_torch.core.routing_vec.ordered_sum` over a segment plan with
one lane a segment: on the CPU ``index_add_`` into zeros, on the card the
segment-sum kernel (``backend="cuda"``) or its ordered twin
(``"torch"``), which all add each bin's entries one by one in entry
order, ``np.add.at``'s bits.  The plans of the ``(E, C)`` blocks are
built once per router and chunk width.  A column sum ``contrib.sum(
axis=1)`` and the fabric-mean utilization are numpy's pairwise sums
(:func:`np_sum`).  The bottleneck's ``np.maximum.at`` is ``-segment_min(
-x)`` on the same plan.  No float64 atomics on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device, resolve_sim_backend
from ..kernels.segment_fairshare import make_plan, segment_min, \
    segment_min_ref
from . import routing_vec
from .routing_vec import (BaseLinkLoads, DemandArrays,
                          IncidenceCacheMixin, div_scalar)
from .topology import SwitchGraph, Topology

F64 = torch.float64
I64 = torch.int64

# numpy reduces a contiguous float64 axis pairwise (8 accumulators over
# blocks of at most 128, halves split at multiples of 8) within buffers
# of 8,192 elements, and adds the buffers' sums in order
_NP_BLOCK = 128
_NP_BUFFER = 8192

Edge = tuple[int, int]


def _leaf(xt: torch.Tensor) -> torch.Tensor:
    """(R,) numpy's pairwise sums of the columns of ``xt`` (n, R), 1 <= n
    <= 128: each add runs over contiguous rows."""
    n = xt.shape[0]
    if n < 8:
        res = xt[0]
        for i in range(1, n):
            res = res + xt[i]
        return res
    m = n - n % 8
    r = xt[:8]
    for i in range(8, m, 8):
        r = r + xt[i:i + 8]
    # ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))
    r = r[0::2] + r[1::2]
    r = r[0::2] + r[1::2]
    res = r[0] + r[1]
    for i in range(m, n):
        res = res + xt[i]
    return res


def _pairwise(x: torch.Tensor) -> torch.Tensor:
    """(R,) numpy's pairwise sums of the rows of ``x`` (R, n), n >= 1."""
    R, n = x.shape
    if n <= _NP_BLOCK:
        return _leaf(x.T.contiguous())
    n2 = n // 2
    n2 -= n2 % 8
    if 2 * n2 == n:
        # equal halves: one call over both as rows (the same additions)
        halves = _pairwise(x.reshape(2 * R, n2)).view(R, 2)
        return halves[:, 0] + halves[:, 1]
    return _pairwise(x[:, :n2]) + _pairwise(x[:, n2:])


def np_sum(x: torch.Tensor) -> torch.Tensor:
    """numpy's float64 ``x.sum(axis=-1)`` of a C-contiguous array, bit for
    bit: pairwise within buffers of 8,192, the buffers added in order."""
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    if n == 0:
        return torch.zeros(rows.shape[0], dtype=x.dtype, device=x.device
                           ).view(x.shape[:-1])
    full = n // _NP_BUFFER
    res = None
    if full:
        part = _pairwise(rows[:, :full * _NP_BUFFER].reshape(-1, _NP_BUFFER)
                         ).view(-1, full)
        res = part[:, 0]
        for k in range(1, full):
            res = res + part[:, k]
    if n % _NP_BUFFER:
        tail = _pairwise(rows[:, full * _NP_BUFFER:])
        res = tail if res is None else res + tail
    return res.view(x.shape[:-1])


# ---------------------------------------------------------------------------
# CSR adjacency
# ---------------------------------------------------------------------------


class CSRGraph:
    """CSR view of a :class:`SwitchGraph`'s directed edges on ``device``.

    Directed edge ``e`` leaves ``src[e]`` toward ``dst[e]`` with
    ``mult[e]`` parallel physical links and capacity ``cap[e] = mult[e] *
    link_gbps``.  Edges are sorted by (source, target), so edge ids are
    the reference's.
    """

    def __init__(self, graph: SwitchGraph, device: torch.device):
        self.graph = graph
        self.device = device
        self.n_switches = graph.n_switches
        us, vs, mult = graph.directed_edge_arrays()
        us, vs = np.asarray(us, dtype=np.int64), np.asarray(vs, dtype=np.int64)
        order = np.lexsort((vs, us))
        self.src = torch.from_numpy(us[order]).to(device)
        self.dst = torch.from_numpy(vs[order]).to(device)
        self.mult = torch.from_numpy(
            np.asarray(mult, dtype=np.float64)[order]).to(device)
        self.cap = self.mult * graph.link_gbps
        self.n_edges = int(self.src.shape[0])
        self.nic_counts = torch.tensor(graph.nic_counts(), dtype=I64,
                                       device=device)

    def masked_hops(self, edge_mask: "torch.Tensor | None" = None
                    ) -> torch.Tensor:
        """(S, S) int32 switch-to-switch hop distances over the edges of
        ``edge_mask`` (all by default) by batched frontier BFS: one
        boolean (S, S) frontier per level, expanded by one frontier x
        adjacency matmul (only ``> 0`` is read).  ``-1`` marks unreachable
        pairs."""
        S, dev = self.n_switches, self.device
        src, dst = self.src, self.dst
        if edge_mask is not None:
            src, dst = src[edge_mask], dst[edge_mask]
        adj = torch.zeros((S, S), dtype=torch.float32, device=dev)
        adj[src, dst] = 1.0
        frontier = torch.eye(S, dtype=torch.bool, device=dev)
        visited = frontier.clone()
        dist = torch.full((S, S), -1, dtype=torch.int32, device=dev)
        dist.fill_diagonal_(0)
        d = 0
        while True:
            d += 1
            nxt = ((frontier.to(torch.float32) @ adj) > 0) & ~visited
            if not bool(nxt.any()):
                break
            dist[nxt] = d
            visited |= nxt
            frontier = nxt
        return dist

    def all_pairs_hops(self) -> torch.Tensor:
        """(S, S) int32 hop distances over every edge
        (:meth:`masked_hops`).  Raises on a disconnected graph."""
        dist = self.masked_hops()
        if bool((dist < 0).any()):
            raise ValueError(f"{self.graph.name}: graph is disconnected")
        return dist


class GraphLinkLoads(BaseLinkLoads):
    """Per-directed-edge offered Gbps of a routed demand matrix."""

    def __init__(self, csr: CSRGraph, loads: torch.Tensor):
        self.csr = csr
        self.loads = loads

    def capacity_array(self) -> torch.Tensor:
        return self.csr.cap

    def to_dict(self) -> "dict[Edge, float]":
        """Nonzero loads as ``{(u, v): gbps}``."""
        nz = torch.nonzero(self.loads).squeeze(1)
        return {(int(self.csr.src[e]), int(self.csr.dst[e])):
                float(self.loads[e]) for e in nz.tolist()}


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


class GraphRouter(IncidenceCacheMixin):
    """Batched routing over any :class:`SwitchGraph` (or any
    :class:`Topology` with ``build_graph()``) on ``device`` (default
    ``cuda``).

    ``route`` and ``incidence`` take the ``backend`` of their ordered sums
    (``cuda``: the segment kernels on the card, the default; ``torch``:
    their plain versions).  ``dst_chunk`` destinations are routed per
    batch, by default the reference's ``8e6 // E`` (its ``(E, chunk)``
    blocks stay near 64 MB); the column sums' bits depend on it.
    """

    def __init__(self, topo_or_graph: "Topology | SwitchGraph",
                 device=None, dst_chunk: "int | None" = None):
        self.device = resolve_device(device)
        if isinstance(topo_or_graph, SwitchGraph):
            graph = topo_or_graph
        else:
            graph = topo_or_graph.build_graph()
        self.graph = graph
        self.csr = CSRGraph(graph, self.device)
        if dst_chunk is None:
            dst_chunk = max(1, int(8e6 // max(self.csr.n_edges, 1)))
        self.dst_chunk = dst_chunk
        self._hops: "torch.Tensor | None" = None
        self._far: "list[int] | None" = None
        self._mean_hops: "float | None" = None
        self._blocks: dict = {}

    @property
    def hops(self) -> torch.Tensor:
        """(S, S) all-pairs switch hop distances (lazy, cached)."""
        if self._hops is None:
            self._hops = self.csr.all_pairs_hops()
        return self._hops

    def _levels(self, dests: "list[int]") -> int:
        """Levels of a pull toward ``dests`` (host ids): the farthest
        source's hop count, ``hops[:, dests].max()``, read from a host
        copy of each destination's farthest distance (made once), so a
        chunk needs no device sync."""
        if self._far is None:
            self._far = self.hops.max(dim=0).values.tolist()
        return max(self._far[d] for d in dests)

    # --------------------------------------------------- ordered sums ----

    def _block(self, col: str, C: int, cache: bool = True):
        """``(ids, plan)`` of an ``(E, C)`` block scattered by the ``src``
        or ``dst`` column: flat ids ``col[e] * C + c``, and for ``dst``
        first the ``S * C`` ids of the block it adds into (so each bin
        starts from its old value, as ``np.add.at`` does).  The plan (card
        only, one lane a segment) is built once per router and width;
        ``cache=False`` builds a block for one call and keeps nothing (at
        mphx-4p-86x9 a width's ids alone take ``E * C * 8`` bytes, 64 MB
        at the chunk width)."""
        key = (col, C)
        hit = self._blocks.get(key)
        if hit is not None:
            return hit
        csr, dev = self.csr, self.device
        cols = torch.arange(C, device=dev)
        ids = (getattr(csr, col)[:, None] * C + cols).reshape(-1)
        if col == "dst":
            ids = torch.cat([torch.arange(csr.n_switches * C, device=dev),
                             ids])
        plan = None
        if dev.type == "cuda":
            plan = dataclasses.replace(
                make_plan(ids, csr.n_switches * C), lanes=1)
        if cache:
            self._blocks[key] = (ids, plan)
        return ids, plan

    def _row_sum(self, vals: torch.Tensor, col: str, backend: str,
                 into: "torch.Tensor | None" = None,
                 cache: bool = True) -> torch.Tensor:
        """(S, C): ``np.add.at(into or zeros, csr.<col>, vals)`` for an
        ``(E, C)`` block, in its bits (``cache``: :meth:`_block`'s)."""
        C = vals.shape[1]
        ids, plan = self._block(col, C, cache)
        flat = vals.reshape(-1)
        if into is not None:
            flat = torch.cat([into.reshape(-1), flat])
        S = self.csr.n_switches
        return routing_vec.ordered_sum(flat, ids, S * C, backend,
                                       plan=plan).view(S, C)

    def _row_min(self, vals: torch.Tensor, backend: str) -> torch.Tensor:
        """(S, C): ``np.minimum.at(full(inf), csr.src, vals)`` for an
        ``(E, C)`` block (empty bins +inf; exact in any order)."""
        C = vals.shape[1]
        ids, plan = self._block("src", C)
        n = self.csr.n_switches * C
        flat = vals.reshape(-1)
        if backend == "cuda":
            m = segment_min(flat, ids, n, plan=plan)
        else:
            m = segment_min_ref(flat, ids, n)
        return m.view(self.csr.n_switches, C)

    def _row_max(self, vals: torch.Tensor, backend: str) -> torch.Tensor:
        """(S, C): ``np.maximum.at(full(-inf), csr.src, vals)`` for an
        ``(E, C)`` block, as ``-segment_min(-vals)`` (empty bins -inf)."""
        return -self._row_min(-vals, backend)

    def _sum_into(self, vals: torch.Tensor, ids: torch.Tensor, n: int,
                  backend: str) -> torch.Tensor:
        """(n,) ``np.add.at(zeros(n), ids, vals)``, in its bits."""
        plan = None
        if vals.is_cuda:
            plan = dataclasses.replace(make_plan(ids, n), lanes=1)
        return routing_vec.ordered_sum(vals, ids, n, backend, plan=plan)

    # --------------------------------------------------- propagation ----

    def _downhill(self, dests: torch.Tensor, backend: str):
        """``(dist_to, frac)`` toward a destination batch: ``dist_to``
        (S, C) hop counts, ``frac`` (E, C) the ECMP split fraction of edge
        ``e`` for flow at ``src[e]`` headed to ``dests[j]`` (0 on edges
        that do not go downhill)."""
        csr = self.csr
        dist_to = self.hops[:, dests]
        down = dist_to[csr.dst] == dist_to[csr.src] - 1
        w = csr.mult[:, None] * down
        denom = self._row_sum(w, "src", backend)
        frac = torch.where(down, w / denom[csr.src], 0.0)
        return dist_to, frac

    def _pull(self, dests: torch.Tensor, inject: torch.Tensor, backend: str,
              top: int):
        """Yield each level's ``(E, C)`` edge loads of ``inject`` (S, C)
        Gbps pushed minimally toward ``dests``, from level ``top`` (the
        farthest, :meth:`_levels`) down to 1."""
        dist_to, frac = self._downhill(dests, backend)
        src = self.csr.src
        f = inject
        for level in range(top, 0, -1):
            contrib = frac * (f * (dist_to == level))[src]
            yield contrib
            if level > 1:
                f = self._row_sum(contrib, "dst", backend, into=f)

    def _route_to_dests(self, dests, inject, loads, backend: str, top: int):
        """``loads`` (E,) plus the edge loads of ``inject`` routed
        minimally toward ``dests``."""
        for contrib in self._pull(dests, inject, backend, top):
            loads = loads + np_sum(contrib)
        return loads

    def _incidence_to_dests(self, dests, inject, backend: str, top: int):
        """(E, C) load each column's injection places on every edge."""
        out = torch.zeros((self.csr.n_edges, dests.shape[0]), dtype=F64,
                          device=self.device)
        for contrib in self._pull(dests, inject, backend, top):
            out = out + contrib
        return out

    def _chunks(self, inv: torch.Tensor, n_dests: int):
        """Demands grouped by destination chunk: ``order`` (a stable sort
        by ``inv``, keeping each chunk's demands in their row order) and
        per chunk ``(lo, hi, a, b)``: destinations ``lo:hi`` and sorted
        demands ``a:b``."""
        order = torch.sort(inv, stable=True).indices
        edges = torch.arange(0, n_dests + self.dst_chunk, self.dst_chunk,
                             device=inv.device).clamp_max(n_dests)
        bounds = torch.searchsorted(inv[order], edges).tolist()
        los = edges.tolist()
        spans = [(los[k], los[k + 1], bounds[k], bounds[k + 1])
                 for k in range(len(los) - 1) if los[k] < los[k + 1]]
        return order, spans

    def _accumulate_minimal(self, src, dst, gbps, loads, backend: str):
        """ECMP-route (src, dst, gbps) triplets; add into ``loads``."""
        S = self.csr.n_switches
        dests, inv = torch.unique(dst, sorted=True, return_inverse=True)
        order, spans = self._chunks(inv, dests.shape[0])
        src, inv, gbps = src[order], inv[order], gbps[order]
        host = dests.tolist()
        for lo, hi, a, b in spans:
            C = hi - lo
            inject = self._sum_into(gbps[a:b], src[a:b] * C + (inv[a:b] - lo),
                                    S * C, backend).view(S, C)
            loads = self._route_to_dests(dests[lo:hi], inject, loads, backend,
                                         self._levels(host[lo:hi]))
        return loads

    def _valiant_loads(self, src, dst, gbps, loads, backend: str):
        """Expected VLB loads: stage 1 carries each source's egress spread
        1/S to every switch, stage 2 each destination's ingress collected
        1/S from every switch, both minimal ECMP."""
        S = self.csr.n_switches
        g_out = self._sum_into(gbps, src, S, backend)
        vias = torch.arange(S, device=self.device)
        for lo in range(0, S, self.dst_chunk):
            cols = vias[lo:lo + self.dst_chunk]
            inject = div_scalar(g_out[:, None], S).expand(S, cols.shape[0])
            loads = self._route_to_dests(
                cols, inject, loads, backend,
                self._levels(range(lo, lo + cols.shape[0])))
        g_in = self._sum_into(gbps, dst, S, backend)
        dests = torch.nonzero(g_in).squeeze(1)
        host = dests.tolist()
        for lo in range(0, dests.shape[0], self.dst_chunk):
            cols = dests[lo:lo + self.dst_chunk]
            inject = div_scalar(g_in[cols], S)[None, :].expand(
                S, cols.shape[0])
            loads = self._route_to_dests(
                cols, inject, loads, backend,
                self._levels(host[lo:lo + self.dst_chunk]))
        return loads

    def _bottleneck_to_dests(self, dests, util, backend: str, top: int):
        """(S, C) worst edge utilization on the minimal DAG from every
        switch to each destination (backward max-propagation by level,
        1 to ``top``)."""
        csr = self.csr
        dist_to, frac = self._downhill(dests, backend)
        down = frac > 0
        b = torch.zeros(dist_to.shape, dtype=F64, device=self.device)
        for level in range(1, top + 1):
            cand = torch.where(down, torch.maximum(util[:, None], b[csr.dst]),
                               -torch.inf)
            b = torch.where(dist_to == level, self._row_max(cand, backend), b)
        return b

    # ------------------------------------------------------ interface ----

    def _prep(self, demands: DemandArrays):
        src = demands.src.to(self.device, I64)
        dst = demands.dst.to(self.device, I64)
        gbps = demands.gbps.to(self.device, F64)
        keep = src != dst
        return src[keep], dst[keep], gbps[keep]

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.csr.n_edges, dtype=F64, device=self.device)

    def edge_capacity(self) -> torch.Tensor:
        """(E,) directed-edge capacity in Gbps."""
        return self.csr.cap

    def mean_switch_hops(self) -> float:
        """Mean switch-switch hops over NIC-weighted switch pairs
        (same-switch pairs included, as ``MPHX.avg_hops() - 2`` counts)."""
        if self._mean_hops is None:
            nics = self.csr.nic_counts.to(F64)
            w = nics / nics.sum()
            self._mean_hops = float(w @ self.hops.to(F64) @ w)
        return self._mean_hops

    def route(self, demands: DemandArrays, mode: str = "minimal",
              rounds: int = 4, backend: "str | None" = None
              ) -> GraphLinkLoads:
        if mode == "minimal":
            return self.route_minimal(demands, backend=backend)
        if mode == "valiant":
            return self.route_valiant(demands, backend=backend)
        if mode == "adaptive":
            return self.route_adaptive(demands, rounds=rounds,
                                       backend=backend)
        raise ValueError(f"unknown mode {mode}")

    def route_minimal(self, demands: DemandArrays,
                      backend: "str | None" = None) -> GraphLinkLoads:
        backend = resolve_sim_backend(backend)
        src, dst, gbps = self._prep(demands)
        return GraphLinkLoads(self.csr, self._accumulate_minimal(
            src, dst, gbps, self._zeros(), backend))

    def route_valiant(self, demands: DemandArrays,
                      backend: "str | None" = None) -> GraphLinkLoads:
        backend = resolve_sim_backend(backend)
        src, dst, gbps = self._prep(demands)
        return GraphLinkLoads(self.csr, self._valiant_loads(
            src, dst, gbps, self._zeros(), backend))

    def route_adaptive(self, demands: DemandArrays, rounds: int = 4,
                       hop_alpha: float = 0.05,
                       backend: "str | None" = None) -> GraphLinkLoads:
        """UGAL-style adaptive: per demand, split between minimal ECMP and
        the VLB spread.  Each round compares ``h_min * (c_min +
        hop_alpha)`` with ``h_val * (c_val + hop_alpha)`` under the
        current loads (``c_min`` the demand's bottleneck utilization on
        its minimal DAG, ``c_val`` the fabric-mean utilization) and damps
        the minimal share ``phi`` 50 % toward the winner."""
        backend = resolve_sim_backend(backend)
        src, dst, gbps = self._prep(demands)
        csr, S = self.csr, self.csr.n_switches
        if src.numel() == 0:
            return GraphLinkLoads(csr, self._zeros())
        hops = self.hops
        h_min = hops[src, dst].to(F64)
        h_val = div_scalar(hops.sum(dim=1, dtype=F64), S)[src] \
            + div_scalar(hops.sum(dim=0, dtype=F64), S)[dst]
        dests, inv = torch.unique(dst, sorted=True, return_inverse=True)
        order, spans = self._chunks(inv, dests.shape[0])
        src_o, inv_o = src[order], inv[order]
        host = dests.tolist()
        used = csr.cap > 0
        n_used = int(used.sum())
        phi = torch.ones(src.shape[0], dtype=F64, device=self.device)
        loads = None
        for r in range(rounds + 1):
            loads = self._accumulate_minimal(src, dst, gbps * phi,
                                             self._zeros(), backend)
            loads = self._valiant_loads(src, dst, gbps * (1 - phi), loads,
                                        backend)
            if r == rounds:
                break
            util = GraphLinkLoads(csr, loads).utilization_array()
            c_val = float(np_sum(util[used])) / n_used
            c_min_o = torch.empty_like(phi)
            for lo, hi, a, b in spans:
                bn = self._bottleneck_to_dests(dests[lo:hi], util, backend,
                                               self._levels(host[lo:hi]))
                c_min_o[a:b] = bn[src_o[a:b], inv_o[a:b] - lo]
            c_min = torch.empty_like(phi)
            c_min[order] = c_min_o
            prefer_min = (h_min * (c_min + hop_alpha)
                          <= h_val * (c_val + hop_alpha))
            phi = 0.5 * phi + 0.5 * prefer_min.to(F64)
        return GraphLinkLoads(csr, loads)

    def incidence(self, demands: DemandArrays, mode: str = "minimal",
                  backend: "str | None" = None):
        """Per-flow edge incidence ``(flow, edge, frac)`` of minimal ECMP
        (int64, int64, float64 tensors): ``frac`` is the fraction of flow
        ``flow``'s rate on directed edge ``edge``.  Self-pairs get no
        entries.  The reference's ``(flow, edge, frac)`` entries, sorted
        by flow, each flow's in edge order.  Only ``minimal`` has a static
        per-flow spread here."""
        if mode != "minimal":
            raise ValueError(
                f"no static per-flow incidence for graph-engine mode "
                f"{mode!r} (valiant averages over all intermediates, "
                "adaptive re-routes under load); use minimal")
        backend = resolve_sim_backend(backend)
        self._count_walk()
        dev = self.device
        src = demands.src.to(dev, I64)
        dst = demands.dst.to(dev, I64)
        keep = torch.nonzero(src != dst).squeeze(1)
        if keep.numel() == 0:
            z = torch.zeros(0, dtype=I64, device=dev)
            return z, z.clone(), torch.zeros(0, dtype=F64, device=dev)
        upairs, pair_of = torch.unique(
            torch.stack([src[keep], dst[keep]], 1), dim=0,
            return_inverse=True)
        S, P = self.csr.n_switches, upairs.shape[0]
        chunk = min(self.dst_chunk, 256)
        host = upairs[:, 1].tolist()
        edges, fracs, n_ent = [], [], []
        for lo in range(0, P, chunk):
            C = min(chunk, P - lo)
            cols = torch.arange(C, device=dev)
            inject = torch.zeros((S, C), dtype=F64, device=dev)
            inject[upairs[lo:lo + C, 0], cols] = 1.0
            out_t = self._incidence_to_dests(upairs[lo:lo + C, 1], inject,
                                             backend,
                                             self._levels(host[lo:lo + C])).T
            # entries grouped by column (pair), edges ascending
            c_idx, e_idx = torch.nonzero(out_t, as_tuple=True)
            edges.append(e_idx)
            fracs.append(out_t[c_idx, e_idx])
            n_ent.append(torch.bincount(c_idx, minlength=C))
        edges, fracs, n_ent = torch.cat(edges), torch.cat(fracs), \
            torch.cat(n_ent)
        ent_start = torch.cumsum(n_ent, 0) - n_ent
        # each kept flow, in row order, replays its pair's entry block
        count = n_ent[pair_of]
        flow = torch.repeat_interleave(keep, count)
        first = torch.cumsum(count, 0) - count
        pos = torch.repeat_interleave(ent_start[pair_of] - first, count) \
            + torch.arange(flow.shape[0], device=dev)
        return flow, edges[pos], fracs[pos]


# ---------------------------------------------------------------------------
# Generic demand builders (any SwitchGraph, NIC-bearing switches only)
# ---------------------------------------------------------------------------
#
# Traffic originates and terminates only at NIC-bearing switches, each
# injecting its NIC count's share of ``offered_per_nic_gbps`` divided by
# the plane count (one plane's load, as the MPHX builders).  Patterns that
# need a coordinate system (``transpose``) stay MPHX-only.


def _nic_switches(topo: Topology, graph: "SwitchGraph | None", device):
    dev = resolve_device(device)
    g = graph if graph is not None else topo.build_graph()
    nics = torch.tensor(g.nic_counts(), dtype=F64, device=dev)
    nic_sw = torch.nonzero(nics).squeeze(1)
    if nic_sw.numel() < 2:
        raise ValueError(f"{g.name}: needs >= 2 NIC-bearing switches")
    return g, nics, nic_sw


def graph_uniform_demands(topo: Topology, offered_per_nic_gbps: float,
                          graph: "SwitchGraph | None" = None,
                          device=None) -> DemandArrays:
    """Every NIC sprays uniformly over all *other* NIC-bearing switches,
    weighted by destination NIC count."""
    g, nics, nic_sw = _nic_switches(topo, graph, device)
    out = div_scalar(nics * offered_per_nic_gbps, topo.n_planes)
    s, d = torch.meshgrid(nic_sw, nic_sw, indexing="ij")
    mask = s != d
    s, d = s[mask], d[mask]
    total = nics.sum()
    return DemandArrays(s, d, out[s] * nics[d] / (total - nics[s]))


def graph_shift_demands(topo: Topology, offered_per_nic_gbps: float,
                        graph: "SwitchGraph | None" = None,
                        device=None) -> DemandArrays:
    """+1 shift over NIC-bearing switches in id order (the generic
    analogue of the MPHX dim-0 neighbor shift)."""
    g, nics, nic_sw = _nic_switches(topo, graph, device)
    out = div_scalar(nics * offered_per_nic_gbps, topo.n_planes)
    return DemandArrays(nic_sw, torch.roll(nic_sw, -1), out[nic_sw])


def graph_reverse_demands(topo: Topology, offered_per_nic_gbps: float,
                          graph: "SwitchGraph | None" = None,
                          device=None) -> DemandArrays:
    """Reverse pairing (switch k -> switch K-1-k over NIC-bearing
    switches in id order), the generic analogue of MPHX bit-complement."""
    g, nics, nic_sw = _nic_switches(topo, graph, device)
    out = div_scalar(nics * offered_per_nic_gbps, topo.n_planes)
    dst = torch.flip(nic_sw, [0])
    keep = nic_sw != dst
    return DemandArrays(nic_sw[keep], dst[keep], out[nic_sw][keep])


def graph_hotspot_demands(topo: Topology, offered_per_nic_gbps: float,
                          graph: "SwitchGraph | None" = None,
                          hot_fraction: float = 0.5,
                          device=None) -> DemandArrays:
    """``hot_fraction`` of every switch's load incasts on the first
    NIC-bearing switch; the rest sprays uniformly (the uniform rows, then
    the hot rows)."""
    g, nics, nic_sw = _nic_switches(topo, graph, device)
    uni = graph_uniform_demands(topo,
                                offered_per_nic_gbps * (1 - hot_fraction),
                                graph=g, device=nics.device)
    hot = int(nic_sw[0])
    out = div_scalar(nics * offered_per_nic_gbps * hot_fraction,
               topo.n_planes)
    srcs = nic_sw[nic_sw != hot]
    return DemandArrays(
        torch.cat([uni.src, srcs]),
        torch.cat([uni.dst, torch.full_like(srcs, hot)]),
        torch.cat([uni.gbps, out[srcs]]))


def graph_ring_demands(topo: Topology, offered_per_nic_gbps: float,
                       graph: "SwitchGraph | None" = None,
                       device=None) -> DemandArrays:
    """Steady-state link pattern of a ring collective over NIC-bearing
    switches in id order."""
    return graph_shift_demands(topo, offered_per_nic_gbps, graph=graph,
                               device=device)
