"""Fast reroute under failure: layered multipath and precomputed backups
on torch tensors (port of ``repro/routing/protection.py``).

Two resilience mechanisms over any
:class:`~repro_torch.core.routing_graph.CSRGraph`:

* **FatPaths-style routing layers.**  ``n_layers`` copies of the fabric,
  each a deterministic subgraph.  Layer 0 is the primary (every edge);
  protection layer ``l >= 1`` excludes the undirected edges assigned to
  it round-robin (edge ``uid`` is excluded from layer ``1 + uid %
  (n_layers - 1)``), plus an optional seeded ``rho`` subsample.
* **MRC-style precomputed backup next-hops.**  For every directed edge
  ``e = (u -> v)`` and destination ``d``, :meth:`ProtectedRouter.
  backup_next_hops` holds the first hop out of ``u`` toward ``d`` in the
  layer protecting ``e``, computed from the per-layer BFS distances
  before any failure, so rerouting around a dead ``e`` is a lookup.

:meth:`ProtectedRouter.local_reroute_loads` propagates a healthy demand
matrix over the stale healthy shortest-path DAG, renormalizing each
node's ECMP split over the surviving downhill edges and diverting shares
with no surviving downhill edge into the failed edges' protection
layers.  Shares that exhaust ``max_redirects`` layer switches, enter a
layer that cannot reach the destination, or start or end at dead
switches stall: ``injected == delivered + stalled`` to round-off, and no
load lands on a failed element.

Order of operations, as in the graph engine: every ``np.add.at`` of the
reference (the ECMP denominators, the row scatter into the carried
values, the injections) goes through the engine's ordered sums at one
lane a segment (the segment-sum kernel on the card with
``backend="cuda"``), ``np.logical_or.at`` is a row sum ``> 0``, the
first-downhill table's ``np.minimum.at`` a segment min (both exact in
any order), and every ``x.sum()`` that feeds a reported number is
numpy's pairwise sum (:func:`~repro_torch.core.routing_graph.np_sum`).
So the card, its plain path and the CPU give the reference's numpy bits.

Plans.  The engine keeps one segment plan per chunk width.  A pull that
drops its empty columns (a diverted re-injection rarely reaches every
destination of its chunk) has a width of its own almost every time, so
its blocks are built for the call and not kept.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_sim_backend, synchronize
from ..core.routing_graph import GraphLinkLoads, GraphRouter, np_sum
from ..core.routing_vec import DemandArrays
from ..core.topology import SwitchGraph, Topology
from ..telemetry import get_metrics

F64 = torch.float64
I64 = torch.int64

REROUTE_MODES = ("none", "local", "global")


def validate_reroute_mode(mode: str) -> str:
    if mode not in REROUTE_MODES:
        raise ValueError(f"unknown reroute mode {mode!r}; expected one of "
                         f"{REROUTE_MODES}")
    return mode


def _flat_sum(x: torch.Tensor) -> float:
    """numpy's ``float(x.sum())`` of a C-contiguous array (0.0 empty)."""
    return float(np_sum(x.reshape(-1))) if x.numel() else 0.0


class LocalRerouteResult:
    """Load accounting of one precomputed-backup local reroute.

    ``loads`` lives on the HEALTHY directed-edge ids (zero on every
    failed edge by construction); ``cap_deg`` is the surviving capacity
    of each healthy edge (zero where fully failed, reduced on degraded
    trunks).  ``injected == delivered + stalled`` to float precision.
    """

    def __init__(self, loads, cap_deg, injected_gbps, delivered_gbps,
                 stalled_gbps, diverted_gbps, layer_gbps, n_pulls):
        self.loads = loads
        self.cap_deg = cap_deg
        self.injected_gbps = injected_gbps
        self.delivered_gbps = delivered_gbps
        self.stalled_gbps = stalled_gbps
        self.diverted_gbps = diverted_gbps
        self.layer_gbps = layer_gbps          # (L,) gbps entering each layer
        self.n_pulls = n_pulls

    @property
    def delivered_share(self) -> float:
        return self.delivered_gbps / self.injected_gbps \
            if self.injected_gbps else 1.0

    @property
    def stalled_share(self) -> float:
        return self.stalled_gbps / self.injected_gbps \
            if self.injected_gbps else 0.0

    @property
    def conservation_residual(self) -> float:
        """|injected - delivered - stalled| / injected (0 when idle)."""
        if not self.injected_gbps:
            return 0.0
        return abs(self.injected_gbps - self.delivered_gbps
                   - self.stalled_gbps) / self.injected_gbps

    def max_utilization(self) -> float:
        u = torch.where(self.cap_deg > 0, self.loads / self.cap_deg, 0.0)
        return float(u.max()) if u.numel() else 0.0

    def saturation_throughput(self) -> float:
        mx = self.max_utilization()
        return 1.0 if mx == 0 else min(1.0, 1.0 / mx)

    def info(self) -> dict:
        return {
            "delivered_share": round(self.delivered_share, 6),
            "stalled_share": round(self.stalled_share, 6),
            "diverted_gbps": round(self.diverted_gbps, 6),
            "conservation_residual": self.conservation_residual,
            "max_util": round(self.max_utilization(), 6),
        }


class ProtectedRouter:
    """A :class:`GraphRouter` plus precomputed protection state.

    ``topo_or_graph`` is a topology, a switch graph (routed on ``device``,
    default ``cuda``) or a :class:`GraphRouter`, which brings its own
    device.  ``backend`` is that of the ordered sums and mins (``cuda``:
    the segment kernels; ``torch``: their plain versions).  Construction
    (provisioning time, not failure time) is recorded in the
    ``protection.build_wall_s`` timer; the per-layer BFS and the backup
    next-hop table are built lazily, each with its own timer.
    """

    def __init__(self, topo_or_graph: "Topology | SwitchGraph | GraphRouter",
                 n_layers: int = 4, rho: float = 1.0, seed: int = 0,
                 backend: "str | None" = None,
                 dst_chunk: "int | None" = None, device=None):
        if n_layers < 2:
            raise ValueError("protection needs n_layers >= 2 "
                             "(layer 0 is the primary)")
        if not (0.0 < rho <= 1.0):
            raise ValueError("rho must be in (0, 1]")
        self.backend = resolve_sim_backend(backend)
        t0 = time.perf_counter()
        if isinstance(topo_or_graph, GraphRouter):
            self.router = topo_or_graph
        else:
            self.router = GraphRouter(topo_or_graph, device=device)
        self.device = dev = self.router.device
        self.graph = self.router.graph
        self.csr = csr = self.router.csr
        self.n_layers = n_layers
        self.rho = rho
        self.seed = seed
        E, S = csr.n_edges, csr.n_switches
        if dst_chunk is None:
            dst_chunk = max(1, int(8e6 // max(E, 1)))
        self.dst_chunk = dst_chunk
        # undirected edge ids (both directions of a physical edge share
        # one), numbered in (lo, hi) order
        lo = torch.minimum(csr.src, csr.dst)
        hi = torch.maximum(csr.src, csr.dst)
        upairs, uid = torch.unique(lo * S + hi, sorted=True,
                                   return_inverse=True)
        self.n_uedges = int(upairs.shape[0])
        protect_u = 1 + torch.arange(self.n_uedges, device=dev) \
            % (n_layers - 1)
        # layer that PROTECTS each directed edge (== the layer excluding it)
        self.protect_layer = protect_u[uid].to(torch.int32)      # (E,)
        self.layer_mask = torch.ones((n_layers, E), dtype=torch.bool,
                                     device=dev)
        for l in range(1, n_layers):
            self.layer_mask[l] = self.protect_layer != l
        if rho < 1.0:
            rng = np.random.default_rng(seed)
            for l in range(1, n_layers):
                drop_u = torch.from_numpy(
                    rng.random(self.n_uedges) >= rho).to(dev)
                self.layer_mask[l] &= ~drop_u[uid]
        self._src_host = csr.src.cpu().numpy()
        self._dst_host = csr.dst.cpu().numpy()
        self._hops: "list[torch.Tensor | None]" = [None] * n_layers
        self._bnh: "torch.Tensor | None" = None
        synchronize(dev)
        mx = get_metrics()
        mx.inc("protection.routers_built")
        mx.observe("protection.build_wall_s", time.perf_counter() - t0)

    # ----------------------------------------------------------- layers ----

    def layer_hops(self, layer: int) -> torch.Tensor:
        """(S, S) int32 hop distances within ``layer`` (lazy, cached; -1 =
        unreachable in this layer)."""
        if self._hops[layer] is None:
            t0 = time.perf_counter()
            self._hops[layer] = self.csr.masked_hops(self.layer_mask[layer])
            synchronize(self.device)
            mx = get_metrics()
            mx.inc("protection.layer_bfs")
            mx.observe("protection.layer_bfs_wall_s",
                       time.perf_counter() - t0)
        return self._hops[layer]

    def layer_connected(self, layer: int) -> bool:
        return bool((self.layer_hops(layer) >= 0).all())

    def connected_layers(self) -> "list[int]":
        return [l for l in range(self.n_layers) if self.layer_connected(l)]

    def layer_edge_counts(self) -> torch.Tensor:
        """(L,) directed edges present in each layer."""
        return self.layer_mask.sum(dim=1)

    # ------------------------------------------------ backup next-hops ----

    def _first_downhill_table(self, layer: int) -> torch.Tensor:
        """(S, S) int32: lowest-id downhill neighbor toward every
        destination within ``layer`` (-1 where none — unreachable), a
        segment min of the downhill edges' targets (exact in float64)
        over each ``(source, destination)`` block."""
        csr = self.csr
        S = csr.n_switches
        dist = self.layer_hops(layer)
        m = self.layer_mask[layer][:, None]
        targets = csr.dst.to(F64)[:, None]
        NH = torch.full((S, S), -1, dtype=torch.int32, device=self.device)
        for lo in range(0, S, self.dst_chunk):
            hi = min(lo + self.dst_chunk, S)
            d = dist[:, lo:hi]                                  # (S, C)
            d_src = d[csr.src]
            down = m & (d[csr.dst] == d_src - 1) & (d_src > 0)
            first = self.router._row_min(
                torch.where(down, targets, torch.inf), self.backend)
            NH[:, lo:hi] = torch.where(torch.isinf(first), -1.0,
                                       first).to(torch.int32)
        return NH

    def backup_next_hops(self) -> torch.Tensor:
        """(E, S) int32 MRC table: ``bnh[e, d]`` is the precomputed first
        hop out of ``src[e]`` toward ``d`` in the layer protecting edge
        ``e`` (which excludes ``e`` by construction), or -1 when that
        layer cannot reach ``d`` from ``src[e]``.  Lazy; cached."""
        if self._bnh is None:
            t0 = time.perf_counter()
            csr = self.csr
            bnh = torch.full((csr.n_edges, csr.n_switches), -1,
                             dtype=torch.int32, device=self.device)
            for l in range(1, self.n_layers):
                edges_l = torch.nonzero(self.protect_layer == l).squeeze(1)
                if not edges_l.numel():
                    continue
                NH = self._first_downhill_table(l)
                bnh[edges_l] = NH[csr.src[edges_l]]
            self._bnh = bnh
            synchronize(self.device)
            mx = get_metrics()
            mx.inc("protection.backup_tables_built")
            mx.observe("protection.backup_table_wall_s",
                       time.perf_counter() - t0)
        return self._bnh

    def protection_coverage(self) -> float:
        """Fraction of (edge, destination) cells with a usable backup
        next-hop, excluding the trivial ``src[e] == d`` diagonal (1.0
        when every protection layer stays connected)."""
        bnh = self.backup_next_hops()
        if not bnh.numel():
            return 1.0
        valid = (self.csr.src[:, None]
                 != torch.arange(self.csr.n_switches,
                                 device=self.device)[None, :])
        # numpy's mean of the bools: an exact count over the cell count
        return int(((bnh >= 0) & valid).sum()) / int(valid.sum())

    # ------------------------------------------------- degraded mapping ----

    def _degraded_state(self, dg) -> "tuple[torch.Tensor, ...]":
        """(surv_mult (E,), cap_deg (E,), alive_node (S,)) of a
        :class:`~repro_torch.sim.failures.DegradedGraph` in HEALTHY ids:
        each healthy edge's surviving multiplicity is looked up among the
        degraded graph's edges (renumbered through ``node_map``)."""
        nm = np.asarray(dg.node_map, dtype=np.int64)
        alive = nm >= 0
        src, dst = self._src_host, self._dst_host
        us, vs, ms = dg.graph.directed_edge_arrays()
        S2 = dg.graph.n_switches
        keys = np.asarray(us, dtype=np.int64) * S2 \
            + np.asarray(vs, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        keys, ms = keys[order], np.asarray(ms, dtype=np.float64)[order]
        surv_mult = np.zeros(self.csr.n_edges)
        ok = alive[src] & alive[dst]
        if keys.size:
            want = nm[src] * S2 + nm[dst]
            pos = np.minimum(np.searchsorted(keys, want), keys.size - 1)
            hit = ok & (keys[pos] == want)
            surv_mult[hit] = ms[pos[hit]]
        cap_deg = surv_mult * self.graph.link_gbps
        dev = self.device
        return (torch.from_numpy(surv_mult).to(dev),
                torch.from_numpy(cap_deg).to(dev),
                torch.from_numpy(alive).to(dev))

    # --------------------------------------------------- local reroute ----

    def _pull(self, layer: int, dests: torch.Tensor, inject: torch.Tensor,
              surv: torch.Tensor, surv_mult: torch.Tensor,
              alive_node: torch.Tensor, loads: torch.Tensor,
              narrowed: bool = False):
        """One level-ordered pull of ``inject`` (S, C) toward ``dests``
        within ``layer``, splitting over *surviving* downhill edges.

        Returns ``(delivered (C,), stalled_gbps, diversions)`` where
        ``diversions`` maps protection-layer id -> (S, C) injections that
        must continue there (shares whose downhill edges all failed).
        Adds edge loads into ``loads`` in place.  A pull over the live
        columns of a wider one (``narrowed``) builds its segment blocks
        for the call.
        """
        csr, router, backend = self.csr, self.router, self.backend
        S, C_all = inject.shape
        dev = inject.device
        # diverted re-injections touch few destinations: drop empty
        # columns so protection-layer pulls only pay for live traffic
        live = torch.nonzero(inject.sum(dim=0) > 0).squeeze(1)
        if live.numel() < C_all:
            if not live.numel():
                return torch.zeros(C_all, dtype=F64, device=dev), 0.0, {}
            d_live, st, divs = self._pull(layer, dests[live],
                                          inject[:, live], surv, surv_mult,
                                          alive_node, loads, narrowed=True)
            delivered = torch.zeros(C_all, dtype=F64, device=dev)
            delivered[live] = d_live
            wide = {}
            for l2, arr in divs.items():
                full = torch.zeros((S, C_all), dtype=F64, device=dev)
                full[:, live] = arr
                wide[l2] = full
            return delivered, st, wide
        C = C_all
        cache = not narrowed
        dist = self.layer_hops(layer)[:, dests]                  # (S, C)
        ok = ((dist >= 0) & alive_node[:, None]
              & alive_node[dests][None, :])
        stalled = _flat_sum(inject[~ok])
        f = torch.where(ok, inject, 0.0)
        if not bool((f > 0).any()):
            return torch.zeros(C, dtype=F64, device=dev), stalled, {}
        m = self.layer_mask[layer]
        d_src = dist[csr.src]                                    # (E, C)
        down = m[:, None] & (dist[csr.dst] == d_src - 1) & (d_src > 0)
        alive_down = down & surv[:, None]
        w = surv_mult[:, None] * alive_down
        denom = router._row_sum(w, "src", backend, cache=cache)
        frac = torch.where(alive_down, w / denom[csr.src], 0.0)
        has_down = router._row_sum(down.to(F64), "src", backend,
                                   cache=cache) > 0
        stuck = has_down & (denom <= 0)       # every downhill edge failed
        any_stuck = bool(stuck.any())
        pls, pl_count = [], None
        if any_stuck:
            # diverted shares split evenly over the distinct protection
            # layers of the failed downhill edges (spreads detour load)
            failed_down = down & ~surv[:, None]
            for l2 in range(1, self.n_layers):
                sel_e = failed_down & (self.protect_layer == l2)[:, None]
                has = torch.zeros((S, C), dtype=torch.bool, device=dev)
                el, cl = torch.nonzero(sel_e, as_tuple=True)
                has[csr.src[el], cl] = True
                pls.append(has)
            pl_count = torch.stack(pls).to(I64).sum(dim=0).clamp_min(1)
        divs: dict = {}
        # mass only moves downhill from where it was injected
        top = int(dist[f > 0].max())
        for level in range(top, 0, -1):
            at = dist == level
            if any_stuck:
                dm = at & stuck & (f > 0)
                if bool(dm.any()):
                    for l2, has in zip(range(1, self.n_layers), pls):
                        sel = dm & has
                        if not bool(sel.any()):
                            continue
                        if l2 not in divs:
                            divs[l2] = torch.zeros((S, C), dtype=F64,
                                                   device=dev)
                        divs[l2] = divs[l2] + torch.where(sel, f / pl_count,
                                                          0.0)
                    f = torch.where(dm, 0.0, f)
            contrib = frac * (f * at)[csr.src]                   # (E, C)
            loads.add_(np_sum(contrib))
            f = router._row_sum(contrib, "dst", backend, into=f, cache=cache)
        delivered = f[dests, torch.arange(C, device=dev)]
        return delivered, stalled, divs

    def local_reroute_loads(self, demands: DemandArrays, dg,
                            max_redirects: "int | None" = None
                            ) -> LocalRerouteResult:
        """Reroute a HEALTHY demand matrix around the failures of ``dg``
        using only precomputed state: no BFS and no graph rebuild, only
        ECMP splits renormalized over surviving edges and dead shares
        switched into their protection layers (what a switch does on an
        MRC / SRv6 backup-table hit)."""
        csr, dev = self.csr, self.device
        surv_mult, cap_deg, alive_node = self._degraded_state(dg)
        surv = surv_mult > 0
        src = demands.src.to(dev, I64)
        dst = demands.dst.to(dev, I64)
        gbps = demands.gbps.to(dev, F64)
        keep = src != dst
        src, dst, gbps = src[keep], dst[keep], gbps[keep]
        if max_redirects is None:
            max_redirects = self.n_layers
        loads = torch.zeros(csr.n_edges, dtype=F64, device=dev)
        injected = _flat_sum(gbps)
        delivered = stalled = diverted = 0.0
        layer_gbps = np.zeros(self.n_layers)
        n_pulls = 0
        dests_u, inv = torch.unique(dst, sorted=True, return_inverse=True)
        S, n_dests = csr.n_switches, int(dests_u.shape[0])
        for lo in range(0, n_dests, self.dst_chunk):
            hi = min(lo + self.dst_chunk, n_dests)
            C = hi - lo
            sel = (inv >= lo) & (inv < hi)
            inject = self.router._sum_into(
                gbps[sel], src[sel] * C + (inv[sel] - lo), S * C,
                self.backend).view(S, C)
            queue = {0: inject}
            for _depth in range(max_redirects + 1):
                nxt: dict = {}
                for layer, inj in sorted(queue.items(), key=lambda kv: kv[0]):
                    tot = _flat_sum(inj)
                    if tot <= 0:
                        continue
                    layer_gbps[layer] += tot
                    if layer > 0:
                        diverted += tot
                    d, st, divs = self._pull(layer, dests_u[lo:hi], inj,
                                             surv, surv_mult, alive_node,
                                             loads)
                    n_pulls += 1
                    delivered += float(np_sum(d))
                    stalled += st
                    for l2, arr in divs.items():
                        nxt[l2] = nxt[l2] + arr if l2 in nxt else arr
                queue = nxt
                if not queue:
                    break
            for inj in queue.values():        # redirect budget exhausted
                stalled += _flat_sum(inj)
        mx = get_metrics()
        mx.inc("protection.local_reroutes")
        mx.inc("protection.pulls", n_pulls)
        return LocalRerouteResult(loads, cap_deg, injected, delivered,
                                  stalled, diverted, layer_gbps, n_pulls)

    # ------------------------------------------------ layered multipath ----

    def route_layered(self, demands: DemandArrays,
                      flowlet_bytes: int = 1 << 17,
                      msg_bytes: float = 1 << 22,
                      seed: int = 0) -> GraphLinkLoads:
        """FatPaths-style layered multipath on the healthy fabric: each
        demand's rate is split across connected layers by hashing
        flowlets (``msg_bytes`` worth per flow, ``flowlet_bytes`` each)
        over the layer set (:func:`repro_torch.sim.spray.flowlet_split`),
        and each share routes minimally within its layer.  Returns
        healthy loads on the full edge set."""
        from ..sim.spray import flowlet_split

        csr, dev = self.csr, self.device
        src = demands.src.to(dev, I64)
        dst = demands.dst.to(dev, I64)
        gbps = demands.gbps.to(dev, F64)
        keep = src != dst
        src, dst, gbps = src[keep], dst[keep], gbps[keep]
        loads = torch.zeros(csr.n_edges, dtype=F64, device=dev)
        if not src.numel():
            return GraphLinkLoads(csr, loads)
        alive = [self.layer_connected(l) for l in range(self.n_layers)]
        sizes = torch.full((src.shape[0],), float(msg_bytes), dtype=F64,
                           device=dev)
        bts, _counts = flowlet_split(sizes, self.n_layers, flowlet_bytes,
                                     seed=seed, alive=alive,
                                     backend=self.backend)
        weights = bts / sizes[:, None]
        surv = torch.ones(csr.n_edges, dtype=torch.bool, device=dev)
        alive_node = torch.ones(csr.n_switches, dtype=torch.bool,
                                device=dev)
        dests_u, inv = torch.unique(dst, sorted=True, return_inverse=True)
        S, n_dests = csr.n_switches, int(dests_u.shape[0])
        stalled = 0.0
        for l in (l for l in range(self.n_layers) if alive[l]):
            wl = gbps * weights[:, l]
            if not bool((wl != 0).any()):
                continue
            for lo in range(0, n_dests, self.dst_chunk):
                hi = min(lo + self.dst_chunk, n_dests)
                C = hi - lo
                sel = (inv >= lo) & (inv < hi) & (wl > 0)
                inject = self.router._sum_into(
                    wl[sel], src[sel] * C + (inv[sel] - lo), S * C,
                    self.backend).view(S, C)
                _, st, divs = self._pull(l, dests_u[lo:hi], inject, surv,
                                         csr.mult, alive_node, loads)
                stalled += st
                assert not divs, "no diversions on a healthy fabric"
        assert stalled == 0.0, "connected layers deliver everything"
        get_metrics().inc("protection.layered_routes")
        return GraphLinkLoads(csr, loads)
