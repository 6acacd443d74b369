"""Link / switch / plane failure injection (port of
``repro/sim/failures.py``).

Physical link and switch failures are sampled out of a topology's
:class:`~repro_torch.core.topology.SwitchGraph` on the host, with the
reference's numpy generator and draw order, so a spec fails the same
elements in both packages.  The survivors are rebuilt into CSR routing
state and re-routed on the graph engine
(:class:`~repro_torch.core.routing_graph.GraphRouter`); the MPHX array
engine's coordinate arithmetic assumes an intact mesh, so MPHX degrades
through its own ``build_graph()``.  Whole-plane failures are folded in
as the spray layer's factor: surviving planes re-carry ``n / alive`` of
the load and deliver at most ``alive / n``.

:func:`recovery_curve` measures the recovery of one traffic matrix in
three reroute modes (global recompute, precomputed local reroute
through :mod:`repro_torch.routing.protection`, local bridge then global
reconvergence).  Each phase's wall ends with a device synchronize, so
it holds the phase's device work and not only its launches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device, resolve_sim_backend, synchronize
from ..core.routing_graph import GraphRouter, np_sum
from ..core.topology import SwitchGraph, Topology
from ..routing.protection import (ProtectedRouter, REROUTE_MODES,
                                  validate_reroute_mode)
from ..telemetry import get_metrics, get_recorder
from .fairshare import flow_incidence

__all__ = ["FailureSpec", "parse_failure_spec", "DegradedGraph",
           "degrade_graph", "degraded_router", "plane_capacity_factor",
           "failure_throughput", "recovery_curve", "time_to_recover",
           "REROUTE_MODES", "validate_reroute_mode"]


@dataclass(frozen=True)
class FailureSpec:
    """What to break: fractions of physical links / switches, whole planes."""

    link_fraction: float = 0.0
    switch_fraction: float = 0.0
    planes_down: int = 0
    seed: int = 0

    def __post_init__(self):
        if not (0 <= self.link_fraction < 1):
            raise ValueError("link_fraction must be in [0, 1)")
        if not (0 <= self.switch_fraction < 1):
            raise ValueError("switch_fraction must be in [0, 1)")
        if self.planes_down < 0:
            raise ValueError("planes_down must be >= 0")

    @property
    def is_noop(self) -> bool:
        return (self.link_fraction == 0 and self.switch_fraction == 0
                and self.planes_down == 0)

    def label(self) -> str:
        parts = []
        if self.link_fraction:
            parts.append(f"link:{self.link_fraction:g}")
        if self.switch_fraction:
            parts.append(f"switch:{self.switch_fraction:g}")
        if self.planes_down:
            parts.append(f"plane:{self.planes_down}")
        return ",".join(parts) or "none"


def parse_failure_spec(text: str) -> FailureSpec:
    """Parse the CLI grammar ``link:0.01,switch:0.02,plane:1[,seed:3]``.

    Rejects (with a ``ValueError`` naming the offending part) duplicate
    element kinds, unknown keys, non-numeric values, and negative
    fractions or counts: a mistyped spec must never half-run a suite.
    """
    kw: dict = {}
    keys = {"link": "link_fraction", "switch": "switch_fraction",
            "plane": "planes_down", "seed": "seed"}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"bad failure spec {part!r}: expected key:value with key "
                f"in {sorted(keys)} (e.g. 'link:0.01,plane:1')")
        k, v = part.split(":", 1)
        k = k.strip().lower()
        if k not in keys:
            raise ValueError(f"unknown failure key {k!r} in {text!r}; "
                             f"known: {sorted(keys)}")
        if keys[k] in kw:
            raise ValueError(f"duplicate failure key {k!r} in {text!r}: "
                             f"each element kind may appear once")
        v = v.strip()
        is_int = keys[k] in ("planes_down", "seed")
        try:
            val = int(v) if is_int else float(v)
        except ValueError:
            raise ValueError(
                f"bad value {v!r} for failure key {k!r} in {text!r}: "
                f"expected {'an integer' if is_int else 'a number'}"
            ) from None
        if val < 0:
            raise ValueError(f"negative value {v!r} for failure key {k!r} "
                             f"in {text!r}")
        kw[keys[k]] = val
    return FailureSpec(**kw)


@dataclass
class DegradedGraph:
    """A failed-down copy of a :class:`SwitchGraph` plus what broke.

    Surviving switches are compacted (dead nodes dropped, survivors
    renumbered 0..S'-1 via ``node_map``) so the graph stays BFS-routable;
    with link-only failures ``node_map`` is the identity and healthy-id
    demand matrices transfer unchanged.  ``failed_switches`` and
    ``fully_failed_edges`` are in HEALTHY ids.
    """

    graph: SwitchGraph
    node_map: np.ndarray         # (S_healthy,) old -> new id, -1 = dead
    failed_switches: list        # healthy ids
    failed_links: float          # physical links removed (multiplicity sum)
    fully_failed_edges: list     # healthy-id (u, v) with no surviving links
    total_links: float

    def info(self) -> dict:
        return {
            "failed_switches": len(self.failed_switches),
            "failed_links": round(self.failed_links, 3),
            "fully_failed_edges": len(self.fully_failed_edges),
            "failed_link_fraction":
                round(self.failed_links / self.total_links, 6)
                if self.total_links else 0.0,
        }


def degrade_graph(graph: SwitchGraph, spec: FailureSpec) -> DegradedGraph:
    """Sample failures from ``spec`` and rebuild the surviving multigraph.

    Each physical link fails independently with ``link_fraction``
    (trunked edges lose a Binomial share of their multiplicity); each
    switch fails with ``switch_fraction``, dropping all incident links and
    its NICs.  Host work, in the reference's draw order: one
    ``rng.random(S)`` for the switches (and its all-dead fix-up), then one
    ``rng.binomial`` an undirected edge in adjacency order.
    """
    rng = np.random.default_rng(spec.seed)
    S = graph.n_switches
    dead = np.zeros(S, dtype=bool)
    if spec.switch_fraction > 0:
        dead = rng.random(S) < spec.switch_fraction
        if dead.all():
            dead[int(rng.integers(S))] = False
    node_map = np.full(S, -1, dtype=np.int64)
    node_map[~dead] = np.arange(int((~dead).sum()))
    out = SwitchGraph(int((~dead).sum()), graph.nics_per_switch,
                      graph.link_gbps,
                      name=f"{graph.name} (degraded {spec.label()})",
                      nic_nodes=[int(node_map[u]) for u in graph.nic_nodes
                                 if not dead[u]])
    failed_links = 0.0
    fully_failed = []
    for u in range(S):
        for v, m in graph.adj[u].items():
            if v < u:
                continue
            if dead[u] or dead[v]:
                failed_links += m
                continue
            keep = m
            if spec.link_fraction > 0:
                n_phys = max(1, int(round(m)))
                k_fail = rng.binomial(n_phys, spec.link_fraction)
                keep = m * (1.0 - k_fail / n_phys)
            if keep <= 0:
                failed_links += m
                fully_failed.append((u, v))
                continue
            failed_links += m - keep
            out.add_edge(int(node_map[u]), int(node_map[v]), keep,
                         tier=graph.tier.get((u, v), ""))
    return DegradedGraph(out, node_map, [int(u) for u in np.flatnonzero(dead)],
                         failed_links, fully_failed, graph.total_links())


def degraded_router(topo: Topology, spec: FailureSpec, device=None):
    """(GraphRouter over the degraded fabric on ``device``, default
    ``cuda``; DegradedGraph).

    Raises ``NotImplementedError`` if ``topo`` has no explicit switch
    graph, ``ValueError`` if the failures disconnect the fabric; the
    failures suite turns both into explicit records.
    """
    dg = degrade_graph(topo.build_graph(), spec)
    router = GraphRouter(dg.graph, device=device)
    router.hops  # force the BFS: raises ValueError when disconnected
    get_metrics().inc("failures.reroute_recomputes")
    return router, dg


def plane_capacity_factor(topo: Topology, spec: FailureSpec) -> float:
    """Delivered-bandwidth factor of whole-plane failures: survivors
    re-carry the sprayed load, so at most ``alive / n`` gets through."""
    n = topo.n_planes
    if spec.planes_down >= n:
        raise ValueError(f"planes_down={spec.planes_down} >= {n} planes")
    return (n - spec.planes_down) / n


def failure_throughput(topo: Topology, demand_builder, spec: FailureSpec,
                       offered_per_nic_gbps: float, mode: str = "adaptive",
                       device=None, backend: "str | None" = None) -> dict:
    """Healthy-vs-degraded saturation throughput for one traffic matrix.

    ``demand_builder(topo, offered, graph) -> DemandArrays`` (a scenario's
    ``build`` bound to a device).  Both sides route on the graph engine
    on ``device`` (default ``cuda``) with the reductions' ``backend``;
    surviving planes carry ``n / alive`` of the sprayed load when planes
    are down.
    """
    dev = resolve_device(device)
    healthy_g = topo.build_graph()
    healthy = GraphRouter(healthy_g, device=dev)
    router, dg = degraded_router(topo, spec, device=dev)
    factor = plane_capacity_factor(topo, spec)
    scale = 1.0 / factor                   # per-surviving-plane load
    dem_h = demand_builder(topo, offered_per_nic_gbps, healthy_g)
    dem_d = demand_builder(topo, offered_per_nic_gbps * scale, dg.graph)
    ll_h = healthy.route(dem_h, mode, backend=backend)
    ll_d = router.route(dem_d, mode, backend=backend)
    thpt_h = ll_h.saturation_throughput()
    thpt_d = ll_d.saturation_throughput() * factor
    return {
        "mode": mode,
        "healthy_max_util": round(ll_h.max_utilization(), 6),
        "degraded_max_util": round(ll_d.max_utilization(), 6),
        "healthy_throughput_fraction": round(thpt_h, 6),
        "degraded_throughput_fraction": round(thpt_d, 6),
        "throughput_retained": round(thpt_d / thpt_h, 6) if thpt_h else 0.0,
        "plane_capacity_factor": round(factor, 6),
        **dg.info(),
    }


def _failed_edge_ids(csr, dg: DegradedGraph) -> torch.Tensor:
    """Healthy directed-edge ids that lost every link or touch a dead
    switch (the reference's scan over the edges, as one mask)."""
    S = csr.n_switches
    lo = torch.minimum(csr.src, csr.dst)
    hi = torch.maximum(csr.src, csr.dst)
    gone = torch.tensor([u * S + v for u, v in dg.fully_failed_edges],
                        dtype=torch.int64, device=csr.device)
    dead = torch.zeros(S, dtype=torch.bool, device=csr.device)
    dead[torch.tensor(dg.failed_switches, dtype=torch.int64,
                      device=csr.device)] = True
    mask = torch.isin(lo * S + hi, gone) | dead[csr.src] | dead[csr.dst]
    return torch.nonzero(mask).squeeze(1)


def recovery_curve(topo: Topology, demand_builder, spec: FailureSpec,
                   offered_per_nic_gbps: float, mode: str = "adaptive",
                   throughput_row: "dict | None" = None,
                   reroute_wall_s: "float | None" = None,
                   reroute: str = "none",
                   protection: "ProtectedRouter | None" = None,
                   n_layers: int = 4, device=None,
                   backend: "str | None" = None) -> "list[dict]":
    """Degraded-fabric recovery curve for one traffic matrix, on
    ``device`` (default ``cuda``; a ``protection`` router brings its own)
    with the reductions' ``backend``.

    The phase sequence depends on ``reroute``:

    * ``"none"``: ``healthy`` / ``failed`` / ``rerouted`` (survivors
      re-route on the degraded graph: a full BFS and re-route);
    * ``"local"``: ``healthy`` / ``failed`` / ``local_reroute`` (stale
      distances and MRC backup layers, no BFS);
    * ``"global"``: ``healthy`` / ``failed`` / ``local_reroute`` /
      ``reconverged`` (the local bridge, then global reconvergence).

    ``failed`` is the pre-reroute instant: traffic still follows healthy
    minimal paths, so the ECMP share crossing a failed element stalls
    (first-order estimate from the incidence).  Protection state is
    forced before the failure instant (provisioning work; never in a
    recovery wall).  A precomputed :func:`failure_throughput` record
    (``throughput_row``) and its wall (``reroute_wall_s``) stand in for
    the ``rerouted`` / ``reconverged`` recompute.

    Each row carries ``reroute``, ``phase_wall_s`` (the phase's wall,
    device work included) and ``t_offset_s``; an active flight recorder
    gets the same spans on a ``failures`` track.
    """
    validate_reroute_mode(reroute)
    backend = resolve_sim_backend(backend)
    if reroute != "none":
        if protection is None:
            protection = ProtectedRouter(topo, n_layers=n_layers,
                                         backend=backend, device=device)
        protection.backup_next_hops()   # provisioning-time, pre-failure
        healthy = protection.router
        healthy_g = healthy.graph
    else:
        healthy_g = topo.build_graph()
        healthy = GraphRouter(healthy_g, device=device)
    dev = healthy.device
    t0 = time.perf_counter()
    dem = demand_builder(topo, offered_per_nic_gbps, healthy_g)
    ll_h = healthy.route(dem, mode, backend=backend)
    synchronize(dev)
    wall_h = time.perf_counter() - t0
    rows = [{"phase": "healthy", "delivered_fraction":
             round(min(1.0, ll_h.saturation_throughput()), 6),
             "max_util": round(ll_h.max_utilization(), 6)}]
    # detect window: sample what broke + estimate the pre-reroute loss
    t0 = time.perf_counter()
    dg = degrade_graph(healthy_g, spec)
    # pre-reroute: flows lose the ECMP share that crossed failed edges
    inc = flow_incidence(healthy, dem, "minimal", backend=backend)
    edge_ids = _failed_edge_ids(healthy.csr, dg)
    lost = inc.edge_share(edge_ids, backend) if edge_ids.numel() else \
        torch.zeros(dem.n, dtype=torch.float64, device=dev)
    g = dem.gbps.to(dev, torch.float64)
    factor = plane_capacity_factor(topo, spec)
    g_sum = float(np_sum(g))
    stall_delivered = float(np_sum(g * (1 - lost))) / g_sum if g_sum \
        else 1.0
    synchronize(dev)
    wall_f = time.perf_counter() - t0
    rows.append({"phase": "failed",
                 "delivered_fraction":
                     round(min(1.0, ll_h.saturation_throughput())
                           * stall_delivered * factor, 6),
                 "stalled_share": round(1 - stall_delivered, 6)})
    walls = [wall_h, wall_f]
    mx = get_metrics()
    if reroute != "none":
        # local window: precomputed-backup reroute, table lookups and
        # load propagation over stale distances, no BFS, no rebuild
        t0 = time.perf_counter()
        lr = protection.local_reroute_loads(dem, dg)
        sat = lr.saturation_throughput()
        rows.append({"phase": "local_reroute",
                     "delivered_fraction":
                         round(min(1.0, sat * lr.delivered_share)
                               * factor, 6),
                     "max_util": round(lr.max_utilization(), 6),
                     "stalled_share": round(lr.stalled_share, 6),
                     "diverted_gbps": round(lr.diverted_gbps, 6),
                     "conservation_residual": lr.conservation_residual})
        synchronize(dev)
        wall_l = time.perf_counter() - t0
        walls.append(wall_l)
        mx.observe("failures.local_reroute_wall_s", wall_l)
    if reroute in ("none", "global"):
        # re-route window: the global degraded-routing recompute
        phase = "rerouted" if reroute == "none" else "reconverged"
        t0 = time.perf_counter()
        try:
            rr = throughput_row if throughput_row is not None else \
                failure_throughput(topo, demand_builder, spec,
                                   offered_per_nic_gbps, mode, device=dev,
                                   backend=backend)
            rows.append({"phase": phase,
                         "delivered_fraction":
                             round(min(1.0,
                                       rr["degraded_throughput_fraction"]),
                                   6),
                         "max_util": rr["degraded_max_util"]})
        except ValueError as e:           # disconnected survivors
            rows.append({"phase": phase, "disconnected": True,
                         "reason": str(e)})
        synchronize(dev)
        wall_r = time.perf_counter() - t0
        if throughput_row is not None and reroute_wall_s is not None:
            wall_r = reroute_wall_s           # the reused recompute's wall
        walls.append(wall_r)
        mx.observe("failures.reroute_wall_s", wall_r)
    offset = 0.0
    rec = get_recorder()
    for row, wall in zip(rows, walls):
        row["reroute"] = reroute
        row["phase_wall_s"] = round(wall, 6)
        row["t_offset_s"] = round(offset, 6)
        if rec is not None:
            rec.span(f"{spec.label()}:{row['phase']}", offset, wall,
                     process="failures", thread=f"{topo.name}:{reroute}",
                     cat="recovery",
                     args={k: v for k, v in row.items()
                           if k not in ("phase_wall_s", "t_offset_s")})
        offset += wall
    mx.observe("failures.detect_wall_s", wall_f)
    return rows


def time_to_recover(rows: "list[dict]", target: float = 0.9
                    ) -> "float | None":
    """Seconds from the failure instant (start of the detect window)
    until delivered throughput first returns to ``target`` × the healthy
    level, measured at the end of the phase that gets there.

    ``None`` when no phase recovers (e.g. disconnected survivors).
    """
    if not rows or rows[0].get("phase") != "healthy":
        raise ValueError("rows must start with the healthy phase")
    if len(rows) < 2:               # nothing ever failed
        return None
    healthy = rows[0].get("delivered_fraction", 0.0)
    fail_t = rows[1]["t_offset_s"]
    for row in rows[1:]:
        df = row.get("delivered_fraction")
        if df is not None and df >= target * healthy - 1e-12:
            return round(row["t_offset_s"] + row["phase_wall_s"] - fail_t,
                         6)
    return None
