"""Plane spraying on the simulated fabric (port of
``repro/sim/spray.py``).

A sprayed flow splits into per-plane subflows by the NIC's whole-chunk
round-robin schedule (:func:`repro_torch.core.planes.split_chunks`);
every plane is an identical fabric copy, so each plane runs the same
incidence tensor over its own subflow sizes.  A flow completes when its
*slowest* plane does (max over planes): plane skew multiplies a plane's
transfer time, a dead plane (skew = inf) re-sprays its bytes over the
survivors, and per-chunk overheads are charged per plane.  The
uncontended single-flow case reproduces
:func:`repro_torch.core.planes.spray_completion_time` when all planes
are alive (any skew), and for dead planes when the per-chunk overhead is
zero and the survivors are unskewed: re-sprayed bytes are added to the
survivor subflows *before* chunking and skewing, where ``planes.py``
charges them as overhead-free unskewed transfer time.

The split keeps the reference's float64 bits on every device: the
divisions by a Python number divide by a device scalar (on the card
``x / d`` would multiply by the reciprocal and round twice), the dead
planes' bytes add column by column in column order (numpy's order for a
few columns), and the flowlet bins add their flowlets one by one in
flowlet order (:func:`repro_torch.core.routing_vec.ordered_sum` over a
plan with one lane a segment, ``np.add.at``'s order).  The flowlet hash
is the reference's ``uint64`` splitmix64 in ``int64`` arithmetic, which
gives the same low 64 bits (:func:`_mix64`).

The planes' event loops run one after another over one incidence, built
once on the simulation's device with its segment plans, so a sprayed run
sorts the incidence's columns once whatever its plane count.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device, resolve_sim_backend
from ..core.netsim import DEFAULT_NET, NetParams, make_router
from ..core.planes import SprayConfig
from ..core.routing_vec import div_scalar, ordered_sum
from ..kernels.segment_fairshare import make_plan
from ..telemetry import get_metrics
from .events import (FlowSpec, flows_to_demands, path_latency,
                     simulate_incidence)
from .fairshare import flow_incidence

F64 = torch.float64
I64 = torch.int64

_U64 = 1 << 64


def _s64(c: int) -> int:
    """The ``int64`` whose bits are the ``uint64`` ``c mod 2**64``."""
    c %= _U64
    return c - _U64 if c >= 1 << 63 else c


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of ``int64`` bits (``>>`` is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """``uint64`` ``x % n`` of ``int64`` bits, for ``n >= 1``."""
    r = x.remainder(n)
    return torch.where(x < 0, (r + _U64 % n) % n, r)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on ``int64`` tensors: the low 64 bits of the
    reference's wrap-around ``uint64`` arithmetic (adds, multiplies and
    XORs give the same bits; the shifts are masked to be logical)."""
    x = x + _s64(0x9E3779B97F4A7C15)
    x = x ^ _shr(x, 30)
    x = x * _s64(0xBF58476D1CE4E5B9)
    x = x ^ _shr(x, 27)
    x = x * _s64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


@dataclass
class SprayedSimResult:
    """Per-flow sprayed completion over all planes (tensors on the
    simulation's device)."""

    completion_s: torch.Tensor      # (F,) max-over-planes FCT incl. alpha
    plane_transfer_s: torch.Tensor  # (F, n_planes) skewed transfer+overhead
    per_plane_bytes: torch.Tensor   # (F, n_planes) bytes after re-spray
    latency_s: torch.Tensor         # (F,) path alpha term (charged once)
    stalled: torch.Tensor           # (F,) bool

    @property
    def makespan_s(self) -> float:
        ok = self.completion_s[~self.stalled]
        return float(ok.max()) if ok.numel() else 0.0


def flowlet_split(sizes, n_buckets: int, flowlet_bytes: float,
                  seed: int = 0, alive=None, backend: "str | None" = None,
                  device=None) -> "tuple[torch.Tensor, torch.Tensor]":
    """Hash each flow's flowlets over ``n_buckets`` planes/layers.

    FatPaths-style flowlet switching: flow ``i`` is cut into
    ``ceil(sizes[i] / flowlet_bytes)`` flowlets (the last one partial)
    and flowlet ``j`` lands on bucket ``mix64(flow, j, seed) %
    n_buckets``.  When ``alive`` marks dead buckets, only the flowlets
    that hashed onto a dead bucket re-hash (salted) over the alive set:
    every alive-bucket assignment is *identical* to the healthy split.

    ``sizes`` is a tensor (its device is used) or an array (moved to
    ``device``, default ``cuda``); ``backend`` (``cuda`` or ``torch``) is
    that of the bins' fixed-order sum.  Returns ``(bytes (F, n_buckets)
    float64, counts (F, n_buckets) int64)``, the reference's bits.
    """
    backend = resolve_sim_backend(backend)
    dev = sizes.device if torch.is_tensor(sizes) else resolve_device(device)
    sizes = torch.as_tensor(sizes, dtype=F64, device=dev)
    if flowlet_bytes <= 0:
        raise ValueError("flowlet_bytes must be positive")
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    alive = np.ones(n_buckets, dtype=bool) if alive is None \
        else np.asarray(torch.as_tensor(alive).cpu(), dtype=bool)
    if alive.shape != (n_buckets,):
        raise ValueError("alive mask length mismatch")
    if not alive.any():
        raise RuntimeError("all buckets down")
    if not 0 <= seed < _U64:
        raise OverflowError(f"seed {seed} out of bounds for uint64")
    F = sizes.shape[0]
    n_fl = torch.ceil(div_scalar(sizes, flowlet_bytes)).to(I64)
    tot = int(n_fl.sum())
    if tot == 0:
        return (torch.zeros((F, n_buckets), dtype=F64, device=dev),
                torch.zeros((F, n_buckets), dtype=I64, device=dev))
    ends = torch.cumsum(n_fl, 0)
    flow_of = torch.repeat_interleave(torch.arange(F, device=dev), n_fl,
                                      output_size=tot)
    idx = torch.arange(tot, device=dev) - torch.repeat_interleave(
        ends - n_fl, n_fl, output_size=tot)
    h = _mix64(_mix64(flow_of ^ _s64(seed * 0x9E3779B1)) ^ idx)
    b = _umod(h, n_buckets)
    alive_t = torch.as_tensor(alive, device=dev)
    dead_sel = ~alive_t[b]
    n_dead = int(dead_sel.sum())
    if n_dead:
        alive_ids = torch.as_tensor(np.flatnonzero(alive), device=dev)
        h2 = _mix64(h[dead_sel] ^ _s64(0xD6E8FEB86659FD93))
        b[dead_sel] = alive_ids[_umod(h2, alive_ids.shape[0])]
        get_metrics().inc("spray.flowlet_rehashes", n_dead)
    sizes_fl = torch.full((tot,), float(flowlet_bytes), dtype=F64,
                          device=dev)
    has = n_fl > 0
    sizes_fl[(ends - 1)[has]] = sizes[has] \
        - (n_fl[has] - 1).to(F64) * flowlet_bytes
    ids = flow_of * n_buckets + b
    n_bins = F * n_buckets
    # np.add.at's order: each bin adds its flowlets one by one, in order
    plan = dataclasses.replace(make_plan(ids, n_bins), lanes=1) \
        if ids.is_cuda else None
    bytes_out = ordered_sum(sizes_fl, ids, n_bins, backend, plan=plan)
    counts = torch.bincount(ids, minlength=n_bins)
    return bytes_out.view(F, n_buckets), counts.view(F, n_buckets)


def _per_plane_bytes(sizes: torch.Tensor, cfg: SprayConfig) -> torch.Tensor:
    """(F, n) whole-chunk round-robin split of each flow (vectorized
    :func:`repro_torch.core.planes.split_chunks`), the reference's four
    float64 updates in its order."""
    n = cfg.n_planes
    c = cfg.chunk_bytes
    F = sizes.shape[0]
    dev = sizes.device
    out = torch.zeros((F, n), dtype=F64, device=dev)
    n_chunks = torch.ceil(div_scalar(sizes, c)).to(I64)
    full, rem = n_chunks // n, n_chunks % n
    out += (full[:, None] * c).to(F64)
    # planes 0..rem-1 get one extra chunk each
    extra = torch.arange(n, device=dev)[None, :] < rem[:, None]
    out += (extra * c).to(F64)
    # the final (possibly partial) chunk lands on plane (n_chunks-1) % n
    tail = sizes - ((n_chunks - 1) * c).to(F64)
    has = n_chunks > 0
    last = (n_chunks - 1) % n
    rows = torch.arange(F, device=dev)[has]
    out[rows, last[has]] += tail[has] - c
    return out


def simulate_sprayed(topo, flows: "list[FlowSpec]",
                     cfg: "SprayConfig | None" = None,
                     mode: str = "minimal",
                     plane_skew: "list[float] | None" = None,
                     rate_cap_gbps=None,
                     net: NetParams = DEFAULT_NET,
                     engine: str = "auto", backend: "str | None" = None,
                     router=None, granularity: str = "chunk",
                     flowlet_bytes: "float | None" = None,
                     flowlet_seed: int = 0,
                     device=None) -> SprayedSimResult:
    """Simulate sprayed flows across all ``topo.n_planes`` planes.

    ``plane_skew[k] >= 1`` multiplies plane ``k``'s transfer time
    (congested/degraded plane); ``inf`` marks a dead plane whose bytes are
    re-sprayed evenly over the survivors before simulation.
    ``rate_cap_gbps`` is one plane's injection cap: a number for every
    flow, or a per-flow array or tensor of length F (a merged flow's
    aggregate of NIC ports), moved once to the simulation's device;
    default the topology's port rate.  All planes share one incidence
    tensor (identical fabric copies), so the cost is
    ``n_alive`` event-loop runs over the same routes.

    ``granularity`` selects the plane split: ``"chunk"`` (default) is the
    NIC's deterministic whole-chunk round-robin; ``"flowlet"`` hashes
    ``flowlet_bytes``-sized flowlets over the planes
    (:func:`flowlet_split`), and dead planes only re-hash the flowlets
    that landed on them.

    Runs on ``router``'s device; without a router, on one made for
    ``topo`` on ``device`` (default ``cuda``).  ``backend`` (``cuda``:
    the hand-written kernels, the default; ``torch``: the plain
    versions) is the solver's and the router's reduction backend.
    """
    backend = resolve_sim_backend(backend)
    cfg = cfg or SprayConfig(n_planes=topo.n_planes)
    skew = list(plane_skew or [1.0] * cfg.n_planes)
    if len(skew) != cfg.n_planes:
        raise ValueError("plane_skew length mismatch")
    if granularity not in ("chunk", "flowlet"):
        raise ValueError(f"unknown spray granularity {granularity!r}")
    if router is None:
        router = make_router(topo, engine=engine, device=device)
    dev = router.device
    sizes = torch.tensor([f.size_bytes for f in flows], dtype=F64,
                         device=dev)
    starts = torch.tensor([f.start_s for f in flows], dtype=F64,
                          device=dev)
    alive = [k for k, s in enumerate(skew) if not math.isinf(s)]
    if not alive:
        raise RuntimeError("all planes down")
    dead = [k for k in range(cfg.n_planes) if k not in alive]
    mx = get_metrics()
    mx.inc("spray.plane_sims", len(alive))
    if granularity == "flowlet":
        alive_mask = np.zeros(cfg.n_planes, dtype=bool)
        alive_mask[alive] = True
        fl_bytes = flowlet_bytes if flowlet_bytes is not None \
            else cfg.chunk_bytes
        per_plane, fl_counts = flowlet_split(sizes, cfg.n_planes, fl_bytes,
                                             seed=flowlet_seed,
                                             alive=alive_mask,
                                             backend=backend)
        mx.inc("spray.flowlets", int(fl_counts.sum()))
        if dead:
            mx.inc("spray.respray_events", len(dead))
    else:
        per_plane = _per_plane_bytes(sizes, cfg)
        if dead:
            mx.inc("spray.respray_events", len(dead))
            # numpy's sum of a few columns: one by one, in column order
            extra = per_plane[:, dead[0]]
            for k in dead[1:]:
                extra = extra + per_plane[:, k]
            extra = div_scalar(extra, len(alive))
            per_plane[:, dead] = 0.0
            for k in alive:
                per_plane[:, k] += extra
    # one incidence on the simulation's device: its segment plans are
    # built by the first plane's loop and reused by the others
    inc = flow_incidence(router, flows_to_demands(flows, device=dev), mode,
                         backend=backend)
    F = sizes.shape[0]
    cap = torch.as_tensor(
        topo.port_gbps if rate_cap_gbps is None else rate_cap_gbps,
        dtype=F64, device=dev)
    if cap.dim() and tuple(cap.shape) != (F,):
        raise ValueError(f"rate_cap_gbps has shape {tuple(cap.shape)}; "
                         f"expected a number or ({F},)")
    plane_t = torch.zeros((F, cfg.n_planes), dtype=F64, device=dev)
    stalled = torch.zeros(F, dtype=torch.bool, device=dev)
    for k in alive:
        size_k = per_plane[:, k].contiguous()
        res = simulate_incidence(inc, size_k, cap, start_s=starts, net=net,
                                 backend=backend, device=dev)
        if granularity == "flowlet":
            n_chunks = fl_counts[:, k].to(F64)
        else:
            n_chunks = torch.ceil(div_scalar(size_k, cfg.chunk_bytes))
        transfer = res.transfer_s() + n_chunks * cfg.per_chunk_overhead_s
        plane_t[:, k] = transfer * skew[k]
        stalled |= res.stalled
    lat = path_latency(inc, net, backend)
    completion = torch.where(stalled, torch.inf,
                             plane_t.max(dim=1).values + lat)
    return SprayedSimResult(completion_s=completion,
                            plane_transfer_s=plane_t,
                            per_plane_bytes=per_plane,
                            latency_s=lat, stalled=stalled)
