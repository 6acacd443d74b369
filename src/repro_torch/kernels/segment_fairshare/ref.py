"""Plain PyTorch versions of the COO segment reductions.

The CPU path of :mod:`.ops` and the yardstick the CUDA kernels are held
against on the card.  Entries whose id lies outside ``[0, num_segments)``
are dropped, as the Pallas kernel drops its padding: they are sent to
one spare bin past the end, which is cut off.

``segment_sum_ordered_ref`` is the kernel's ordered twin: the same sums
in the CUDA kernel's order of additions, read from a segment plan, so
the kernel can be held to it bit for bit (``index_add_`` adds in no
fixed order on the card).  It is also the plain path
(``backend="torch"``) of the router's fixed-order sums on the card
(``repro_torch.core.routing_vec.ordered_sum``: the array router's
adaptive load update and incidence coalescing, the graph router's
scatter-adds).  A min is the same in any order, so
``segment_min_ref`` is the min kernel's yardstick as it is.
"""

from __future__ import annotations

import torch


def _spare_bin_ids(segment_ids: torch.Tensor, num_segments: int):
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    return torch.where(keep, segment_ids, num_segments)


def segment_sum_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(NNZ,) values scatter-added into (num_segments,) bins."""
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, _spare_bin_ids(segment_ids, num_segments), values)
    return out[:num_segments]


def segment_min_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(NNZ,) values segment-min'd into (num_segments,) bins; empty
    segments hold +inf."""
    out = torch.full((num_segments + 1,), torch.inf, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, _spare_bin_ids(segment_ids, num_segments),
                        values, "amin")
    return out[:num_segments]


def segment_sum_ordered_ref(values: torch.Tensor, plan,
                            lanes: "int | None" = None) -> torch.Tensor:
    """(num_segments,) sums of ``values`` (NNZ,) over ``plan``'s segments
    (a :class:`.ops.SegmentPlan`), added in the order of the CUDA kernel
    run with ``lanes`` lanes a segment (default: the plan's).

    That order: lane ``l`` of a segment's G lanes adds the segment's
    entries ``l, l + G, l + 2G, ...`` (in plan order) one by one, from
    +0.0; then a tree of width G, ``G/2`` down to 1, in which lane ``l <
    off`` adds lane ``l + off``'s partial to its own; lane 0 holds the
    sum.  Runs on any device, vectorised over segments.
    """
    G = plan.lanes if lanes is None else lanes
    n = plan.num_segments
    offsets = plan.offsets.to(torch.int64)
    lo, hi = offsets[:-1, None], offsets[1:, None]
    ordered = values if plan.perm is None else values[plan.perm.long()]
    acc = torch.zeros((n, G), dtype=values.dtype, device=values.device)
    longest = int((hi - lo).max()) if n else 0
    steps = -(-longest // G)
    if steps * n * G <= 4 * ordered.numel() + (1 << 20):
        # the entries laid out (step, segment, lane), +0.0 where a lane
        # has none: one add a step.  Adding +0.0 keeps a partial's bits
        # (a partial that starts at +0.0 is never -0.0), so these are
        # the bits of the masked loop below.
        seg = torch.repeat_interleave(
            torch.arange(n, device=values.device), (hi - lo).squeeze(1))
        # the entries the segments own (ids out of range sort outside)
        idx = offsets[0] + torch.arange(seg.numel(), device=values.device)
        pos = idx - offsets[:-1][seg]
        grid = torch.zeros((steps, n, G), dtype=values.dtype,
                           device=values.device)
        grid[pos // G, seg, pos % G] = ordered[idx]
        for step in range(steps):
            acc = acc + grid[step]
    else:
        lane = torch.arange(G, device=values.device)
        for step in range(0, longest, G):
            idx = lo + step + lane
            live = idx < hi
            acc = torch.where(live, acc + ordered[torch.where(live, idx, 0)],
                              acc)
    off = G // 2
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0].contiguous()
