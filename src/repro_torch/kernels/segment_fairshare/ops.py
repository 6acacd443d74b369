"""Checked wrappers of the CUDA segment reductions, and their plans.

``segment_sum(values, segment_ids, num_segments, plan=None)`` and
``segment_min(...)`` keep the meaning of the Pallas kernels they replace
(``repro/kernels/segment_fairshare/kernel.py``): a scatter-add, or a
per-segment min with ``+inf`` for empty segments, of a float64 COO value
vector; entries with an id outside ``[0, num_segments)`` are dropped.

The checks run the same way on every device.  Then, for a tensor on the
CPU the wrappers return the plain PyTorch version (:mod:`.ref`); for a
CUDA tensor they launch the kernel or raise: there is no fallback.  A
:class:`SegmentPlan` (CSR offsets, the stable permutation into segment
order, and the lanes a segment) is built once per incidence and passed
with ``plan=`` beside the very id tensor it was built from; without one
the wrapper builds it for the call.

The launch path is thin, as RMSNorm's (``kernels/rmsnorm/ops.py``): the
tensors' attributes are read once, the output comes from
``values.new_empty``, the stream from
``torch._C._cuda_getCurrentRawStream`` (not a ``torch.cuda.Stream``
object: 3.4-6.2 us against 0.1-0.2 on the H100's host,
``tools/segment_times.py``), there is no ``torch.cuda.device`` context
(2.4-4.3 us; the C entry point makes the device current only when it is
not), and the entry point is the bound ctypes function.  It can be
captured in a CUDA graph.

``LAUNCHES`` counts kernel launches per wrapper: one is added where a
kernel is launched, and nowhere else.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from .._build import CudaLibrary
from .ref import segment_min_ref, segment_sum_ref

# values, perm, offsets, num_segments, lanes, device, out, stream
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
LIBRARY = CudaLibrary(
    "segment_reduce",
    Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu",
    {"segment_sum_f64": _ARGS, "segment_min_f64": _ARGS})

LAUNCHES = {"segment_sum": 0, "segment_min": 0}

# the kernel's instances: lanes a segment (csrc/segment_reduce.cu)
LANES = (1, 2, 4, 8, 16, 32)
_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lanes_for(nnz: int, num_segments: int) -> int:
    """Lanes a segment for ``nnz`` entries in ``num_segments`` segments:
    the smallest power of two G <= 32 with G * num_segments >= nnz (at or
    above the mean segment length), else 32.  A function of the two
    counts alone, so it needs no look at the device."""
    lanes = 1
    while lanes < LANES[-1] and lanes * num_segments < nnz:
        lanes *= 2
    return lanes


@dataclass(frozen=True)
class SegmentPlan:
    """Segment order of one COO id vector, ``ids``.

    ``offsets`` (num_segments + 1,) int32: segment ``s`` owns positions
    ``offsets[s]:offsets[s+1]`` of the sorted order.  ``perm`` (NNZ,)
    int32 maps those positions to entries, or is None when the ids are
    already sorted (the incidence's flow column).  ``lanes``: the lanes
    of a warp that reduce one segment (one of ``LANES``), which fixes the
    kernel's order of operations (:func:`.ref.segment_sum_ordered_ref`).
    """

    ids: torch.Tensor
    offsets: torch.Tensor
    perm: "torch.Tensor | None"
    num_segments: int
    nnz: int
    lanes: int

    def __post_init__(self):
        if self.lanes not in LANES:
            raise ValueError(f"lanes must be one of {LANES}, got "
                             f"{self.lanes}")

    def keep(self, kept: torch.Tensor, ids: torch.Tensor) -> "SegmentPlan":
        """The plan of ``ids``, this plan's ids renumbered so that segment
        ``kept[i]`` becomes ``i``.  ``kept`` is ascending and holds every
        non-empty segment, so the renumbering keeps the order and the
        permutation stays; the lanes follow the kept count
        (:func:`lanes_for`)."""
        n = int(kept.shape[0])
        offsets = torch.cat([self.offsets[kept], self.offsets[-1:]])
        return SegmentPlan(ids, offsets, self.perm, n, self.nnz,
                           lanes_for(self.nnz, n))


def make_plan(segment_ids: torch.Tensor, num_segments: int, *,
              presorted: bool = False) -> SegmentPlan:
    """Plan for ``segment_ids``, with :func:`lanes_for` lanes a segment
    (``dataclasses.replace(plan, lanes=G)`` forces another G).
    ``presorted=True`` skips the sort and checks that the ids are
    non-decreasing instead."""
    if segment_ids.dim() != 1:
        raise ValueError("segment_ids must be 1-D")
    nnz = segment_ids.numel()
    if nnz > _INT32_MAX or num_segments > _INT32_MAX:
        raise ValueError("segment plans index with int32: at most 2**31-1 "
                         f"entries and segments, got {nnz} / {num_segments}")
    if presorted:
        if nnz > 1 and bool((segment_ids[1:] < segment_ids[:-1]).any()):
            raise ValueError("presorted=True, but the segment ids are not "
                             "sorted")
        sorted_ids, perm = segment_ids, None
    else:
        sorted_ids, perm = torch.sort(segment_ids, stable=True)
        perm = perm.to(torch.int32)
    bounds = torch.arange(num_segments + 1, dtype=sorted_ids.dtype,
                          device=sorted_ids.device)
    offsets = torch.searchsorted(sorted_ids, bounds).to(torch.int32)
    return SegmentPlan(segment_ids, offsets, perm, num_segments, nnz,
                       lanes_for(nnz, num_segments))


def check_inputs(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, plan) -> torch.device:
    """The wrappers' checks, the same on every device.  Reads each of
    values' attributes once; returns its device."""
    dev, shape = values.device, values.shape
    if values.dtype != torch.float64:
        raise TypeError(f"values must be float64, got {values.dtype}")
    if len(shape) != 1 or segment_ids.shape != shape:
        raise ValueError("values and segment_ids must be 1-D of one length, "
                         f"got {tuple(shape)} and "
                         f"{tuple(segment_ids.shape)}")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32 or int64, got "
                        f"{segment_ids.dtype}")
    if segment_ids.device != dev:
        raise ValueError("values and segment_ids lie on different devices")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if plan is None:
        return dev
    if plan.num_segments != num_segments or plan.nnz != shape[0]:
        raise ValueError("plan was built for another incidence: "
                         f"{plan.nnz} entries / {plan.num_segments} segments, "
                         f"called with {shape[0]} / {num_segments}")
    if plan.ids is not segment_ids:
        raise ValueError("plan was built for another incidence: pass the "
                         "segment_ids tensor the plan was made from")
    for t in (plan.offsets, plan.perm):
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(f"plan tensors must be contiguous int32 on "
                             f"{dev}")
    return dev


def _launch(name: str, entry: str, values, segment_ids, num_segments: int,
            plan, dev: torch.device) -> torch.Tensor:
    out = values.new_empty(num_segments)
    if num_segments == 0:
        return out
    if plan is None:
        plan = make_plan(segment_ids, num_segments)
    perm = plan.perm
    idx = dev.index
    rc = LIBRARY.function(entry)(
        values.data_ptr(), None if perm is None else perm.data_ptr(),
        plan.offsets.data_ptr(), num_segments, plan.lanes, idx,
        out.data_ptr(), torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        LIBRARY.fail(name, rc)
    LAUNCHES[name] += 1
    return out


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, plan: "SegmentPlan | None" = None
                ) -> torch.Tensor:
    """Scatter-add ``values`` (NNZ,) into ``num_segments`` bins."""
    dev = check_inputs(values, segment_ids, num_segments, plan)
    if not values.is_cuda:   # not dev.type, which builds a string each call
        if dev.type == "cpu":
            return segment_sum_ref(values, segment_ids, num_segments)
        raise ValueError(f"segment_sum: no kernel for device {dev}")
    return _launch("segment_sum", "segment_sum_f64", values, segment_ids,
                   num_segments, plan, dev)


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, plan: "SegmentPlan | None" = None
                ) -> torch.Tensor:
    """Per-segment min of ``values`` (NNZ,); empty segments hold +inf."""
    dev = check_inputs(values, segment_ids, num_segments, plan)
    if not values.is_cuda:
        if dev.type == "cpu":
            return segment_min_ref(values, segment_ids, num_segments)
        raise ValueError(f"segment_min: no kernel for device {dev}")
    return _launch("segment_min", "segment_min_f64", values, segment_ids,
                   num_segments, plan, dev)
