"""Checked wrappers of the CUDA segment reductions, and their plans.

``segment_sum(values, segment_ids, num_segments, plan=None)`` and
``segment_min(...)`` keep the meaning of the Pallas kernels they replace
(``repro/kernels/segment_fairshare/kernel.py``): a scatter-add, or a
per-segment min with ``+inf`` for empty segments, of a float64 COO value
vector; entries with an id outside ``[0, num_segments)`` are dropped.

For a tensor on the CPU the wrappers return the plain PyTorch version
(:mod:`.ref`).  For a CUDA tensor they launch the kernel or raise; there
is no fallback.  A :class:`SegmentPlan` (CSR offsets plus the stable
permutation into segment order) is built once per incidence and passed
with ``plan=`` beside the very id tensor it was built from; without one
the wrapper builds it for the call.

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

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_void_p]
LIBRARY = CudaLibrary(
    "segment_reduce",
    Path(__file__).resolve().parent / "csrc" / "segment_reduce.cu",
    {"segment_sum_f64": _ARGS, "segment_min_f64": _ARGS})

LAUNCHES = {"segment_sum": 0, "segment_min": 0}

_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class SegmentPlan:
    """Segment order of one COO id vector, ``ids``.

    ``offsets`` (num_segments + 1,) int32: segment ``s`` owns positions
    ``offsets[s]:offsets[s+1]`` of the sorted order.  ``perm`` (NNZ,)
    int32 maps those positions to entries, or is None when the ids are
    already sorted (the incidence's flow column).
    """

    ids: torch.Tensor
    offsets: torch.Tensor
    perm: "torch.Tensor | None"
    num_segments: int
    nnz: int


def make_plan(segment_ids: torch.Tensor, num_segments: int, *,
              presorted: bool = False) -> SegmentPlan:
    """Plan for ``segment_ids``.  ``presorted=True`` skips the sort and
    checks that the ids are non-decreasing instead."""
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
    return SegmentPlan(segment_ids, offsets, perm, num_segments, nnz)


def _check(values, segment_ids, num_segments: int, plan) -> None:
    if values.dtype != torch.float64:
        raise TypeError(f"values must be float64, got {values.dtype}")
    if values.dim() != 1 or segment_ids.shape != values.shape:
        raise ValueError("values and segment_ids must be 1-D of one length, "
                         f"got {tuple(values.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32 or int64, got "
                        f"{segment_ids.dtype}")
    if segment_ids.device != values.device:
        raise ValueError("values and segment_ids lie on different devices")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if plan is None:
        return
    if plan.num_segments != num_segments or plan.nnz != values.numel():
        raise ValueError("plan was built for another incidence: "
                         f"{plan.nnz} entries / {plan.num_segments} segments, "
                         f"called with {values.numel()} / {num_segments}")
    if plan.ids is not segment_ids:
        raise ValueError("plan was built for another incidence: pass the "
                         "segment_ids tensor the plan was made from")


def _launch(name: str, entry: str, values, segment_ids, num_segments: int,
            plan) -> torch.Tensor:
    if values.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {values.device}")
    if not values.is_contiguous():
        raise ValueError(f"{name}: values must be contiguous")
    out = torch.empty(num_segments, dtype=torch.float64, device=values.device)
    if num_segments == 0:
        return out
    if plan is None:
        plan = make_plan(segment_ids, num_segments)
    for t in (plan.offsets, plan.perm):
        if t is not None and (t.device != values.device
                              or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: plan tensors must be contiguous int32 "
                             f"on {values.device}")
    with torch.cuda.device(values.device):
        LIBRARY.call(name, entry, values.data_ptr(),
                     None if plan.perm is None else plan.perm.data_ptr(),
                     plan.offsets.data_ptr(), num_segments, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    LAUNCHES[name] += 1
    return out


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, plan: "SegmentPlan | None" = None
                ) -> torch.Tensor:
    """Scatter-add ``values`` (NNZ,) into ``num_segments`` bins."""
    _check(values, segment_ids, num_segments, plan)
    if values.device.type == "cpu":
        return segment_sum_ref(values, segment_ids, num_segments)
    return _launch("segment_sum", "segment_sum_f64", values, segment_ids,
                   num_segments, plan)


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, plan: "SegmentPlan | None" = None
                ) -> torch.Tensor:
    """Per-segment min of ``values`` (NNZ,); empty segments hold +inf."""
    _check(values, segment_ids, num_segments, plan)
    if values.device.type == "cpu":
        return segment_min_ref(values, segment_ids, num_segments)
    return _launch("segment_min", "segment_min_f64", values, segment_ids,
                   num_segments, plan)
