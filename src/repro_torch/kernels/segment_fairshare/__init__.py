"""COO segment reductions of the water-filling solver and the event loop.

Port of ``repro/kernels/segment_fairshare`` (Pallas) to CUDA C++ for
``sm_90a``: ``csrc/segment_reduce.cu`` (the kernels, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrappers and
their launch counts) and ``ref.py`` (the plain PyTorch versions).
"""

from .ops import (LAUNCHES, SegmentPlan, make_plan, reset_launch_counts,
                  segment_min, segment_sum)
from .ref import segment_min_ref, segment_sum_ref

__all__ = ["LAUNCHES", "SegmentPlan", "make_plan", "reset_launch_counts",
           "segment_min", "segment_sum", "segment_min_ref",
           "segment_sum_ref"]
