"""COO segment reductions of the water-filling solver and the event loop.

Port of ``repro/kernels/segment_fairshare`` (Pallas) to CUDA C++ for
``sm_90a``: ``csrc/segment_reduce.cu`` (the kernels, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrappers,
their plans and launch counts) and ``ref.py`` (the plain PyTorch
versions, and the sum kernel's ordered twin).
"""

from .ops import (LANES, LAUNCHES, SegmentPlan, lanes_for, make_plan,
                  reset_launch_counts, segment_min, segment_sum)
from .ref import segment_min_ref, segment_sum_ordered_ref, segment_sum_ref

__all__ = ["LANES", "LAUNCHES", "SegmentPlan", "lanes_for", "make_plan",
           "reset_launch_counts", "segment_min", "segment_sum",
           "segment_min_ref", "segment_sum_ordered_ref", "segment_sum_ref"]
