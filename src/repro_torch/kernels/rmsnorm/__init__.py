"""Fused RMSNorm of every decoder layer.

Port of ``repro/kernels/rmsnorm`` (Pallas) to CUDA C++ for ``sm_90a``:
``csrc/rmsnorm.cu`` (the kernel, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrapper and
its launch count) and ``ref.py`` (the plain PyTorch version).
"""

from .ops import LAUNCHES, reset_launch_counts, rmsnorm
from .ref import rmsnorm_ref

__all__ = ["LAUNCHES", "reset_launch_counts", "rmsnorm", "rmsnorm_ref"]
