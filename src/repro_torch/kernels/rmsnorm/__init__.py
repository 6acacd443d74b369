"""Fused RMSNorm of every decoder layer.

Port of ``repro/kernels/rmsnorm`` (Pallas) to CUDA C++ for ``sm_90a``:
``csrc/rmsnorm.cu`` (the kernel, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrapper and
its launch count) and ``ref.py`` (the plain PyTorch version).  Its
gradient, which the Pallas kernel lacks (the reference trains through
``jax.grad`` of its plain layer), is ``csrc/rmsnorm_backward.cu`` behind
``ops.rmsnorm_backward`` and the ``ops.RMSNorm`` autograd function, with
the plain ``ref.rmsnorm_backward_ref``.
"""

from .ops import (LAUNCHES, RMSNorm, reset_launch_counts, rmsnorm,
                  rmsnorm_backward, rmsnorm_differentiable)
from .ref import rmsnorm_backward_ref, rmsnorm_ref

__all__ = ["LAUNCHES", "RMSNorm", "reset_launch_counts", "rmsnorm",
           "rmsnorm_backward", "rmsnorm_backward_ref", "rmsnorm_differentiable",
           "rmsnorm_ref"]
