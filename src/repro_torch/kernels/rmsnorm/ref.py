"""Plain PyTorch version of the fused RMSNorm.

The CPU path of :mod:`.ops` and the yardstick the CUDA kernel is held
against on the card; the same function as the reference's
``repro/kernels/rmsnorm/ref.py::rmsnorm_ref`` and
``repro/models/layers.py::rmsnorm``.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: (N, D); scale: (D,) -> (N, D) in x's dtype, fp32 inside."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
