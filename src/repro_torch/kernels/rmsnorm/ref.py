"""Plain PyTorch version of the fused RMSNorm.

The CPU path of :mod:`.ops` and the yardstick the CUDA kernel is held
against on the card; the same function as the reference's
``repro/kernels/rmsnorm/ref.py::rmsnorm_ref`` and
``repro/models/layers.py::rmsnorm``.  ``rmsnorm_backward_ref`` is the
same for its gradient (the reference trains through ``jax.grad`` of
``layers.rmsnorm``), the plain version of the backward kernel.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: (N, D); scale: (D,) -> (N, D) in x's dtype, fp32 inside."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_backward_ref(x: torch.Tensor, scale: torch.Tensor,
                         dy: torch.Tensor, eps: float = 1e-6
                         ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The gradient of :func:`rmsnorm_ref`, in fp32 throughout: with
    ``r = rsqrt(mean(x^2) + eps)``, ``xh = x * r`` and ``g = dy * scale``,
    ``dx = r * (g - xh * mean(g * xh))`` and ``dscale = sum_rows dy * xh``.
    x, dy: (N, D); scale: (D,) -> (dx in x's dtype, dscale in scale's).
    The CPU path of the backward wrapper and the yardstick its kernel is
    held against on the card."""
    xf, sf, dyf = x.float(), scale.float(), dy.float()
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                    + eps)
    xh = xf * r
    g = dyf * sf
    dx = r * (g - xh * torch.mean(g * xh, dim=-1, keepdim=True))
    return dx.to(x.dtype), (dyf * xh).sum(dim=0).to(scale.dtype)
