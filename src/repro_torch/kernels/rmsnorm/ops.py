"""Checked wrapper of the CUDA RMSNorm, and its launch count.

``rmsnorm(x, scale, eps)`` keeps the meaning of the Pallas kernel it
replaces (``repro/kernels/rmsnorm/kernel.py``): per row of ``x`` (N, D),
``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, returned in x's dtype.

For a tensor on the CPU the wrapper returns the plain PyTorch version
(:mod:`.ref`).  For a CUDA tensor it launches the kernel or raises; there
is no fallback.  ``LAUNCHES`` counts kernel launches: one is added where
the kernel is launched, and nowhere else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary
from .ref import rmsnorm_ref

LAUNCHES = {"rmsnorm": 0}

LIBRARY = CudaLibrary(
    "rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",
    {"rmsnorm_forward": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (N, D) bf16 or float32, rows contiguous (a row stride is
    allowed); scale: (D,) of x's dtype.  Returns a contiguous (N, D)."""
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x must be (N, D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm: scale must have x's dtype {x.dtype}, got "
                        f"{scale.dtype}")
    if scale.device != x.device:
        raise ValueError("rmsnorm: x and scale lie on different devices")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    N, D = x.shape
    ld = x.stride(0) if N > 1 else D
    if (x.stride(1) != 1 and D > 1) or ld < D or not scale.is_contiguous():
        raise ValueError("rmsnorm: x's rows must be contiguous and not "
                         f"overlap (strides {x.stride()}), scale contiguous")
    out = torch.empty((N, D), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        LIBRARY.call("rmsnorm", "rmsnorm_forward", x.data_ptr(),
                     scale.data_ptr(), out.data_ptr(), N, D, ld, float(eps),
                     _DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream().cuda_stream)
    LAUNCHES["rmsnorm"] += 1
    return out
