"""Checked wrapper of the CUDA RG-LRU scan, and its launch count.

``lru_scan(a, b, h0=None)`` keeps the meaning of the Pallas kernel it
replaces (``repro/kernels/rg_lru/kernel.py::lru_scan``): the linear
recurrence ``y[:, t] = a[:, t] * y[:, t-1] + b[:, t]`` over (B, S, W)
float32 from ``h0`` (B, W) (zeros when None), returning ``y`` and the
final state ``h_last = y[:, -1]`` (its own contiguous (B, W) tensor).

For tensors on the CPU the wrapper returns the plain PyTorch version
(:mod:`.ref`).  For CUDA tensors it launches the kernel or raises; there
is no fallback.  ``LAUNCHES`` counts kernel launches: one is added where
the kernel is launched, and nowhere else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary
from .ref import lru_scan_ref

LAUNCHES = {"lru_scan": 0}

LIBRARY = CudaLibrary(
    "lru_scan", Path(__file__).resolve().parent / "csrc" / "lru_scan.cu",
    {"lru_scan_forward": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]})


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(a, b, h0) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"lru_scan: a and b must be one (B, S, W) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if h0 is not None and h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"lru_scan: h0 must be (B, W) = "
                         f"{(a.shape[0], a.shape[2])}, got {tuple(h0.shape)}")
    tensors = (a, b) if h0 is None else (a, b, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("lru_scan: a, b and h0 must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != a.device for t in tensors):
        raise ValueError("lru_scan: inputs lie on different devices")


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: "torch.Tensor | None" = None
             ) -> "tuple[torch.Tensor, torch.Tensor]":
    """a, b: (B, S, W) float32, h0: (B, W) float32 or None -> (y (B,S,W),
    h_last (B,W))."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return lru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"lru_scan: no kernel for device {a.device}")
    tensors = (a, b) if h0 is None else (a, b, h0)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lru_scan: a, b and h0 must be contiguous")
    B, S, W = a.shape
    y = torch.empty_like(a)
    if S == 0 or B == 0 or W == 0:
        h_last = h0.clone() if h0 is not None else \
            torch.zeros((B, W), dtype=a.dtype, device=a.device)
        return y, h_last
    h_last = torch.empty((B, W), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        LIBRARY.call("lru_scan", "lru_scan_forward", a.data_ptr(),
                     b.data_ptr(), None if h0 is None else h0.data_ptr(),
                     y.data_ptr(), h_last.data_ptr(), B, S, W,
                     torch.cuda.current_stream().cuda_stream)
    LAUNCHES["lru_scan"] += 1
    return y, h_last
