"""Plain PyTorch version of the RG-LRU linear recurrence.

The CPU path of :mod:`.ops`, the ``torch`` backend of the model's scan,
and the yardstick the CUDA kernel is held against on the card; the same
function as the reference's ``repro/kernels/rg_lru/ref.py::lru_scan_ref``
(a sequential scan over time).
"""

from __future__ import annotations

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: "torch.Tensor | None" = None
                 ) -> "tuple[torch.Tensor, torch.Tensor]":
    """a, b: (B, S, W) float32; h0 (B, W) or None (zeros) -> (y (B,S,W),
    h_last (B,W)), with ``y[:, t] = a[:, t] * y[:, t-1] + b[:, t]``."""
    B, S, W = a.shape
    h = h0 if h0 is not None else torch.zeros((B, W), dtype=a.dtype,
                                               device=a.device)
    y = torch.empty_like(a)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h
