"""Attention of every decoder layer, prefill and decode.

Port of ``repro/kernels/flash_attention`` (Pallas) to CUDA C++ for
``sm_90a``: ``csrc/flash_attention.cu`` (the kernel, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrappers and
the launch count) and ``ref.py`` (the plain PyTorch version).
"""

from .ops import (LAUNCHES, decode_splits, flash_attention,
                  flash_attention_kernel_layout, reset_launch_counts,
                  right_aligned_positions)
from .ref import (attention_decode_split_ref, attention_mask, attention_ref,
                  mask_probe, split_range)

__all__ = ["LAUNCHES", "attention_decode_split_ref", "attention_mask",
           "attention_ref", "decode_splits", "flash_attention",
           "flash_attention_kernel_layout", "mask_probe",
           "reset_launch_counts", "right_aligned_positions", "split_range"]
