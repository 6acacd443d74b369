"""Attention of every decoder layer, prefill and decode.

Port of ``repro/kernels/flash_attention`` (Pallas) to CUDA C++ for
``sm_90a``: ``csrc/flash_attention.cu`` (the kernel, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrappers and
the launch count) and ``ref.py`` (the plain PyTorch version).  Its
gradient, which the Pallas kernel lacks (the reference trains through
``jax.grad`` of its plain attention), is ``csrc/flash_attention_backward.cu``
behind ``ops.flash_attention_backward`` and the ``ops.FlashAttention``
autograd function, with the plain ``ref.attention_backward_ref``; the
forward saves each row's LSE for it (``ops.flash_attention_with_lse``, the
plain ``ref.attention_lse_ref``).  ``csrc/mma_sync.cuh`` holds the
tensor-core helpers both sources include.
"""

from .ops import (LAUNCHES, FlashAttention, decode_splits,
                  flash_attention, flash_attention_backward,
                  flash_attention_differentiable,
                  flash_attention_kernel_layout, flash_attention_with_lse,
                  reset_launch_counts, right_aligned_positions)
from .ref import (attention_backward_ref, attention_decode_split_ref,
                  attention_lse_ref, attention_mask, attention_ref,
                  mask_probe, split_range)

__all__ = ["FlashAttention", "LAUNCHES",
           "attention_backward_ref", "attention_decode_split_ref",
           "attention_lse_ref", "attention_mask", "attention_ref",
           "decode_splits", "flash_attention", "flash_attention_backward",
           "flash_attention_differentiable", "flash_attention_kernel_layout",
           "flash_attention_with_lse", "mask_probe", "reset_launch_counts",
           "right_aligned_positions", "split_range"]
