"""Grouped (per-expert) matmuls of the MoE FFN.

Port of ``repro/kernels/grouped_matmul`` (Pallas) to CUDA C++ for
``sm_90a``: ``csrc/grouped_matmul.cu`` (the kernels, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrappers and
their launch counts) and ``ref.py`` (the plain PyTorch versions).
"""

from .ops import (LAUNCHES, expert_ffn_matmul, grouped_matmul,
                  megablocks_matmul, ragged_grouped_matmul,
                  reset_launch_counts, splits_for)
from .ref import (block_owners, grouped_matmul_ref, grouped_matmul_split_ref,
                  ragged_grouped_matmul_ref, ragged_grouped_matmul_masked_ref)

__all__ = ["LAUNCHES", "block_owners", "expert_ffn_matmul", "grouped_matmul",
           "grouped_matmul_ref", "grouped_matmul_split_ref",
           "megablocks_matmul", "ragged_grouped_matmul",
           "ragged_grouped_matmul_masked_ref", "ragged_grouped_matmul_ref",
           "reset_launch_counts", "splits_for"]
