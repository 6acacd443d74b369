"""Plain PyTorch versions of the grouped (per-expert) matmuls.

The CPU path of :mod:`.ops` and the yardsticks the CUDA kernels are held
against on the card:

* :func:`grouped_matmul_ref` and :func:`ragged_grouped_matmul_ref` are
  copies of the reference's oracles (``repro/kernels/grouped_matmul/
  ref.py``): fp32 products, the result in x's dtype; the ragged one is
  exact per group (every row times its own group's weights).
* :func:`ragged_grouped_matmul_masked_ref` is the ragged matmul as the
  Pallas kernel computes it (``kernel.py:_ragged_kernel``): rows are cut
  into blocks of ``min(block_m, T)``, a block is owned by the group of its
  first row (``#{ends <= first row}``, clipped to E - 1), and a row outside
  its block owner's ``[start, start + size)`` is written as 0.  It equals
  the exact oracle on every row whose block its own group owns, and on
  all rows when each group's size is a multiple of ``block_m``.
"""

from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, M, K), w (E, K, N) -> (E, M, N) in x's dtype, fp32 inside.
    One fp32 copy of ``w`` lives for the call."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def ragged_grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                              group_sizes) -> torch.Tensor:
    """x (T, K) rows sorted by group; w (E, K, N); group_sizes (E,) with
    sum == T -> (T, N), each row times its own group's weights."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    start = 0
    for e, size in enumerate(torch.as_tensor(group_sizes).tolist()):
        if size:
            out[start:start + size] = (x[start:start + size].float()
                                       @ w[e].float())
        start += size
    return out.to(x.dtype)


def block_owners(group_sizes: torch.Tensor, n_rows: int, block_m: int
                 ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Each row's block owner (the group of its block's first row, blocks
    of ``min(block_m, n_rows)`` rows) and whether the row lies inside
    that owner's range, both (n_rows,)."""
    E = group_sizes.shape[0]
    dev = group_sizes.device
    gs = group_sizes.to(torch.int64)
    ends = torch.cumsum(gs, 0)
    starts = ends - gs
    bm = max(1, min(block_m, n_rows))
    rows = torch.arange(n_rows, device=dev)
    first = rows // bm * bm
    owner = (first[:, None] >= ends[None, :]).sum(1).clamp(max=E - 1)
    inside = (rows >= starts[owner]) & (rows < ends[owner])
    return owner, inside


def ragged_grouped_matmul_masked_ref(x: torch.Tensor, w: torch.Tensor,
                                     group_sizes: torch.Tensor,
                                     block_m: int = 128) -> torch.Tensor:
    """x (T, K) rows sorted by group; w (E, K, N); group_sizes (E,) on x's
    device -> (T, N) in x's dtype: the rows of a block owned by their own
    group times its weights, every other row 0."""
    T = x.shape[0]
    out = torch.zeros((T, w.shape[2]), dtype=torch.float32, device=x.device)
    owner, inside = block_owners(group_sizes.to(x.device), T, block_m)
    for e in range(w.shape[0]):
        rows = torch.nonzero(inside & (owner == e))[:, 0]
        if rows.numel():
            out[rows] = x[rows].float() @ w[e].float()
    return out.to(x.dtype)
