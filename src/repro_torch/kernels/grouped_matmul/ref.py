"""Plain PyTorch versions of the grouped (per-expert) matmuls.

The CPU path of :mod:`.ops` and the yardsticks the CUDA kernels are held
against on the card:

* :func:`grouped_matmul_ref` and :func:`ragged_grouped_matmul_ref` are
  copies of the reference's oracles (``repro/kernels/grouped_matmul/
  ref.py``): fp32 products, the result in x's dtype; the ragged one is
  exact per group (every row times its own group's weights).
* :func:`grouped_matmul_split_ref` is the grouped matmul with K cut
  into ``splits`` slices of whole 64-deep K tiles, as the ``mma`` route
  splits it: each slice's fp32 product, the slices added in order, one
  cast.  At ``splits=1`` it is :func:`grouped_matmul_ref`, bit for bit.
  It is the yardstick of the split's arithmetic, against the JAX
  reference on the CPU and for the forced-split kernel on the card, and
  is never called on the main path.
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

# the mma kernel's K tile (csrc/grouped_matmul.cu, ``Decode``): a split
# K's slices are whole tiles of it
K_TILE = 64


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, M, K), w (E, K, N) -> (E, M, N) in x's dtype, fp32 inside.
    One fp32 copy of ``w`` lives for the call."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def grouped_matmul_split_ref(x: torch.Tensor, w: torch.Tensor,
                             splits: int) -> torch.Tensor:
    """x (E, M, K), w (E, K, N) -> (E, M, N) in x's dtype: K cut into
    ``splits`` slices of ceil(K / K_TILE) / splits whole K tiles (the
    last one short where K is), each slice's product in fp32, the
    products added in slice order in fp32 and cast once."""
    K = x.shape[-1]
    ktiles = -(-K // K_TILE)
    if splits < 1 or ktiles % splits:
        raise ValueError(f"grouped_matmul_split_ref: {splits} splits do not "
                         f"divide the {ktiles} K tiles of K={K}")
    step = ktiles // splits * K_TILE
    acc = None
    for lo in range(0, ktiles * K_TILE, step):
        part = torch.bmm(x[..., lo:lo + step].float(),
                         w[:, lo:lo + step].float())
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


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
