"""Plain PyTorch version of the attention the flash kernel computes.

The CPU path of :mod:`.ops` and the yardstick the CUDA kernel is held
against on the card.  It is the reference's model attention
(``repro/models/layers.py::attention_ref``), with the positions shared
across the batch and a ring cache's empty slots marked by ``kv_pos < 0``
(where the reference passes ``kv_valid = kv_pos >= 0``):

* scores ``q . k / sqrt(Dh)`` in fp32;
* masked where ``kv_pos < 0``, where ``kv_pos > q_pos`` (causal) and
  where ``q_pos - kv_pos >= window``, with ``-1e30`` as the reference
  does, then an fp32 softmax;
* the weights cast to v's dtype before the product with v, which is
  accumulated in fp32 and returned in q's dtype (``layers.py:155``).

Layout (the model's): q (B, Sq, K, G, Dh), query head ``k * G + g`` reads
kv head ``k``; k and v (B, Skv, K, Dh), any strides.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) bool, True = attend."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & ((qp - kp) < window)
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,K,G,Dh), k/v (B,Skv,K,Dh), q_pos (Sq,), kv_pos (Skv,)
    -> (B,Sq,K,G,Dh) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    mask = attention_mask(q_pos, kv_pos, causal, window)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def mask_probe(B: int, K: int, G: int, Dh: int, q_pos: torch.Tensor,
               kv_pos: torch.Tensor, *, causal: bool = True,
               window: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16):
    """Inputs whose attention has an exact answer, and that answer.

    q = 0 and k = 0, so every attended score is 0 and every attended
    weight the same; ``v[b, j, kh, d] = 1`` where ``kv_pos[j] >= 0`` and
    ``kv_pos[j] mod Dh == d``, else 0.  Each output row is then
    ``count(attended j with kv_pos[j] = d mod Dh) / count(attended j)``:
    a key dropped or leaked by the mask moves it by at least
    ``1 / count(attended j)`` of a column's share.  Returns q
    (B, Sq, K, G, Dh), k and v (B, Skv, K, Dh) in ``dtype`` on kv_pos's
    device, and the answer (Sq, Dh) in float64, the same for every b, kh
    and g (0 for a row that attends nothing).
    """
    dev = kv_pos.device
    Sq, Skv = q_pos.numel(), kv_pos.numel()
    q = torch.zeros(B, Sq, K, G, Dh, dtype=dtype, device=dev)
    k = torch.zeros(B, Skv, K, Dh, dtype=dtype, device=dev)
    hit = (kv_pos >= 0)[:, None] & (
        kv_pos.long().remainder(Dh)[:, None]
        == torch.arange(Dh, device=dev)[None, :])
    v = hit.to(dtype)[None, :, None, :].expand(B, Skv, K, Dh).contiguous()
    mask = attention_mask(q_pos, kv_pos, causal, window).double()
    want = (mask @ hit.double()) / mask.sum(dim=1, keepdim=True).clamp_min(1)
    return q, k, v, want
