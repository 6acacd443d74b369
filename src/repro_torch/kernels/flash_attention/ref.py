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

``attention_decode_split_ref`` is the plain twin of the split-KV decode
kernel's two passes (each split's running max, denominator and output,
then their merge in split order), which the CPU tests hold against
``attention_ref``; nothing on the serve path calls it.

``attention_lse_ref`` is each row's log-sum-exp, the plain twin of the LSE
the forward kernels save for the backward; ``attention_backward_ref`` the
plain backward, which takes that LSE where given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) bool, True = attend (every row written out, also where
    neither ``causal`` nor ``window`` ties a key to the query)."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    m = (kp >= 0).expand(qp.shape[0], -1)
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


def split_range(skv: int, splits: int, s: int) -> "tuple[int, int]":
    """Slots [start, end) of split ``s`` of ``splits`` over Skv slots:
    ceil(Skv / splits) each, the last ones shorter or empty."""
    chunk = -(-skv // splits)
    start = min(skv, s * chunk)
    return start, min(skv, start + chunk)


def attention_decode_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_pos: torch.Tensor,
                               kv_pos: torch.Tensor, splits: int, *,
                               causal: bool = True,
                               window: Optional[int] = None) -> torch.Tensor:
    """Decode (Sq = 1) as the split-KV kernel computes it, in fp32.

    Per split of :func:`split_range`: over the keys the query attends
    (only those are read, so an empty slot's bits never enter), each row's
    max score m, denominator l = sum exp(s - m) and output o = sum
    exp(s - m) v; a split that attends nothing has m = -inf, l = 0, o = 0.
    Then in split order: M = max m, out = sum e^(m - M) o / sum e^(m - M) l,
    0 for a row that attends no key.  Returns (B, 1, K, G, Dh) in q's
    dtype.
    """
    B, Sq, K, G, Dh = q.shape
    if Sq != 1:
        raise ValueError(f"decode takes one query position, got Sq = {Sq}")
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    attend = attention_mask(q_pos, kv_pos, causal, window)[0]
    qf = q[:, 0].float()
    dev = q.device
    m = torch.full((splits, B, K, G), -math.inf, device=dev)
    l = torch.zeros(splits, B, K, G, device=dev)
    o = torch.zeros(splits, B, K, G, Dh, device=dev)
    for s in range(splits):
        start, end = split_range(skv, splits, s)
        keys = start + torch.nonzero(attend[start:end]).flatten().to(dev)
        if keys.numel() == 0:
            continue
        sc = torch.einsum("bkgd,bnkd->bkgn", qf, k[:, keys].float()) * scale
        m[s] = sc.amax(dim=-1)
        p = torch.exp(sc - m[s][..., None])
        l[s] = p.sum(dim=-1)
        o[s] = torch.einsum("bkgn,bnkd->bkgd", p, v[:, keys].float())
    top = m.amax(dim=0)
    num = torch.zeros(B, K, G, Dh, device=dev)
    den = torch.zeros(B, K, G, device=dev)
    for s in range(splits):
        w = torch.where(m[s] == -math.inf, 0.0, torch.exp(m[s] - top))
        num += w[..., None] * o[s]
        den += w * l[s]
    some = den > 0
    out = torch.where(some[..., None],
                      num / torch.where(some, den, 1.0)[..., None], 0.0)
    return out[:, None].to(q.dtype)


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


def _masked_scores(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
                   kv_pos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> "tuple[torch.Tensor, torch.Tensor]":
    """The scaled fp32 scores (B, K, G, Sq, Skv), -inf where not attended,
    and the (Sq, Skv) mask."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = attention_mask(q_pos, kv_pos, causal, window)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    return s.masked_fill(~mask, -math.inf), mask


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
                      kv_pos: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """Each row's natural-log LSE, the log-sum-exp of its scaled attended
    scores in fp32, (B, K, Sq, G) float32; ``NEG_INF`` for a row that
    attends no key (so exp(s - LSE), masked, is 0).  The rows' layout is
    the kernels' (B, K, Sq * G)."""
    s, _ = _masked_scores(q, k, q_pos, kv_pos, causal, window)
    lse = torch.logsumexp(s, dim=-1).clamp_min(NEG_INF)   # (B, K, G, Sq)
    return lse.permute(0, 1, 3, 2).contiguous()


def attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           do: torch.Tensor, q_pos: torch.Tensor,
                           kv_pos: torch.Tensor, *, causal: bool = True,
                           window: Optional[int] = None,
                           lse: Optional[torch.Tensor] = None
                           ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The gradient of :func:`attention_ref` as FlashAttention-2 computes
    it, in fp32: ``s = q . k / sqrt(Dh)`` over the attended keys,
    ``P = exp(s - LSE)`` (0 where masked), ``D_i = sum_d dO_i . O_i``,
    ``dS = P * (dO V^T - D)``; ``dQ = dS K / sqrt(Dh)``,
    ``dK = dS^T Q / sqrt(Dh)``, ``dV = P^T dO``.  ``o`` is the forward's
    output, ``lse`` its saved LSE (:func:`attention_lse_ref`'s layout) or
    None (computed here, the same bits as that function's).  Returns (dq
    (B,Sq,K,G,Dh), dk and dv (B,Skv,K,Dh)) in the inputs' dtypes.  A row
    that attends no key gets no gradient.  The CPU path of the backward
    wrapper and the yardstick its kernel is held against on the card."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.float()
    s, mask = _masked_scores(q, k, q_pos, kv_pos, causal, window)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1).clamp_min(NEG_INF)
    else:
        lse = lse.permute(0, 1, 3, 2)                     # (B,K,G,Sq)
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    d = (dof * o.float()).sum(dim=-1)                    # (B,Sq,K,G)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
