"""Mixture-of-Experts FFN: a PyTorch copy of the single-device paths of
``repro/models/moe.py``.

* ``moe_ffn_ref``      — O(E) Python loop, no capacity drops; the oracle
                         of the tests (small E only).
* ``moe_ffn_dispatch`` — GShard-style capacity dispatch into (E, C, d)
                         buffers, the expert SwiGLU's three products on the
                         grouped-matmul kernel (``kernel_backend="cuda"``)
                         or its plain version (``"torch"``), then the
                         weighted combine.  The serving path of every MoE
                         layer on one card.

Routing: softmax over experts in float32 (the router stays float32 whatever
the parameters' dtype), top-k, weights renormalised over the chosen k
(Mixtral-style), and a Switch-style load-balance auxiliary loss.  Records
past an expert's capacity are dropped in token-major order, as the
reference drops them.

Not ported yet (ROADMAP.md queue 1): ``moe_ffn_tp_f`` and ``moe_ffn_ep``,
which run inside ``shard_map`` with ``all_to_all``/``psum``; they wait for
``core/collectives.py`` on ``torch.distributed``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.grouped_matmul import expert_ffn_matmul, grouped_matmul_ref
from . import layers as L


def moe_init(generator, cfg: ModelConfig, dtype, device):
    """Router (d, E) in float32; experts' w_gate, w_up (E, d, f) and
    w_down (E, f, d) in ``dtype``; a shared SwiGLU when the config has
    shared experts."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_expert
    p = {
        "router": L.dense_init(generator, (d, E), torch.float32, device),
        "experts": {
            "w_gate": L.dense_init(generator, (E, d, f), dtype, device,
                                   in_axis_size=d),
            "w_up": L.dense_init(generator, (E, d, f), dtype, device,
                                 in_axis_size=d),
            "w_down": L.dense_init(generator, (E, f, d), dtype, device,
                                   in_axis_size=f),
        },
    }
    if m.n_shared_experts:
        p["shared"] = L.swiglu_init(generator, d, f * m.n_shared_experts,
                                    dtype, device)
    return p


def _route(router_w, x_flat, cfg: ModelConfig):
    """x_flat (T, d) -> (top_w (T,k) f32, top_i (T,k) int64, aux f32)."""
    m = cfg.moe
    logits = x_flat.float() @ router_w                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    E = m.n_experts
    f = torch.bincount(top_i.reshape(-1), minlength=E).float()
    f = f / max(top_i.numel(), 1)
    aux = E * torch.sum(f * probs.mean(0))
    return top_w, top_i, aux


def _expert_ffn(experts, h, *, backend: str = "cuda"):
    """h (E, C, d) -> (E, C, d) via per-expert SwiGLU: three grouped
    matmuls."""
    mm = expert_ffn_matmul if backend == "cuda" else grouped_matmul_ref
    g = mm(h, experts["w_gate"])
    u = mm(h, experts["w_up"])
    a = F.silu(g.float()).to(h.dtype) * u
    return mm(a, experts["w_down"])


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(1, math.ceil(n_tokens * m.top_k / m.n_experts
                            * m.capacity_factor))


# --------------------------------------------------------------------------
# reference (no drops, Python loop over experts)
# --------------------------------------------------------------------------


def moe_ffn_ref(p, x, cfg: ModelConfig):
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    top_w, top_i, aux = _route(p["router"], xf, cfg)
    y = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.moe.n_experts):
        w_e = torch.sum(top_w * (top_i == e), dim=-1)           # (T,)
        ex = {k: v[e] for k, v in p["experts"].items()}
        y = y + w_e[:, None] * L.swiglu(ex, xf).float()
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + L.swiglu(p["shared"], xf)
    return y.reshape(B, S, d), aux


# --------------------------------------------------------------------------
# capacity dispatch (one device)
# --------------------------------------------------------------------------


def _dispatch(xf, top_w, top_i, E: int, C: int):
    """Pack routed tokens into (E, C, d) buffers.

    Returns (buf, eid, pos, keep, wflat): eid/pos/keep/wflat are (T*k,)
    routing records for the combine step.  A record's position is its rank
    among the earlier records (token-major) routed to the same expert; the
    records with rank >= C are dropped.  Only kept records are written
    (the reference also adds the dropped ones, as zeros, at (0, 0)); the
    dropped go to one scratch row past the buffer, with no host sync.
    """
    T, d = xf.shape
    k = top_i.shape[1]
    eid = top_i.reshape(-1)                                     # (T*k,)
    wflat = top_w.reshape(-1)
    onehot = F.one_hot(eid, E)                                  # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos, 1, eid[:, None])[:, 0]              # (T*k,)
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, E * C)
    flat = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    flat[slot] = xf.repeat_interleave(k, dim=0)
    return flat[:E * C].view(E, C, d), eid, pos, keep, wflat


def _combine(h, eid, pos, keep, wflat, T: int, k: int):
    """Gather expert outputs back to tokens and weight-sum over k slots,
    in h's dtype."""
    safe_e = torch.where(keep, eid, 0)
    safe_p = torch.where(keep, pos, 0)
    y_rep = h[safe_e, safe_p]                                   # (T*k, d)
    y_rep = torch.where(keep[:, None], y_rep, 0)
    y_rep = y_rep * wflat[:, None].to(y_rep.dtype)
    return y_rep.reshape(T, k, -1).sum(dim=1)


def moe_ffn_dispatch(p, x, cfg: ModelConfig,
                     capacity: Optional[int] = None, *,
                     backend: str = "cuda"):
    """x (B, S, d) -> (y (B, S, d), aux)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    m = cfg.moe
    C = capacity or _capacity(T, cfg)
    top_w, top_i, aux = _route(p["router"], xf, cfg)
    buf, eid, pos, keep, wflat = _dispatch(xf, top_w, top_i, m.n_experts, C)
    h = _expert_ffn(p["experts"], buf, backend=backend)
    y = _combine(h, eid, pos, keep, wflat, T, m.top_k).to(x.dtype)
    if "shared" in p:
        y = y + L.swiglu(p["shared"], xf)
    return y.reshape(B, S, d), aux
