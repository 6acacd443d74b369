"""Layers of the decoder LMs, the hybrid and the encoder-decoder: a
PyTorch copy of the parts of ``repro/models/layers.py`` that their
serving paths run.

Conventions
-----------
* Params are nested dicts of tensors, one dict per layer (the reference
  stacks the layers on a leading ``(L, ...)`` axis for ``lax.scan``; here
  a Python loop walks a list of them).
* Activations: ``x`` is ``(B, S, d_model)``.
* Attention is GQA throughout: q ``(B, S, K, G, Dh)`` (``n_kv_heads`` K
  times G query groups), k and v ``(B, S, K, Dh)``; causal masks, sliding
  windows, ring KV caches, qk-norm (Qwen3) and QKV bias (Qwen1.5).
* Positions are ``(S,)`` int32, shared across the batch (the reference
  broadcasts one ``arange`` to ``(B, S)``); a cache's ``kv_pos`` is
  ``(capacity,)`` with ``-1`` for an empty slot, which replaces the
  reference's separate ``kv_valid``.
* LayerNorm, the GELU MLP and the sinusoidal positions (the
  encoder-decoder's) are plain PyTorch ops, as the reference computes
  them outside any Pallas kernel.
* ``backend`` selects the RMSNorm and attention implementation: ``cuda``
  (the hand-written kernels of :mod:`repro_torch.kernels`, whose wrappers
  take the plain version only for CPU tensors) or ``torch`` (the plain
  PyTorch versions on any device).  The reference's chunked and plain
  attention are one function; both go to the one kernel here.
* Caches are updated in place (the reference returns new arrays), which
  keeps one copy of the 48-layer cache on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention import (attention_ref,
                                      flash_attention_differentiable)
from ..kernels.rmsnorm import rmsnorm_differentiable, rmsnorm_ref


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_leaves(tree):
    """The tensors of a parameter tree (nested dicts and lists)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` of each leaf (and the same leaf of each of ``rest``, trees of
    the same structure), as a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def truncated_normal(shape, generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], in float32, drawn on
    ``device`` by inverting the CDF of a uniform draw (no host round
    trip, so a full-size model fills on the card).  On the meta device
    (shapes only, as ``param_count`` builds) no value is drawn."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.is_meta:
        return t
    t.uniform_(-bound, bound, generator=generator)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def dense_init(generator, shape, dtype, device,
               in_axis_size: int | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(fan_in))."""
    fan_in = in_axis_size or shape[0]
    return (truncated_normal(shape, generator, device)
            .mul_(1.0 / math.sqrt(fan_in)).to(dtype))


def embed_init(generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    """Truncated normal with std 1, as the reference's ``embed_init``."""
    return truncated_normal((vocab, d), generator, device).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6, *,
            backend: str = "cuda") -> torch.Tensor:
    """RMSNorm over the last axis of x (any leading shape).  With grad
    mode on and an input that requires grad, the ``cuda`` backend goes
    through the kernels' autograd function (forward and backward
    kernels); the ``torch`` backend is plain PyTorch, which autograd
    follows."""
    fn = rmsnorm_differentiable if backend == "cuda" else rmsnorm_ref
    d = x.shape[-1]
    return fn(x.reshape(-1, d), p["scale"], eps).reshape(x.shape)


def layernorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (the biased variance, as
    ``jnp.var``), scale and bias in float32, cast back to x's dtype."""
    d = x.shape[-1]
    out = F.layer_norm(x.float(), (d,), p["scale"].float(),
                       p["bias"].float(), eps)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (interleaved pairs, as the reference)
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, ..., Dh); positions: (S,) int32.  Rotates the pairs
    (x[..., 0::2], x[..., 1::2])."""
    dh = x.shape[-1]
    angles = positions.float()[:, None] * rope_freqs(dh, theta, x.device)
    angles = angles.reshape(1, x.shape[1], *([1] * (x.dim() - 3)), dh // 2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# attention core
# --------------------------------------------------------------------------


def attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
              window: Optional[int] = None,
              backend: str = "cuda") -> torch.Tensor:
    """q (B,Sq,K,G,Dh), k/v (B,Skv,K,Dh), q_pos (Sq,), kv_pos (Skv,)
    -> (B,Sq,K,G,Dh).  The ``cuda`` backend is differentiable as
    :func:`rmsnorm`'s is."""
    fn = flash_attention_differentiable if backend == "cuda" \
        else attention_ref
    return fn(q, k, v, q_pos, kv_pos, causal=causal, window=window)


# --------------------------------------------------------------------------
# multi-head attention layer (projections + rope + cache)
# --------------------------------------------------------------------------


def mha_init(generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, (d, H * Dh), dtype, device),
        "wk": dense_init(generator, (d, K * Dh), dtype, device),
        "wv": dense_init(generator, (d, K * Dh), dtype, device),
        "wo": dense_init(generator, (H * Dh, d), dtype, device,
                         in_axis_size=H * Dh),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * Dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((K * Dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((K * Dh,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(Dh, dtype, device)
        p["k_norm"] = rmsnorm_init(Dh, dtype, device)
    return p


def mha_project_qkv(p, x, cfg: ModelConfig, positions, rope: bool = True, *,
                    backend: str = "cuda"):
    """Project to q (B,S,K,G,Dh) and k,v (B,S,K,Dh), with rope + qk-norm."""
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = H // K
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, K, G, Dh)
    k = k.reshape(B, S, K, Dh)
    v = v.reshape(B, S, K, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps, backend=backend)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps, backend=backend)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def mha_out(p, attn_out, B, S):
    return attn_out.reshape(B, S, -1) @ p["wo"]


def self_attention(p, x, cfg: ModelConfig, positions, *, causal=True,
                   window=None, rope=True, backend: str = "cuda"):
    B, S, _ = x.shape
    q, k, v = mha_project_qkv(p, x, cfg, positions, rope, backend=backend)
    o = attention(q, k, v, positions, positions, causal=causal,
                  window=window, backend=backend)
    return mha_out(p, o, B, S)


# -- KV cache: a ring buffer of ``capacity`` slots.  A full cache is simply
#    capacity == max_len; a sliding-window cache sets capacity == window so
#    decode state stays O(window).  ``kv_pos[slot]`` is the absolute
#    position stored there (-1 = empty); one ``kv_pos`` serves every layer.


def make_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device, n_layers: int | None = None):
    """Cache tensors; with n_layers, k and v get a leading (L, ...) axis
    (``layer_cache`` cuts one layer's view out of it)."""
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    lead = (n_layers,) if n_layers else ()
    return {
        "k": torch.zeros((*lead, batch, capacity, K, Dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((*lead, batch, capacity, K, Dh), dtype=dtype,
                         device=device),
        "kv_pos": torch.full((capacity,), -1, dtype=torch.int32,
                             device=device),
    }


def layer_cache(cache, layer: int):
    """Layer ``layer``'s view of a stacked cache (writes go through)."""
    return {"k": cache["k"][layer], "v": cache["v"][layer],
            "kv_pos": cache["kv_pos"]}


def cache_write_prefill(cache, k_new, v_new):
    """Write S prefill positions 0..S-1 into one layer's cache (ring),
    in place."""
    S = k_new.shape[1]
    cap = cache["k"].shape[1]
    dev = k_new.device
    if S >= cap:
        positions = torch.arange(S - cap, S, dtype=torch.int32, device=dev)
        slots = (positions % cap).long()
        cache["k"][:, slots] = k_new[:, -cap:]
        cache["v"][:, slots] = v_new[:, -cap:]
        cache["kv_pos"][slots] = positions
    else:
        cache["k"][:, :S] = k_new
        cache["v"][:, :S] = v_new
        cache["kv_pos"][:S] = torch.arange(S, dtype=torch.int32, device=dev)
    return cache


def cache_write_decode(cache, k_new, v_new, pos: int):
    """Write one token at absolute position ``pos``, in place."""
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["kv_pos"][slot] = pos
    return cache


def self_attention_decode(p, x, cfg: ModelConfig, cache: dict, pos: int, *,
                          window=None, rope=True, backend: str = "cuda"):
    """One-token decode: x (B,1,d); ``cache`` is ONE layer's ring cache;
    ``pos`` is the absolute position.  Returns (out, cache)."""
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = mha_project_qkv(p, x, cfg, positions, rope,
                                      backend=backend)
    cache = cache_write_decode(cache, k_new, v_new, pos)
    o = attention(q, cache["k"], cache["v"], positions, cache["kv_pos"],
                  causal=True, window=window, backend=backend)
    return mha_out(p, o, B, 1), cache


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------


def swiglu_init(generator, d: int, d_ff: int, dtype, device):
    return {
        "w_gate": dense_init(generator, (d, d_ff), dtype, device),
        "w_up": dense_init(generator, (d, d_ff), dtype, device),
        "w_down": dense_init(generator, (d_ff, d), dtype, device,
                             in_axis_size=d_ff),
    }


def swiglu(p, x):
    g = F.silu((x @ p["w_gate"]).float()).to(x.dtype)
    return (g * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp_init(generator, d: int, d_ff: int, dtype, device):
    return {
        "w1": dense_init(generator, (d, d_ff), dtype, device),
        "b1": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w2": dense_init(generator, (d_ff, d), dtype, device,
                         in_axis_size=d_ff),
        "b2": torch.zeros((d,), dtype=dtype, device=device),
    }


def gelu_mlp(p, x):
    """``jax.nn.gelu``'s default, the tanh approximation, in float32."""
    h = F.gelu((x @ p["w1"] + p["b1"]).float(), approximate="tanh")
    return h.to(x.dtype) @ p["w2"] + p["b2"]


# --------------------------------------------------------------------------
# sinusoidal positions (the encoder-decoder's)
# --------------------------------------------------------------------------


def _sinusoids(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(n,) float32 positions -> (n, d): sin at the even columns, cos at
    the odd ones, of ``pos / 10000 ** (dim / d)``, in float32."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    angle = pos[:, None] / torch.pow(10_000.0, dim / d)[None, :]
    pe = torch.zeros((pos.numel(), d), dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def sinusoidal_positions(max_len: int, d: int, device) -> torch.Tensor:
    """Positions 0..max_len-1 -> (max_len, d) float32."""
    return _sinusoids(torch.arange(max_len, dtype=torch.float32,
                                   device=device), d)


def sinusoidal_position_at(pos: int, d: int, device) -> torch.Tensor:
    """The embedding of one position -> (1, d) float32."""
    return _sinusoids(torch.full((1,), pos, dtype=torch.float32,
                                 device=device), d)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------


def cross_entropy_loss(logits, labels, valid=None):
    """logits (B,S,V) [any dtype, upcast to float32], labels (B,S)
    integers -> the mean of logsumexp minus the gold logit, over the
    positions where ``valid`` (B,S) is set when it is given."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if valid is None:
        return torch.mean(nll)
    valid = valid.to(torch.float32)
    return torch.sum(nll * valid) / torch.clamp_min(torch.sum(valid), 1.0)
