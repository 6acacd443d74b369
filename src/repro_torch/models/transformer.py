"""Decoder-only transformer LM of the dense and MoE families: a PyTorch
copy of ``repro/models/transformer.py``'s ``DecoderLM`` as the serving
path runs it on one device.

Supports GQA (+qk-norm, +QKV bias), RoPE, SwiGLU FFN, sliding-window
attention, ring-buffer KV caches, and the MoE FFN (capacity dispatch,
:mod:`.moe`) with leading dense layers (``first_k_dense``).  Each layer
group (``dense_layers`` then ``layers`` for the MoE family, ``layers``
alone for the dense one) is a list of per-layer parameter dicts walked by
a Python loop (the reference stacks them for ``lax.scan``).  RMSNorm,
attention and the experts' matmuls go through the hand-written CUDA
kernels (``kernel_backend="cuda"``) or their plain PyTorch versions
(``"torch"``).

Training (:mod:`repro_torch.train`): ``forward`` runs with grad mode as
the caller has it (the serving calls, ``prefill`` and ``decode_step``,
run under ``torch.no_grad()``), ``loss`` is the reference's (cross
entropy plus ``AUX_LOSS_WEIGHT`` times the MoE load-balance loss), and
``run.remat`` recomputes each block in the backward pass: ``full`` keeps
nothing of a block (``torch.utils.checkpoint``, non-reentrant), ``dots``
keeps its matrix products without batch dimensions (the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
projections' ``aten.mm``; attention's kernel is recomputed).  On the
``cuda`` backend the gradients of RMSNorm and attention are the backward
kernels (their autograd functions).

Not ported yet (ROADMAP.md queue 1): the expert-parallel and TP-f MoE
paths (they need a mesh: one device always takes the dispatch path, as the
reference does without a mesh), the VLM prefix and sharding constraints;
a config of another family raises ``NotImplementedError`` (the hybrid
family is :class:`repro_torch.models.rglru.RGLRUModel`).
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from .._device import resolve_device, resolve_kernel_backend
from ..configs.base import ModelConfig, RunConfig
from . import layers as L
from . import moe as M
from .registry import DECODER_FAMILIES

# the layer groups of a parameter tree and of a cache, in forward order
GROUPS = ("dense_layers", "layers")
AUX_LOSS_WEIGHT = 0.01
REMAT = ("none", "full", "dots")
# what ``remat="dots"`` keeps of a block: products without batch dims
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class DecoderLM:
    """Functional decoder LM; parameters and caches are explicit dicts.

    ``device=None`` means ``cuda`` (it raises without a card);
    ``kernel_backend`` is ``cuda`` (the kernels) or ``torch`` (the plain
    versions).
    """

    def __init__(self, cfg: ModelConfig, run: "RunConfig | None" = None, *,
                 device=None, kernel_backend: "str | None" = None):
        if cfg.family not in DECODER_FAMILIES:
            raise NotImplementedError(
                f"DecoderLM serves the families {DECODER_FAMILIES}, not "
                f"{cfg.family!r} (registry.get_model picks a family's "
                "model)")
        self.run = run or RunConfig()
        if self.run.remat not in REMAT:
            raise ValueError(f"unknown remat {self.run.remat!r}; expected "
                             f"one of {REMAT}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = resolve_kernel_backend(kernel_backend)
        self.dtype = L.torch_dtype(cfg.param_dtype)
        self.adtype = L.torch_dtype(cfg.activation_dtype)

    @property
    def _n_moe_layers(self) -> int:
        if self.cfg.moe is None:
            return 0
        return self.cfg.n_layers - self.cfg.moe.first_k_dense

    @property
    def _n_dense_layers(self) -> int:
        if self.cfg.moe is None:
            return self.cfg.n_layers
        return self.cfg.moe.first_k_dense

    # ---------------------------------------------------------------- init

    def _dense_block_init(self, generator, device):
        cfg, dt = self.cfg, self.dtype
        return {
            "attn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
            "attn": L.mha_init(generator, cfg, dt, device),
            "ffn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
            "ffn": L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt,
                                 device),
        }

    def _moe_block_init(self, generator, device):
        cfg, dt = self.cfg, self.dtype
        return {
            "attn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
            "attn": L.mha_init(generator, cfg, dt, device),
            "ffn_norm": L.rmsnorm_init(cfg.d_model, dt, device),
            "moe": M.moe_init(generator, cfg, dt, device),
        }

    def init(self, seed: int = 0, *, device=None):
        """Random parameters drawn on the model's device (or ``device``)
        from a ``torch.Generator`` seeded with ``seed``.  The numbers are
        not the reference's (``jax.random`` differs); the tests carry the
        reference's parameters across with ``repro_torch.convert``."""
        cfg, dt = self.cfg, self.dtype
        dev = self.device if device is None else torch.device(device)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dt, dev),
                  "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev)}
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init(
                gen, (cfg.d_model, cfg.vocab_size), dt, dev)
        if cfg.moe is None:
            params["layers"] = [self._dense_block_init(gen, dev)
                                for _ in range(cfg.n_layers)]
            return params
        if self._n_dense_layers:
            params["dense_layers"] = [self._dense_block_init(gen, dev)
                                      for _ in range(self._n_dense_layers)]
        params["layers"] = [self._moe_block_init(gen, dev)
                            for _ in range(self._n_moe_layers)]
        return params

    def param_count(self) -> int:
        """Total parameters N (from shapes on the meta device)."""
        return sum(t.numel()
                   for t in L.tree_leaves(self.init(device="meta")))

    def active_param_count(self) -> int:
        """Parameters one token reads: the experts count top_k / E."""
        params = self.init(device="meta")
        total = sum(t.numel() for t in L.tree_leaves(params))
        if self.cfg.moe is None:
            return total
        expert = sum(t.numel() for layer in params["layers"]
                     for t in L.tree_leaves(layer["moe"]["experts"]))
        m = self.cfg.moe
        return total - expert + int(expert * m.top_k / m.n_experts)

    # ------------------------------------------------------------- blocks

    def _norm(self, p, x):
        return L.rmsnorm(p, x, self.cfg.norm_eps, backend=self.backend)

    def _ffn_apply(self, p, x):
        """Returns (y, aux_loss).  One device: the MoE layer always takes
        the capacity dispatch."""
        if "ffn" in p:
            return L.swiglu(p["ffn"], x), torch.zeros((), device=x.device)
        return M.moe_ffn_dispatch(p["moe"], x, self.cfg,
                                  backend=self.backend)

    def _block(self, p, x, positions, *, window):
        h = self._norm(p["attn_norm"], x)
        h = L.self_attention(p["attn"], h, self.cfg, positions, causal=True,
                             window=window, backend=self.backend)
        x = x + h
        h = self._norm(p["ffn_norm"], x)
        h, aux = self._ffn_apply(p, h)
        return x + h, aux

    def _block_decode(self, p, x, cache, pos, *, window):
        h = self._norm(p["attn_norm"], x)
        h, cache = L.self_attention_decode(p["attn"], h, self.cfg, cache,
                                           pos, window=window,
                                           backend=self.backend)
        x = x + h
        h = self._norm(p["ffn_norm"], x)
        h, _ = self._ffn_apply(p, h)
        return x + h, cache

    # ------------------------------------------------------------ forward

    def _embed_tokens(self, params, tokens):
        return params["embed"][tokens.long()].to(self.adtype)

    def _positions(self, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)

    def _block_remat(self, p, x, positions, *, window):
        """``_block`` under ``run.remat``; no recomputation without grad."""
        remat = self.run.remat
        if remat == "none" or not torch.is_grad_enabled():
            return self._block(p, x, positions, window=window)
        kw = {} if remat == "full" else {"context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)}
        return ckpt.checkpoint(self._block, p, x, positions, window=window,
                               use_reentrant=False, **kw)

    def forward(self, params, tokens):
        """Training/prefill forward over the full sequence -> (logits
        (B,S,V), aux); aux, the MoE load-balance loss summed over layers,
        is 0 for the dense family.  Autograd follows it where grad mode
        is on and the parameters require grad."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        positions = self._positions(x.shape[1])
        aux = torch.zeros((), device=x.device)
        for _, _, p in _walk(params):
            x, a = self._block_remat(p, x, positions,
                                     window=cfg.sliding_window)
            aux = aux + a
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x), aux

    def loss(self, params, batch):
        """The reference's training loss: (ce + AUX_LOSS_WEIGHT * aux,
        {"ce", "aux"}); ``batch`` holds ``tokens`` and ``labels`` (B, S)
        and optionally ``valid`` (B, S), a mask of the positions that
        count."""
        logits, aux = self.forward(params, batch["tokens"])
        ce = L.cross_entropy_loss(logits, batch["labels"],
                                  batch.get("valid"))
        return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}

    def _unembed(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["unembed"]
        return (x @ w).to(L.torch_dtype(self.cfg.logits_dtype))

    # ------------------------------------------------------------ serving

    def cache_capacity(self, max_len: int) -> int:
        if self.cfg.sliding_window is not None:
            return min(max_len, self.cfg.sliding_window)
        return max_len

    def init_cache(self, batch: int, max_len: int):
        """Zeroed ring caches of every layer group, and the next position
        (``pos``, a Python int: the host drives the decode loop)."""
        cap = self.cache_capacity(max_len)
        sizes = {"layers": self.cfg.n_layers if self.cfg.moe is None
                 else self._n_moe_layers}
        if self.cfg.moe is not None and self._n_dense_layers:
            sizes["dense_layers"] = self._n_dense_layers
        caches = {group: L.make_kv_cache(self.cfg, batch, cap, self.adtype,
                                         self.device, n_layers=n)
                  for group, n in sizes.items()}
        caches["pos"] = 0
        return caches

    @torch.no_grad()
    def prefill(self, params, tokens, max_len: int | None = None):
        """Run the prompt, build decode caches; returns (last_logits,
        caches)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens)
        B, S, _ = x.shape
        caches = self.init_cache(B, max_len or S)
        positions = self._positions(S)
        for group, i, p in _walk(params):
            h = self._norm(p["attn_norm"], x)
            q, k, v = L.mha_project_qkv(p["attn"], h, cfg, positions,
                                        backend=self.backend)
            o = L.attention(q, k, v, positions, positions, causal=True,
                            window=cfg.sliding_window, backend=self.backend)
            x = x + L.mha_out(p["attn"], o, B, S)
            h = self._norm(p["ffn_norm"], x)
            h, _ = self._ffn_apply(p, h)
            x = x + h
            L.cache_write_prefill(L.layer_cache(caches[group], i), k, v)
        caches["pos"] = S
        # the final norm is per position: only the last one is read
        x = self._norm(params["final_norm"], x[:, -1:])
        return self._unembed(params, x)[:, 0], caches

    @torch.no_grad()
    def decode_step(self, params, token, caches):
        """token (B,1) -> (logits (B,V), caches).  The caches are updated
        in place and returned."""
        x = self._embed_tokens(params, token)
        pos = caches["pos"]
        for group, i, p in _walk(params):
            x, _ = self._block_decode(p, x, L.layer_cache(caches[group], i),
                                      pos, window=self.cfg.sliding_window)
        caches["pos"] = pos + 1
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x)[:, 0], caches


def _walk(params):
    """(group, index in the group, layer params) in forward order."""
    for group in GROUPS:
        for i, p in enumerate(params.get(group, ())):
            yield group, i, p

