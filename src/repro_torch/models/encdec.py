"""Whisper-style encoder-decoder (the audio family): a PyTorch copy of
``repro/models/encdec.py``'s ``EncDecLM`` as the serving path runs it on
one device.

* The conv/mel frontend is a stub, as in the reference: the encoder takes
  precomputed frame embeddings (B, S_enc, d_model), and ``enc_len`` maps a
  decoder length to ``seq_len // 2`` frames (the conv stack's 2x
  downsampling).
* LayerNorm, GELU MLPs, sinusoidal positions on both sides, full (not
  grouped) attention: ``n_kv_heads == n_heads``.  The encoder's
  self-attention is non-causal; the decoder's is causal; its
  cross-attention reads every encoder frame.
* Every attention goes through ``layers.attention`` with the model's
  kernel backend: the encoder's, the decoder prompt's self- and
  cross-attention take the kernel's tensor-core route in bf16, each
  decode step's self- and cross-attention its decode route.  The
  reference's decode step computes the cross-attention with
  ``attention_ref``; here it is the same kernel call as every other.
  LayerNorm and the GELU MLP are plain PyTorch ops (the reference
  computes them outside any Pallas kernel), the projections
  ``torch.matmul``.
* Parameters: ``enc_layers`` and ``dec_layers`` are lists of per-layer
  dicts (the reference stacks them for ``lax.scan``).  Caches: ``self``,
  the decoder's stacked ring caches (``layers.make_kv_cache``), and
  ``cross_k`` / ``cross_v`` (n_layers, B, S_enc, K, Dh), the encoder's keys
  and values projected once at prefill; ``pos`` a Python int.  Decode
  updates them in place.

Not ported (ROADMAP.md queue 1): the mesh (``_constrain``,
``param_specs``, ``cache_specs``), ``param_shapes`` and ``input_specs``
(the dry run), and training (``Trainer`` refuses the audio family).
"""

from __future__ import annotations

import torch

from .._device import resolve_device, resolve_kernel_backend
from ..configs.base import ModelConfig, RunConfig
from . import layers as L


class EncDecLM:
    """Encoder-decoder LM; parameters and caches are explicit dicts.

    ``device=None`` means ``cuda`` (it raises without a card);
    ``kernel_backend`` is ``cuda`` (the attention kernel) or ``torch``
    (its plain version).
    """

    def __init__(self, cfg: ModelConfig, run: "RunConfig | None" = None, *,
                 device=None, kernel_backend: "str | None" = None):
        if cfg.family != "audio" or cfg.encdec is None:
            raise ValueError(f"EncDecLM serves the audio family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.run = run or RunConfig()
        self.device = resolve_device(device)
        self.backend = resolve_kernel_backend(kernel_backend)
        self.dtype = L.torch_dtype(cfg.param_dtype)
        self.adtype = L.torch_dtype(cfg.activation_dtype)

    # ---------------------------------------------------------------- init

    def _enc_block_init(self, gen, dev):
        cfg, dt = self.cfg, self.dtype
        return {
            "attn_norm": L.layernorm_init(cfg.d_model, dt, dev),
            "attn": L.mha_init(gen, cfg, dt, dev),
            "mlp_norm": L.layernorm_init(cfg.d_model, dt, dev),
            "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt, dev),
        }

    def _dec_block_init(self, gen, dev):
        cfg, dt = self.cfg, self.dtype
        return {
            "attn_norm": L.layernorm_init(cfg.d_model, dt, dev),
            "attn": L.mha_init(gen, cfg, dt, dev),
            "xattn_norm": L.layernorm_init(cfg.d_model, dt, dev),
            "xattn": L.mha_init(gen, cfg, dt, dev),
            "mlp_norm": L.layernorm_init(cfg.d_model, dt, dev),
            "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt, dev),
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
        return {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "enc_layers": [self._enc_block_init(gen, dev)
                           for _ in range(cfg.encdec.n_encoder_layers)],
            "dec_layers": [self._dec_block_init(gen, dev)
                           for _ in range(cfg.n_layers)],
            "enc_norm": L.layernorm_init(cfg.d_model, dt, dev),
            "final_norm": L.layernorm_init(cfg.d_model, dt, dev),
        }

    def param_count(self) -> int:
        """Total parameters N (from shapes on the meta device)."""
        return sum(t.numel()
                   for t in L.tree_leaves(self.init(device="meta")))

    def active_param_count(self) -> int:
        return self.param_count()

    def enc_len(self, seq_len: int) -> int:
        """Encoder frames for a decoder length: the conv stack's 2x."""
        return max(seq_len // 2, 8)

    # -------------------------------------------------------------- encode

    def _positions(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int32, device=self.device)

    def encode(self, params, frames):
        """frames (B, S_enc, d_model), the stub frontend's output ->
        (B, S_enc, d_model): non-causal self-attention over every frame."""
        cfg = self.cfg
        B, S, d = frames.shape
        pe = L.sinusoidal_positions(S, d, self.device).to(self.adtype)
        x = frames.to(self.adtype) + pe[None]
        positions = self._positions(S)
        for lp in params["enc_layers"]:
            h = L.layernorm(lp["attn_norm"], x)
            x = x + L.self_attention(lp["attn"], h, cfg, positions,
                                     causal=False, rope=False,
                                     backend=self.backend)
            h = L.layernorm(lp["mlp_norm"], x)
            x = x + L.gelu_mlp(lp["mlp"], h)
        return L.layernorm(params["enc_norm"], x)

    # -------------------------------------------------------------- decode

    def _cross_kv(self, p, enc_out):
        """The encoder output's keys and values, (B, S_enc, K, Dh) each."""
        B = enc_out.shape[0]
        K, Dh = self.cfg.n_kv_heads, self.cfg.resolved_head_dim
        return ((enc_out @ p["wk"]).reshape(B, -1, K, Dh),
                (enc_out @ p["wv"]).reshape(B, -1, K, Dh))

    def _cross_attention(self, p, x, k, v, positions_q, enc_positions):
        """x (B, S, d) over the encoder's k, v (B, S_enc, K, Dh): every
        frame attended (``causal=False``)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = (x @ p["wq"]).reshape(B, S, K, H // K, Dh)
        o = L.attention(q, k, v, positions_q, enc_positions, causal=False,
                        backend=self.backend)
        return L.mha_out(p, o, B, S)

    def _dec_block(self, lp, x, enc_out, positions, enc_positions):
        h = L.layernorm(lp["attn_norm"], x)
        x = x + L.self_attention(lp["attn"], h, self.cfg, positions,
                                 causal=True, rope=False,
                                 backend=self.backend)
        h = L.layernorm(lp["xattn_norm"], x)
        k, v = self._cross_kv(lp["xattn"], enc_out)
        x = x + self._cross_attention(lp["xattn"], h, k, v, positions,
                                      enc_positions)
        h = L.layernorm(lp["mlp_norm"], x)
        return x + L.gelu_mlp(lp["mlp"], h)

    def _embed_tokens(self, params, tokens, pe):
        """Token embeddings plus their positions' sinusoids ``pe`` (S, d)
        or (1, d), in the activation dtype."""
        x = params["embed"][tokens.long()].to(self.adtype)
        return x + pe.to(self.adtype)[None]

    def _unembed(self, params, x):
        return (x @ params["embed"].T).to(
            L.torch_dtype(self.cfg.logits_dtype))

    def forward(self, params, tokens, frames):
        """Teacher-forced forward -> (logits (B, S_dec, V), aux = 0).
        Autograd follows it where grad mode is on."""
        enc_out = self.encode(params, frames)
        S = tokens.shape[1]
        x = self._embed_tokens(params, tokens, L.sinusoidal_positions(
            S, self.cfg.d_model, self.device))
        positions = self._positions(S)
        enc_positions = self._positions(enc_out.shape[1])
        for lp in params["dec_layers"]:
            x = self._dec_block(lp, x, enc_out, positions, enc_positions)
        x = L.layernorm(params["final_norm"], x)
        return self._unembed(params, x), torch.zeros((), device=x.device)

    def loss(self, params, batch):
        """The reference's loss: (ce, {"ce", "aux"}); ``batch`` holds
        ``tokens`` and ``labels`` (B, S) and ``frames`` (B, S_enc, d)."""
        logits, aux = self.forward(params, batch["tokens"], batch["frames"])
        ce = L.cross_entropy_loss(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving

    def init_cache(self, batch: int, max_len: int, enc_len: int):
        """Zeroed decoder ring caches of ``max_len`` slots, zeroed cross
        caches of ``enc_len`` frames, and the next position (``pos``, a
        Python int: the host drives the decode loop)."""
        cfg = self.cfg
        nl, K, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        cross = (nl, batch, enc_len, K, Dh)
        return {"self": L.make_kv_cache(cfg, batch, max_len, self.adtype,
                                        self.device, n_layers=nl),
                "cross_k": torch.zeros(cross, dtype=self.adtype,
                                       device=self.device),
                "cross_v": torch.zeros(cross, dtype=self.adtype,
                                       device=self.device),
                "pos": 0}

    @torch.no_grad()
    def prefill(self, params, tokens, frames, max_len: int | None = None):
        """Encode the frames and run the decoder prompt; build the caches.
        Returns (last logits (B, V), caches).  Each layer's cross keys and
        values are projected once, into the cache, and read from there."""
        cfg = self.cfg
        enc_out = self.encode(params, frames)
        B, S = tokens.shape
        S_enc = enc_out.shape[1]
        caches = self.init_cache(B, max_len or S, S_enc)
        x = self._embed_tokens(params, tokens, L.sinusoidal_positions(
            S, cfg.d_model, self.device))
        positions = self._positions(S)
        enc_positions = self._positions(S_enc)
        for i, lp in enumerate(params["dec_layers"]):
            h = L.layernorm(lp["attn_norm"], x)
            q, k, v = L.mha_project_qkv(lp["attn"], h, cfg, positions,
                                        rope=False, backend=self.backend)
            o = L.attention(q, k, v, positions, positions, causal=True,
                            backend=self.backend)
            x = x + L.mha_out(lp["attn"], o, B, S)
            L.cache_write_prefill(L.layer_cache(caches["self"], i), k, v)
            ck, cv = self._cross_kv(lp["xattn"], enc_out)
            caches["cross_k"][i] = ck
            caches["cross_v"][i] = cv
            h = L.layernorm(lp["xattn_norm"], x)
            x = x + self._cross_attention(lp["xattn"], h, caches["cross_k"][i],
                                          caches["cross_v"][i], positions,
                                          enc_positions)
            h = L.layernorm(lp["mlp_norm"], x)
            x = x + L.gelu_mlp(lp["mlp"], h)
        caches["pos"] = S
        # the final norm is per position: only the last one is read
        x = L.layernorm(params["final_norm"], x[:, -1:])
        return self._unembed(params, x)[:, 0], caches

    @torch.no_grad()
    def decode_step(self, params, token, caches):
        """token (B, 1) -> (logits (B, V), caches).  The self caches are
        updated in place; the cross caches are read."""
        cfg = self.cfg
        pos = caches["pos"]
        x = self._embed_tokens(params, token, L.sinusoidal_position_at(
            pos, cfg.d_model, self.device))
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=self.device)
        enc_positions = self._positions(caches["cross_k"].shape[2])
        for i, lp in enumerate(params["dec_layers"]):
            h = L.layernorm(lp["attn_norm"], x)
            h, _ = L.self_attention_decode(
                lp["attn"], h, cfg, L.layer_cache(caches["self"], i), pos,
                rope=False, backend=self.backend)
            x = x + h
            h = L.layernorm(lp["xattn_norm"], x)
            x = x + self._cross_attention(lp["xattn"], h, caches["cross_k"][i],
                                          caches["cross_v"][i], positions,
                                          enc_positions)
            h = L.layernorm(lp["mlp_norm"], x)
            x = x + L.gelu_mlp(lp["mlp"], h)
        caches["pos"] = pos + 1
        x = L.layernorm(params["final_norm"], x)
        return self._unembed(params, x)[:, 0], caches
