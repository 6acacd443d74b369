"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU recurrent
blocks and local (sliding-window) attention, 1 attention : 2 recurrent.
A PyTorch copy of ``repro/models/rglru.py`` as the serving path runs it on
one device.

* RG-LRU: ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)``, with
  ``a_t = exp(-c softplus(Lambda) r_t)`` and input-sigmoid gates r, i, all
  in float32 (the gate weights, ``lam`` and the conv taps are float32
  whatever the config's dtype, as in the reference).  Prefill computes
  the coefficients in PyTorch and runs the recurrence through the CUDA
  ``lru_scan`` (``kernel_backend="cuda"``) or its plain version
  (``"torch"``); the reference scans with ``lax.associative_scan``.
  Decode takes one step per token (``rg_lru_step``), as the reference.
* Every temporal block (recurrent or local attention) is followed by a
  gated MLP block.  recurrentgemma-2b: 26 layers, 8 units of
  (rec, rec, attn) and 2 trailing rec blocks.
* Parameters: ``units`` is a list of per-unit dicts (keys ``rec_0``,
  ``rec_1``, ``attn_2``) and ``tail`` a list of block dicts, where the
  reference stacks the units for ``lax.scan``.
* Caches: one state dict per recurrent block (``h`` (B, w) float32, the
  last ``k-1`` pre-conv inputs ``conv`` (B, k-1, w)), one stacked ring
  cache for all attention blocks with one ``kv_pos`` (capacity
  ``min(max_len, local_window)``), and ``pos``, a Python int.  They are
  updated in place and returned.

Not ported (ROADMAP.md queue 1): the mesh, sharding constraints and the
training loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .._device import resolve_device, resolve_kernel_backend
from ..configs.base import ModelConfig
from ..kernels.rg_lru import lru_scan, lru_scan_ref
from . import layers as L

LRU_C = 8.0
BLOCK_KINDS = ("rec", "attn")


# --------------------------------------------------------------------------
# RG-LRU core
# --------------------------------------------------------------------------


def rg_lru_init(generator, width: int, device):
    # Lambda so that a ~ Uniform(0.9, 0.999)^c at r = 1
    u = torch.empty((width,), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / LRU_C))  # softplus^{-1}
    f32 = torch.float32
    return {
        "wa": L.dense_init(generator, (width, width), f32, device),
        "ba": torch.zeros((width,), dtype=f32, device=device),
        "wg": L.dense_init(generator, (width, width), f32, device),
        "bg": torch.zeros((width,), dtype=f32, device=device),
        "lam": lam,
    }


def _rg_lru_coeffs(p, x):
    """x (..., w) -> (a, b, log_a) of the recurrence h = a*h_prev + b, in
    float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["wa"] + p["ba"])
    i = torch.sigmoid(xf @ p["wg"] + p["bg"])
    log_a = -LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    return a, b, log_a


def rg_lru_scan(p, x, h0=None, *, backend: str = "cuda"):
    """x: (B,S,w) -> (y (B,S,w) float32, h_last (B,w)): the coefficients
    in PyTorch, the recurrence through ``lru_scan`` (``cuda``) or
    ``lru_scan_ref`` (``torch``)."""
    a, b, _ = _rg_lru_coeffs(p, x)
    fn = lru_scan if backend == "cuda" else lru_scan_ref
    return fn(a, b, h0)


def rg_lru_step(p, x_t, h_prev):
    """x_t (B,w), h_prev (B,w) -> (y_t, h_t)."""
    a, b, _ = _rg_lru_coeffs(p, x_t)
    h = a * h_prev + b
    return h, h


def rg_lru_sequential(p, x, h0=None):
    """Oracle for tests: one ``rg_lru_step`` per time step."""
    B, S, w = x.shape
    h = h0 if h0 is not None else torch.zeros((B, w), dtype=torch.float32,
                                               device=x.device)
    ys = []
    for t in range(S):
        h, y = rg_lru_step(p, x[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


# --------------------------------------------------------------------------
# causal depthwise conv1d
# --------------------------------------------------------------------------


def conv1d_init(generator, width: int, k: int, device):
    return {"w": L.truncated_normal((k, width), generator, device)
            .div_(math.sqrt(k)),
            "b": torch.zeros((width,), dtype=torch.float32, device=device)}


def conv1d_causal(p, x):
    """x (B,S,w); y_t = sum_i w_i x_{t-i} + b, summed in float32 in the
    reference's order, returned in x's dtype."""
    k = p["w"].shape[0]
    xf = x.float()
    y = xf * p["w"][0]
    for i in range(1, k):
        shifted = F.pad(xf, (0, 0, i, 0))[:, :xf.shape[1]]
        y = y + shifted * p["w"][i]
    return (y + p["b"]).to(x.dtype)


def conv1d_step(p, x_t, buf):
    """x_t (B,w); buf (B,k-1,w) holds previous inputs (newest last)."""
    k = p["w"].shape[0]
    xf = x_t.float()
    y = xf * p["w"][0] + p["b"]
    for i in range(1, k):
        y = y + buf[:, -i].float() * p["w"][i]
    new_buf = torch.cat([buf[:, 1:], x_t[:, None].to(buf.dtype)], dim=1)
    return y.to(x_t.dtype), new_buf


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


class RGLRUModel:
    """Griffin-style hybrid LM (family ``hybrid``); parameters and caches
    are explicit dicts.

    ``device=None`` means ``cuda`` (it raises without a card);
    ``kernel_backend`` is ``cuda`` (the kernels) or ``torch`` (the plain
    versions).
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 kernel_backend: "str | None" = None):
        if cfg.family != "hybrid" or cfg.hybrid is None:
            raise ValueError(f"RGLRUModel serves the hybrid family, not "
                             f"{cfg.family!r}")
        unknown = set(cfg.hybrid.pattern) - set(BLOCK_KINDS)
        if unknown:
            raise ValueError(f"RGLRUModel blocks are {BLOCK_KINDS}, got "
                             f"{sorted(unknown)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = resolve_kernel_backend(kernel_backend)
        self.dtype = L.torch_dtype(cfg.param_dtype)
        self.adtype = L.torch_dtype(cfg.activation_dtype)
        pat = cfg.hybrid.pattern
        self.unit = pat
        self.n_units = cfg.n_layers // len(pat)
        self.tail = pat[:cfg.n_layers - self.n_units * len(pat)]
        self.width = cfg.hybrid.lru_width or cfg.d_model
        kinds = list(pat) * self.n_units + list(self.tail)
        self.n_blocks = {kind: kinds.count(kind) for kind in BLOCK_KINDS}

    # ---------------------------------------------------------------- init

    def _rec_block_init(self, gen, dev):
        cfg, dt = self.cfg, self.dtype
        d, w = cfg.d_model, self.width
        return {
            "norm": L.rmsnorm_init(d, dt, dev),
            "rec": {
                "wx": L.dense_init(gen, (d, w), dt, dev),
                "wy": L.dense_init(gen, (d, w), dt, dev),
                "conv": conv1d_init(gen, w, cfg.hybrid.conv_width, dev),
                "lru": rg_lru_init(gen, w, dev),
                "wo": L.dense_init(gen, (w, d), dt, dev, in_axis_size=w),
            },
            "mlp_norm": L.rmsnorm_init(d, dt, dev),
            "mlp": L.swiglu_init(gen, d, cfg.d_ff, dt, dev),
        }

    def _attn_block_init(self, gen, dev):
        cfg, dt = self.cfg, self.dtype
        return {
            "norm": L.rmsnorm_init(cfg.d_model, dt, dev),
            "attn": L.mha_init(gen, cfg, dt, dev),
            "mlp_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
            "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, dev),
        }

    def _block_init(self, kind, gen, dev):
        return (self._rec_block_init if kind == "rec"
                else self._attn_block_init)(gen, dev)

    def init(self, seed: int = 0, *, device=None):
        """Random parameters drawn on the model's device (or ``device``)
        from a ``torch.Generator`` seeded with ``seed``.  The numbers are
        not the reference's (``jax.random`` differs); the tests carry the
        reference's parameters across with ``repro_torch.convert``."""
        cfg, dt = self.cfg, self.dtype
        dev = self.device if device is None else torch.device(device)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        params = {
            "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "units": [{f"{kind}_{i}": self._block_init(kind, gen, dev)
                       for i, kind in enumerate(self.unit)}
                      for _ in range(self.n_units)],
            "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
        }
        if self.tail:
            params["tail"] = [self._block_init(kind, gen, dev)
                              for kind in self.tail]
        return params

    def param_count(self) -> int:
        """Total parameters N (from shapes on the meta device)."""
        return sum(t.numel()
                   for t in L.tree_leaves(self.init(device="meta")))

    def active_param_count(self) -> int:
        return self.param_count()

    # -------------------------------------------------------------- blocks

    def _norm(self, p, x):
        return L.rmsnorm(p, x, self.cfg.norm_eps, backend=self.backend)

    def _rec_block(self, p, x, state=None, decode=False):
        """``state`` (one recurrent block's ``h`` and ``conv``) is updated
        in place; None runs the prompt from a zero state and keeps none."""
        h = self._norm(p["norm"], x)
        u = h @ p["rec"]["wx"]
        g = F.gelu((h @ p["rec"]["wy"]).float(), approximate="tanh")
        if decode:
            u1, conv_buf = conv1d_step(p["rec"]["conv"], u[:, 0],
                                       state["conv"])
            hs, _ = rg_lru_step(p["rec"]["lru"], u1, state["h"])
            y = hs[:, None]
            state["h"], state["conv"] = hs, conv_buf
        else:
            u1 = conv1d_causal(p["rec"]["conv"], u)
            y, h_last = rg_lru_scan(p["rec"]["lru"], u1,
                                    state["h"] if state is not None
                                    else None, backend=self.backend)
            if state is not None:
                # the conv's state is its last k-1 inputs (before the
                # conv), zeros in front of a prompt shorter than that
                k1 = self.cfg.hybrid.conv_width - 1
                last = u[:, -k1:]
                state["h"] = h_last
                state["conv"] = F.pad(last, (0, 0, k1 - last.shape[1], 0)) \
                    .to(self.adtype)
        y = (y.float() * g).to(x.dtype)
        x = x + y @ p["rec"]["wo"]
        h = self._norm(p["mlp_norm"], x)
        return x + L.swiglu(p["mlp"], h)

    def _attn_block(self, p, x, positions, cache=None, decode=False,
                    pos=None):
        """``cache`` is ONE attention block's view of the stacked ring
        cache (written in place); None keeps no cache."""
        cfg = self.cfg
        h = self._norm(p["norm"], x)
        if decode:
            h, _ = L.self_attention_decode(p["attn"], h, cfg, cache, pos,
                                           window=cfg.local_window,
                                           backend=self.backend)
        else:
            B, S, _ = x.shape
            q, k, v = L.mha_project_qkv(p["attn"], h, cfg, positions,
                                        backend=self.backend)
            o = L.attention(q, k, v, positions, positions, causal=True,
                            window=cfg.local_window, backend=self.backend)
            h = L.mha_out(p["attn"], o, B, S)
            if cache is not None:
                L.cache_write_prefill(cache, k, v)
        x = x + h
        h2 = self._norm(p["mlp_norm"], x)
        return x + L.swiglu(p["mlp"], h2)

    def _walk(self, params):
        """(kind, index among the blocks of that kind, block params) in
        forward order: the units' blocks, then the tail's."""
        blocks = [(kind, up[f"{kind}_{i}"]) for up in params["units"]
                  for i, kind in enumerate(self.unit)]
        blocks += list(zip(self.tail, params.get("tail", ())))
        seen = dict.fromkeys(BLOCK_KINDS, 0)
        for kind, p in blocks:
            yield kind, seen[kind], p
            seen[kind] += 1

    # ------------------------------------------------------------- forward

    def _embed_tokens(self, params, tokens):
        return params["embed"][tokens.long()].to(self.adtype)

    def _positions(self, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)

    def _unembed(self, params, x):
        return (x @ params["embed"].T).to(
            L.torch_dtype(self.cfg.logits_dtype))

    @torch.no_grad()
    def forward(self, params, tokens):
        """Training/prefill forward over the full sequence -> (logits
        (B,S,V), aux = 0)."""
        x = self._embed_tokens(params, tokens)
        positions = self._positions(x.shape[1])
        for kind, _, p in self._walk(params):
            x = self._rec_block(p, x) if kind == "rec" \
                else self._attn_block(p, x, positions)
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x), torch.zeros((), device=x.device)

    # ------------------------------------------------------------- serving

    def cache_capacity(self, max_len: int) -> int:
        return min(max_len, self.cfg.local_window)

    def init_cache(self, batch: int, max_len: int):
        """Zeroed recurrent states, the attention blocks' stacked ring
        cache, and the next position (``pos``, a Python int: the host
        drives the decode loop)."""
        w, k1 = self.width, self.cfg.hybrid.conv_width - 1
        caches = {"rec": [
            {"h": torch.zeros((batch, w), dtype=torch.float32,
                              device=self.device),
             "conv": torch.zeros((batch, k1, w), dtype=self.adtype,
                                 device=self.device)}
            for _ in range(self.n_blocks["rec"])]}
        if self.n_blocks["attn"]:
            caches["attn"] = L.make_kv_cache(
                self.cfg, batch, self.cache_capacity(max_len), self.adtype,
                self.device, n_layers=self.n_blocks["attn"])
        caches["pos"] = 0
        return caches

    @torch.no_grad()
    def prefill(self, params, tokens, max_len: int | None = None):
        """Run the prompt, build decode caches; returns (last_logits,
        caches)."""
        x = self._embed_tokens(params, tokens)
        B, S, _ = x.shape
        caches = self.init_cache(B, max_len or S)
        positions = self._positions(S)
        for kind, i, p in self._walk(params):
            if kind == "rec":
                x = self._rec_block(p, x, caches["rec"][i])
            else:
                x = self._attn_block(p, x, positions,
                                     L.layer_cache(caches["attn"], i))
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
        for kind, i, p in self._walk(params):
            if kind == "rec":
                x = self._rec_block(p, x, caches["rec"][i], decode=True)
            else:
                x = self._attn_block(p, x, None,
                                     L.layer_cache(caches["attn"], i),
                                     decode=True, pos=pos)
        caches["pos"] = pos + 1
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x)[:, 0], caches

