"""xLSTM LM (Beck et al., arXiv:2405.04517): alternating mLSTM / sLSTM
blocks.  A PyTorch copy of ``repro/models/xlstm.py`` as the serving path
runs it on one device.

* mLSTM: matrix-memory LSTM with exponential gating.  Prefill runs the
  chunkwise-parallel form (intra-chunk quadratic, inter-chunk recurrent
  state), a Python loop over the chunks where the reference scans them;
  decode takes the O(1)-state recurrent step.  ``mlstm_sequential``, one
  recurrent step a token, is the oracle of both.
* sLSTM: scalar-memory LSTM with exponential gating and a per-head
  block-diagonal recurrence, a Python loop over time.  The input
  preactivations ``x @ wx + b`` are one product for the whole sequence,
  outside the loop; the loop reads nothing back to the host, so it is
  bound by its launches alone.
* Every state and gate is float32, whatever the config's dtype: the
  stabilisers ``m`` start at -1e30, the gate weights ``w_gates`` /
  ``b_gates`` and the whole sLSTM are float32 (the reference's init
  dtypes).  The cores are plain PyTorch ops (the reference computes them
  outside any Pallas kernel); every RMSNorm goes through
  ``layers.rmsnorm`` with the model's kernel backend.
* Parameters: ``units`` is a list of per-unit dicts (keys ``mlstm_0``,
  ``slstm_1``) and ``tail`` a list of block dicts, where the reference
  stacks the units for ``lax.scan``.  Caches: the same layout of state
  dicts (``C``, ``n``, ``m`` for an mLSTM block; ``c``, ``n``, ``m``,
  ``h`` for an sLSTM one), independent of the context length, and
  ``pos``, a Python int.  Each block's entry is replaced by its new
  state; the dict is returned.

Not ported (ROADMAP.md queue 1): the mesh, sharding constraints and
training (``Trainer`` refuses the ssm family).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .._device import resolve_device, resolve_kernel_backend
from ..configs.base import ModelConfig
from . import layers as L

BLOCK_KINDS = ("mlstm", "slstm")
# the stabilisers' start, and the input gate of a padded step
NEG_BIG = -1e30


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# mLSTM core
# --------------------------------------------------------------------------


def mlstm_init(generator, d_in: int, H: int, dtype, device):
    """Projections at width d_in with H heads (Dh = d_in // H)."""
    f32 = torch.float32
    return {
        "wq": L.dense_init(generator, (d_in, d_in), dtype, device),
        "wk": L.dense_init(generator, (d_in, d_in), dtype, device),
        "wv": L.dense_init(generator, (d_in, d_in), dtype, device),
        # scalar i/f gate preactivations per head
        "w_gates": L.dense_init(generator, (d_in, 2 * H), f32, device),
        "b_gates": _zeros((2 * H,), device),
        "out_norm": {"scale": torch.ones((d_in,), dtype=dtype,
                                         device=device)},
    }


def _mlstm_qkv(p, x, H):
    """x (B,S,d) -> q, k, v (B,S,H,Dh) in x's dtype (q, k scaled by
    1/sqrt(Dh)), i_pre and log_f (B,S,H) float32."""
    B, S, d = x.shape
    Dh = d // H
    q = (x @ p["wq"]).reshape(B, S, H, Dh) / math.sqrt(Dh)
    k = (x @ p["wk"]).reshape(B, S, H, Dh) / math.sqrt(Dh)
    v = (x @ p["wv"]).reshape(B, S, H, Dh)
    gates = x.float() @ p["w_gates"] + p["b_gates"]              # (B,S,2H)
    i_pre, f_pre = gates[..., :H], gates[..., H:]
    return q, k, v, i_pre, F.logsigmoid(f_pre)                   # log_f <= 0


def mlstm_state_init(batch: int, H: int, Dh: int, device):
    return {"C": _zeros((batch, H, Dh, Dh), device),
            "n": _zeros((batch, H, Dh), device),
            "m": torch.full((batch, H), NEG_BIG, dtype=torch.float32,
                            device=device)}


def mlstm_recurrent_step(state, q, k, v, i_pre, log_f):
    """One timestep.  q, k, v: (B,H,Dh) float32; i_pre, log_f: (B,H)."""
    m_new = torch.maximum(log_f + state["m"], i_pre)
    f_eff = torch.exp(log_f + state["m"] - m_new)[..., None]
    i_eff = torch.exp(i_pre - m_new)[..., None]
    C = state["C"] * f_eff[..., None] + \
        i_eff[..., None] * v[..., None, :] * k[..., :, None]
    n = state["n"] * f_eff + i_eff * k
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))[..., None]
    h = torch.einsum("bhde,bhd->bhe", C, q) / denom
    return {"C": C, "n": n, "m": m_new}, h


def mlstm_sequential(p, x, H, state=None):
    """Oracle: the recurrent step over time.  x: (B,S,d_in)."""
    B, S, d = x.shape
    q, k, v, i_pre, log_f = _mlstm_qkv(p, x, H)
    if state is None:
        state = mlstm_state_init(B, H, d // H, x.device)
    q, k, v = q.float(), k.float(), v.float()
    hs = []
    for t in range(S):
        state, h = mlstm_recurrent_step(state, q[:, t], k[:, t], v[:, t],
                                        i_pre[:, t], log_f[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d)
    return h.to(x.dtype), state


def mlstm_chunkwise(p, x, H, chunk: int = 256, state=None):
    """Chunkwise-parallel mLSTM.  Matches :func:`mlstm_sequential`."""
    B, S, d = x.shape
    Dh = d // H
    q, k, v, i_pre, log_f = _mlstm_qkv(p, x, H)
    W = min(chunk, S)
    pad = (-S) % W
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        # padded steps: i = -inf (no input), f = 0 (keep state)
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=NEG_BIG)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    NC = (S + pad) // W

    def to_chunks(a):
        return a.reshape(B, NC, W, *a.shape[2:]).unbind(1)

    chunks = zip(to_chunks(q.float()), to_chunks(k.float()),
                 to_chunks(v.float()), to_chunks(i_pre), to_chunks(log_f))
    st = state if state is not None else mlstm_state_init(B, H, Dh, x.device)
    tidx = torch.arange(W, device=x.device)
    causal = (tidx[:, None] >= tidx[None, :])[None, :, :, None]
    hs = []
    for qi, ki, vi, ii, fi in chunks:     # (B,W,H,Dh) / gates (B,W,H)
        Fc = torch.cumsum(fi, dim=1)      # inclusive cumsum of log f
        Ftot = Fc[:, -1]                  # (B,H)
        # intra-chunk log weights: logD[b,t,j,h] = F_t - F_j + i_j, j <= t
        logD = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]
        logD = torch.where(causal, logD, -math.inf)
        m_intra = torch.amax(logD, dim=2)                        # (B,W,H)
        # inter-chunk: the state decayed to step t has log-scale F_t + m
        m_inter = Fc + st["m"][:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        D = torch.exp(logD - m_t[:, :, None, :])                 # (B,W,W,H)
        inter_scale = torch.exp(m_inter - m_t)                   # (B,W,H)
        s = torch.einsum("bthd,bjhd->btjh", qi, ki) * D
        h_intra = torch.einsum("btjh,bjhd->bthd", s, vi)
        n_intra = torch.einsum("btjh,bjhd->bthd", D, ki)
        h_inter = torch.einsum("bthd,bhde->bthe",
                               qi * inter_scale[..., None], st["C"])
        n_t = n_intra + st["n"][:, None] * inter_scale[..., None]
        denom = torch.maximum(torch.einsum("bthd,bthd->bth", n_t, qi).abs(),
                              torch.exp(-m_t))[..., None]
        hs.append((h_intra + h_inter) / denom)                   # (B,W,H,Dh)
        # the state at the end of the chunk
        m_next = torch.maximum(Ftot + st["m"],
                               torch.amax(Ftot[:, None] - Fc + ii, dim=1))
        carry = torch.exp(Ftot + st["m"] - m_next)               # (B,H)
        w_j = torch.exp(Ftot[:, None] - Fc + ii - m_next[:, None])
        st = {"C": st["C"] * carry[..., None, None]
              + torch.einsum("bjh,bjhd,bjhe->bhde", w_j, ki, vi),
              "n": st["n"] * carry[..., None]
              + torch.einsum("bjh,bjhd->bhd", w_j, ki),
              "m": m_next}
    h = torch.cat(hs, dim=1)[:, :S].reshape(B, S, d)
    return h.to(x.dtype), st


# --------------------------------------------------------------------------
# sLSTM core
# --------------------------------------------------------------------------


def slstm_init(generator, d: int, H: int, device):
    """Float32 input weights (d, 4d), per-head recurrent weights
    (H, Dh, 4 Dh) truncated normal / sqrt(Dh), bias (4d)."""
    Dh = d // H
    return {
        "wx": L.dense_init(generator, (d, 4 * d), torch.float32, device),
        "wr": L.truncated_normal((H, Dh, 4 * Dh), generator, device)
        .div_(math.sqrt(Dh)),
        "b": _zeros((4 * d,), device),
    }


def slstm_state_init(batch: int, d: int, H: int, device):
    shape = (batch, H, d // H)
    return {"c": _zeros(shape, device), "n": _zeros(shape, device),
            "m": torch.full(shape, NEG_BIG, dtype=torch.float32,
                            device=device),
            "h": _zeros(shape, device)}


def slstm_cell(p, st, x_pre, H):
    """One recurrence step from the precomputed input preactivations
    x_pre (B, 4d) = x_t @ wx + b.  Each head's 4 Dh block of the
    preactivation holds its own i, f, z, o gates (the reshape to
    (B, H, 4 Dh) comes before the split)."""
    B = x_pre.shape[0]
    d = x_pre.shape[1] // 4
    Dh = d // H
    rec = torch.einsum("bhd,hde->bhe", st["h"], p["wr"])       # (B,H,4Dh)
    pre = x_pre.reshape(B, H, 4 * Dh) + rec
    i_pre, f_pre, z_pre, o_pre = pre.split(Dh, dim=-1)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + st["m"], i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(log_f + st["m"] - m_new)
    c = f_eff * st["c"] + i_eff * torch.tanh(z_pre)
    n = f_eff * st["n"] + i_eff
    h = torch.sigmoid(o_pre) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}, h.reshape(B, d)


def slstm_step(p, st, x_t, H):
    """x_t: (B, d) -> (state, h (B, d) float32).  The decode step."""
    return slstm_cell(p, st, x_t.float() @ p["wx"] + p["b"], H)


def slstm_sequential(p, x, H, state=None):
    """x: (B,S,d) -> (h (B,S,d) in x's dtype, state): the input
    preactivations in one product, then one cell a step."""
    B, S, d = x.shape
    st = state if state is not None else slstm_state_init(B, d, H, x.device)
    x_pre = x.float() @ p["wx"] + p["b"]                      # (B,S,4d)
    hs = []
    for pre_t in x_pre.unbind(1):
        st, h = slstm_cell(p, st, pre_t, H)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), st


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


class XLSTMModel:
    """Alternating mLSTM / sLSTM LM (family ``ssm``); parameters and
    caches are explicit dicts.

    ``device=None`` means ``cuda`` (it raises without a card);
    ``kernel_backend`` is ``cuda`` (the RMSNorm kernel) or ``torch`` (its
    plain version).
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 kernel_backend: "str | None" = None):
        if cfg.family != "ssm" or cfg.hybrid is None:
            raise ValueError(f"XLSTMModel serves the ssm family, not "
                             f"{cfg.family!r}")
        unknown = set(cfg.hybrid.pattern) - set(BLOCK_KINDS)
        if unknown:
            raise ValueError(f"XLSTMModel blocks are {BLOCK_KINDS}, got "
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
        self.H = cfg.n_heads
        d_in = int(cfg.d_model * cfg.hybrid.mlstm_proj_factor)
        self.d_in = d_in - d_in % self.H

    # ---------------------------------------------------------------- init

    def _mlstm_block_init(self, gen, dev):
        d, dt = self.cfg.d_model, self.dtype
        return {
            "norm": L.rmsnorm_init(d, dt, dev),
            "w_up": L.dense_init(gen, (d, 2 * self.d_in), dt, dev),
            "mlstm": mlstm_init(gen, self.d_in, self.H, dt, dev),
            "w_down": L.dense_init(gen, (self.d_in, d), dt, dev,
                                   in_axis_size=self.d_in),
        }

    def _slstm_block_init(self, gen, dev):
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        d_ff = int(d * cfg.hybrid.slstm_proj_factor)
        return {
            "norm": L.rmsnorm_init(d, dt, dev),
            "slstm": slstm_init(gen, d, self.H, dev),
            "ffn_norm": L.rmsnorm_init(d, dt, dev),
            "ffn": L.swiglu_init(gen, d, d_ff, dt, dev),
        }

    def _block_init(self, kind, gen, dev):
        return (self._mlstm_block_init if kind == "mlstm"
                else self._slstm_block_init)(gen, dev)

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

    def _mlstm_block(self, p, x, state=None, decode=False):
        h = self._norm(p["norm"], x)
        u = h @ p["w_up"]
        core_in, z = u[..., :self.d_in], u[..., self.d_in:]
        if decode:
            B = x.shape[0]
            q, k, v, i_pre, log_f = _mlstm_qkv(p["mlstm"], core_in, self.H)
            state, hh = mlstm_recurrent_step(
                state, q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                i_pre[:, 0], log_f[:, 0])
            hh = hh.reshape(B, 1, self.d_in).to(x.dtype)
        else:
            hh, state = mlstm_chunkwise(p["mlstm"], core_in, self.H,
                                        chunk=self.cfg.hybrid.chunk_size,
                                        state=state)
        hh = self._norm(p["mlstm"]["out_norm"], hh)
        hh = hh * F.silu(z.float()).to(x.dtype)
        return x + hh @ p["w_down"], state

    def _slstm_block(self, p, x, state=None, decode=False):
        h = self._norm(p["norm"], x)
        if decode:
            state, hh = slstm_step(p["slstm"], state, h[:, 0], self.H)
            hh = hh[:, None].to(x.dtype)
        else:
            hh, state = slstm_sequential(p["slstm"], h, self.H, state)
        x = x + hh
        h = self._norm(p["ffn_norm"], x)
        return x + L.swiglu(p["ffn"], h), state

    def _walk(self, params, caches=None):
        """(block fn, block params, the dict or list holding the block's
        state in ``caches`` (None without), its key there) in forward
        order: the units' blocks, then the tail's."""
        fns = {"mlstm": self._mlstm_block, "slstm": self._slstm_block}
        for u, up in enumerate(params["units"]):
            holder = None if caches is None else caches["units"][u]
            for i, kind in enumerate(self.unit):
                yield fns[kind], up[f"{kind}_{i}"], holder, f"{kind}_{i}"
        holder = None if caches is None else caches.get("tail")
        for j, (kind, p) in enumerate(zip(self.tail,
                                          params.get("tail", ()))):
            yield fns[kind], p, holder, j

    def _run(self, params, x, caches, decode):
        """Every block over x, each from its state in ``caches`` and
        leaving its new one there."""
        for fn, p, holder, key in self._walk(params, caches):
            x, holder[key] = fn(p, x, holder[key], decode)
        return x

    # ------------------------------------------------------------- forward

    def _embed_tokens(self, params, tokens):
        return params["embed"][tokens.long()].to(self.adtype)

    def _unembed(self, params, x):
        return (x @ params["embed"].T).to(
            L.torch_dtype(self.cfg.logits_dtype))

    def forward(self, params, tokens):
        """Training/prefill forward over the full sequence -> (logits
        (B,S,V), aux = 0)."""
        x = self._embed_tokens(params, tokens)
        for fn, p, _, _ in self._walk(params):
            x, _ = fn(p, x)
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x), torch.zeros((), device=x.device)

    def loss(self, params, batch):
        logits, aux = self.forward(params, batch["tokens"])
        ce = L.cross_entropy_loss(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving

    def _state_init(self, kind, batch: int):
        if kind == "mlstm":
            return mlstm_state_init(batch, self.H, self.d_in // self.H,
                                    self.device)
        return slstm_state_init(batch, self.cfg.d_model, self.H, self.device)

    def init_cache(self, batch: int, max_len: int):
        """Zeroed recurrent states (independent of ``max_len``: that is
        the point) and the next position (``pos``, a Python int)."""
        caches = {"units": [{f"{kind}_{i}": self._state_init(kind, batch)
                             for i, kind in enumerate(self.unit)}
                            for _ in range(self.n_units)],
                  "pos": 0}
        if self.tail:
            caches["tail"] = [self._state_init(kind, batch)
                              for kind in self.tail]
        return caches

    @torch.no_grad()
    def prefill(self, params, tokens, max_len: int | None = None):
        """Run the prompt, build decode caches; returns (last_logits,
        caches)."""
        x = self._embed_tokens(params, tokens)
        B, S, _ = x.shape
        caches = self.init_cache(B, max_len or S)
        x = self._run(params, x, caches, decode=False)
        caches["pos"] = S
        # the final norm is per position: only the last one is read
        x = self._norm(params["final_norm"], x[:, -1:])
        return self._unembed(params, x)[:, 0], caches

    @torch.no_grad()
    def decode_step(self, params, token, caches):
        """token (B,1) -> (logits (B,V), caches).  Each block's state in
        the caches is replaced by its new one."""
        x = self._embed_tokens(params, token)
        x = self._run(params, x, caches, decode=True)
        caches["pos"] += 1
        x = self._norm(params["final_norm"], x)
        return self._unembed(params, x)[:, 0], caches
