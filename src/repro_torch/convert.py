"""Carry the reference's state across: numpy arrays in, the port's
objects out.

The simulator's state is the routed flow set (the incidence COO and the
edge capacities) and the demand matrix: an incidence's ``flow``,
``edge``, ``frac``, ``n_flows`` and ``capacity``, a demand set's
``src``, ``dst`` and ``gbps``.  A model's state (the decoder LM's, the
hybrid's, the xLSTM's, the encoder-decoder's) is its parameter tree; a
trainer's is its ``TrainState`` (params, AdamW's step, moments and
master weights, the error-feedback residual).  The functions take plain
numpy arrays (nested dicts of them for a parameter tree), so nothing of
the reference package is imported; ``decoder_params_to_numpy`` goes the
other way, so that a test can hold the port's parameters against the
reference's after training steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .configs.base import ModelConfig
from .core.routing_vec import DemandArrays
from .models.layers import torch_dtype
from .models.registry import DECODER_FAMILIES
from .models.transformer import GROUPS
from .sim.fairshare import FlowIncidence


def incidence_from_arrays(flow, edge, frac, n_flows: int, capacity,
                          device=None) -> FlowIncidence:
    """A :class:`FlowIncidence` on ``device`` (default ``cuda``).  The
    entries must be sorted by flow, as the routers emit them."""
    dev = resolve_device(device)
    flow = torch.as_tensor(np.asarray(flow), dtype=torch.int64, device=dev)
    if flow.numel() > 1 and bool((flow[1:] < flow[:-1]).any()):
        raise ValueError("incidence entries must be sorted by flow")
    return FlowIncidence(
        flow,
        torch.as_tensor(np.asarray(edge), dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(frac), dtype=torch.float64, device=dev),
        int(n_flows),
        torch.as_tensor(np.asarray(capacity), dtype=torch.float64,
                        device=dev))


def demands_from_arrays(src, dst, gbps, device=None) -> DemandArrays:
    """A :class:`DemandArrays` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return DemandArrays(
        torch.as_tensor(np.asarray(src), dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(dst), dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(gbps), dtype=torch.float64, device=dev))


def _tensor(a, dtype, device) -> torch.Tensor:
    """``a`` as a tensor in ``dtype`` (None: ``a``'s own, ml_dtypes'
    bfloat16 kept) on ``device``."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)       # ml_dtypes' bfloat16: exact in fp32
        dtype = dtype or torch.bfloat16
    t = torch.tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


# subtrees that stay float32 whatever the parameters' dtype, as the
# reference's init makes them: the MoE router, the RG-LRU's gates and
# ``lam``, the recurrent block's conv taps, the mLSTM's gate weights and
# bias, and the whole sLSTM
FLOAT32_SUBTREES = ("router", "lru", "conv", "w_gates", "b_gates", "slstm")


def _tree(tree, dtype, device):
    """A tree of arrays as tensors in ``dtype`` (float32 under
    FLOAT32_SUBTREES), or each in its own dtype where ``dtype`` is None."""
    if isinstance(tree, dict):
        return {k: _tree(v, torch.float32 if dtype is not None
                         and k in FLOAT32_SUBTREES else dtype, device)
                for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def _layer(i, tree):
    """Layer ``i`` of a tree stacked on a leading axis, a tensor of its own
    (the trainer updates it in place)."""
    if isinstance(tree, dict):
        return {k: _layer(i, v) for k, v in tree.items()}
    return tree[i].clone()


def _unstack(tree: dict, cfg: ModelConfig, dev, dtype,
             layers: "dict[str, int] | None" = None) -> dict:
    """A reference tree (layer groups stacked) in the port's layout, a list
    of per-layer dicts under each group, through :func:`_tree`.  The
    groups are ``layers``' keys, each with its own layer count, or by
    default the decoder's :data:`GROUPS`, whose counts add up to the
    config's ``n_layers``."""
    groups = GROUPS if layers is None else tuple(layers)
    out = {k: _tree(v, dtype, dev) for k, v in tree.items()
           if k not in groups}
    sizes = {}
    for group in groups:
        if group not in tree:
            continue
        stacked = _tree(tree[group], dtype, dev)
        sizes[group] = len(tree[group]["attn_norm"]["scale"])
        out[group] = [_layer(i, stacked) for i in range(sizes[group])]
    got, want = (sum(sizes.values()), cfg.n_layers) if layers is None \
        else (sizes, layers)
    if got != want:
        raise ValueError(f"tree has {got} layers, config {want}")
    return out


def decoder_params_from_numpy(tree: dict, cfg: ModelConfig,
                              device=None) -> dict:
    """The reference ``DecoderLM``'s parameter tree (nested dicts of numpy
    arrays, layer leaves stacked on a leading ``(L, ...)`` axis, the
    experts' on ``(L, E, ...)``) as the port's parameters: the same dicts
    with a list of per-layer dicts under each layer group (``"layers"``,
    and ``"dense_layers"`` for an MoE config with leading dense layers),
    in ``cfg.param_dtype`` (the MoE router in float32) on ``device``
    (default ``cuda``)."""
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError("decoder parameters are of the families "
                                  f"{DECODER_FAMILIES}, not {cfg.family!r}")
    return _unstack(tree, cfg, resolve_device(device),
                    torch_dtype(cfg.param_dtype))


def _units_and_tail(tree: dict, cfg: ModelConfig, device) -> dict:
    """A reference recurrent model's tree (``units`` stacked on a leading
    ``(n_units, ...)`` axis, a ``tail`` list of blocks) in the port's
    layout, ``units`` a list of per-unit dicts, through :func:`_tree`;
    its block count checked against the config's layers."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    out = {k: _tree(v, dtype, dev) for k, v in tree.items()
           if k not in ("units", "tail")}
    units = _tree(tree.get("units", {}), dtype, dev)
    n_units = len(next(iter(units.values()))["norm"]["scale"]) \
        if units else 0
    out["units"] = [_layer(i, units) for i in range(n_units)]
    if "tail" in tree:
        out["tail"] = [_tree(block, dtype, dev) for block in tree["tail"]]
    n = n_units * len(units) + len(out.get("tail", ()))
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    return out


def hybrid_params_from_numpy(tree: dict, cfg: ModelConfig,
                             device=None) -> dict:
    """The reference ``RGLRUModel``'s parameter tree (``embed``,
    ``final_norm``, ``units`` with the blocks of one unit, ``rec_0``,
    ``rec_1``, ``attn_2``, stacked on a leading ``(n_units, ...)`` axis,
    and a ``tail`` list of blocks) as the port's parameters: the same
    dicts with ``units`` a list of per-unit dicts, in ``cfg.param_dtype``
    (everything under ``lru`` and ``conv`` in float32) on ``device``
    (default ``cuda``)."""
    if cfg.family != "hybrid":
        raise NotImplementedError("hybrid parameters are of the family "
                                  f"'hybrid', not {cfg.family!r}")
    return _units_and_tail(tree, cfg, device)


def ssm_params_from_numpy(tree: dict, cfg: ModelConfig,
                          device=None) -> dict:
    """The reference ``XLSTMModel``'s parameter tree (``embed``,
    ``final_norm``, ``units`` with the blocks ``mlstm_0`` and ``slstm_1``
    stacked on a leading ``(n_units, ...)`` axis, and a ``tail`` list of
    blocks) as the port's parameters: the same dicts with ``units`` a
    list of per-unit dicts, in ``cfg.param_dtype`` (the mLSTM's
    ``w_gates`` and ``b_gates`` and everything under ``slstm`` in
    float32) on ``device`` (default ``cuda``)."""
    if cfg.family != "ssm":
        raise NotImplementedError("ssm parameters are of the family "
                                  f"'ssm', not {cfg.family!r}")
    return _units_and_tail(tree, cfg, device)


def encdec_params_from_numpy(tree: dict, cfg: ModelConfig,
                             device=None) -> dict:
    """The reference ``EncDecLM``'s parameter tree (``embed``,
    ``enc_norm``, ``final_norm``, and ``enc_layers`` / ``dec_layers`` with
    their leaves stacked on a leading ``(L, ...)`` axis) as the port's
    parameters: the same dicts with a list of per-layer dicts under each
    of the two groups, in ``cfg.param_dtype`` on ``device`` (default
    ``cuda``)."""
    if cfg.family != "audio" or cfg.encdec is None:
        raise NotImplementedError("audio parameters are of the family "
                                  f"'audio', not {cfg.family!r}")
    return _unstack(tree, cfg, resolve_device(device),
                    torch_dtype(cfg.param_dtype),
                    {"enc_layers": cfg.encdec.n_encoder_layers,
                     "dec_layers": cfg.n_layers})


def train_state_from_numpy(state: dict, cfg: ModelConfig, device=None):
    """The reference trainer's ``TrainState`` as numpy (a dict: ``params``,
    ``step``, ``m``, ``v``, ``master`` (None without master weights) and
    ``ef`` (None without int8 error feedback), the trees in the
    reference's stacked layout) as the port's
    :class:`~repro_torch.train.trainer.TrainState` on ``device`` (default
    ``cuda``): params in ``cfg.param_dtype``, the moments in their own
    dtype (float32 or bfloat16), master weights and the residual float32,
    the step an int32 scalar."""
    from .optim.adamw import AdamWState
    from .train.trainer import TrainState

    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError("decoder train states are of the families "
                                  f"{DECODER_FAMILIES}, not {cfg.family!r}")
    dev = resolve_device(device)
    params = _unstack(state["params"], cfg, dev, torch_dtype(cfg.param_dtype))
    tree = lambda t: None if t is None else _unstack(t, cfg, dev, None)
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=dev)
    opt = AdamWState(step, tree(state["m"]), tree(state["v"]),
                     tree(state.get("master")))
    return TrainState(params, opt, tree(state.get("ef")))


def decoder_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`decoder_params_from_numpy`: the port's decoder
    parameters as the reference's tree, layer groups stacked on a leading
    axis, float32 numpy arrays (bf16 values are exact in float32)."""
    def host(t):
        return t.detach().to(torch.float32).cpu().numpy()

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([layer[k] for layer in layers]) for k in first}
        return np.stack([host(t) for t in layers])

    def tree(sub):
        if isinstance(sub, dict):
            return {k: tree(v) for k, v in sub.items()}
        return host(sub)

    return {k: stack(v) if k in GROUPS else tree(v)
            for k, v in params.items()}
