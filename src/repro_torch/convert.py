"""Carry the reference's state across: numpy arrays in, the port's
objects out.

The simulator's state is the routed flow set (the incidence COO and the
edge capacities) and the demand matrix: an incidence's ``flow``,
``edge``, ``frac``, ``n_flows`` and ``capacity``, a demand set's
``src``, ``dst`` and ``gbps``.  A model's state (the decoder LM's, the
hybrid's) is its parameter tree.  The functions take plain numpy arrays
(nested dicts of them for a parameter tree), so nothing of the reference
package is imported.
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
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)       # ml_dtypes' bfloat16: exact in fp32
    return torch.tensor(a, device=device).to(dtype)


# subtrees that stay float32 whatever the parameters' dtype, as the
# reference's init makes them: the MoE router, the RG-LRU's gates and
# ``lam``, and the recurrent block's conv taps
FLOAT32_SUBTREES = ("router", "lru", "conv")


def _tree(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _tree(v, torch.float32 if k in FLOAT32_SUBTREES
                         else dtype, device) for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def _layer(i, tree):
    """Layer ``i`` of a tree stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _layer(i, v) for k, v in tree.items()}
    return tree[i].contiguous()


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
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    out = {k: _tree(v, dtype, dev) for k, v in tree.items()
           if k not in GROUPS}
    n = 0
    for group in GROUPS:
        if group not in tree:
            continue
        stacked = _tree(tree[group], dtype, dev)
        size = len(tree[group]["attn_norm"]["scale"])
        out[group] = [_layer(i, stacked) for i in range(size)]
        n += size
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
