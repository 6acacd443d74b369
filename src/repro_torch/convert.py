"""Carry the reference's state across: numpy arrays in, the port's
objects out.

The simulator's state is the routed flow set (the incidence COO and the
edge capacities) and the demand matrix: an incidence's ``flow``,
``edge``, ``frac``, ``n_flows`` and ``capacity``, a demand set's
``src``, ``dst`` and ``gbps``.  The decoder LM's state is its parameter
tree.  The functions take plain numpy arrays (nested dicts of them for a
parameter tree), so nothing of the reference package is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .configs.base import ModelConfig
from .core.routing_vec import DemandArrays
from .models.layers import torch_dtype
from .models.registry import NOT_PORTED, PORTED_FAMILIES
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


def _tree(tree, dtype, device):
    if isinstance(tree, dict):
        # the MoE router stays float32 whatever the parameters' dtype, as
        # the reference's moe_init makes it
        return {k: _tree(v, torch.float32 if k == "router" else dtype,
                         device) for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def decoder_params_from_numpy(tree: dict, cfg: ModelConfig,
                              device=None) -> dict:
    """The reference ``DecoderLM``'s parameter tree (nested dicts of numpy
    arrays, layer leaves stacked on a leading ``(L, ...)`` axis, the
    experts' on ``(L, E, ...)``) as the port's parameters: the same dicts
    with a list of per-layer dicts under each layer group (``"layers"``,
    and ``"dense_layers"`` for an MoE config with leading dense layers),
    in ``cfg.param_dtype`` (the MoE router in float32) on ``device``
    (default ``cuda``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"the parameters of family {cfg.family!r} "
                                  f"{NOT_PORTED}")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    out = {k: _tree(v, dtype, dev) for k, v in tree.items()
           if k not in GROUPS}

    def layer(i, t):
        return {k: layer(i, v) for k, v in t.items()} \
            if isinstance(t, dict) else t[i].contiguous()

    n = 0
    for group in GROUPS:
        if group not in tree:
            continue
        stacked = _tree(tree[group], dtype, dev)
        size = len(tree[group]["attn_norm"]["scale"])
        out[group] = [layer(i, stacked) for i in range(size)]
        n += size
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    return out
