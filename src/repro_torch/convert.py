"""Carry the reference's state across: numpy arrays in, the port's
objects out.

This system has no weights; its state is the routed flow set (the
incidence COO and the edge capacities) and the demand matrix.  The
functions take plain numpy arrays — an incidence's ``flow``, ``edge``,
``frac``, ``n_flows`` and ``capacity``, a demand set's ``src``, ``dst``
and ``gbps`` — so nothing of the reference package is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.routing_vec import DemandArrays
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
