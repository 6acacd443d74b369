"""The kernel wrappers' guard against a silent gap in an autograd graph.

A kernel writes its output through a raw pointer into a tensor that
autograd knows nothing about, so that output has no ``grad_fn``.  A loss
built on it with grad mode on would stop at the kernel: every parameter
before it would get no gradient, and a trainer would still "step".  So
every kernel wrapper refuses an input that requires grad while grad mode
is on.  A kernel with a gradient is called through its
``torch.autograd.Function`` (forward and backward run with grad mode
off there); the serve paths run under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch


def refuse_graph_inputs(name: str, *tensors: "torch.Tensor | None") -> None:
    """Raise ``RuntimeError`` where grad mode is on and one of
    ``tensors`` (None skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad with grad mode on, and the "
            "kernel's output would cut the autograd graph there; call its "
            "differentiable entry point (an autograd.Function) or run "
            "under torch.no_grad()")
