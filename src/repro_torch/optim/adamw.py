"""AdamW: a copy of ``repro/optim/adamw.py`` on PyTorch.

State dtype is configurable (float32 or bfloat16 moments); master
weights (fp32 copies of bf16 params) are optional; the gradients are
clipped by their global norm.  The state mirrors the parameter tree leaf
for leaf.  ``update`` writes the new parameters and moments into the
tensors it was given (the reference donates them to its jitted step), one
leaf at a time, so a step holds one leaf's fp32 temporaries at most.

The reference stacks each layer group's leaves on a leading ``(L, ...)``
axis and decides weight decay on that stacked leaf (``p.ndim >= 2`` and no
``norm``, ``bias``, ``b_gates``, ``ba``, ``bg`` or ``lam`` in its path).
The port keeps one dict a layer, so a leaf under ``layers`` or
``dense_layers`` counts one axis more: ``bq``, ``bk`` and ``bv`` are
``(L, H*Dh)`` there, decayed; a norm's ``scale`` is not.  Leaves are
visited in the reference's order (dict keys sorted, a group's layers of
one leaf together), which fixes the global norm's sum order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..configs.base import RunConfig
from ..models.layers import torch_dtype, tree_map
from ..models.transformer import GROUPS as STACKED_GROUPS
# path fragments that exempt a leaf from weight decay (the reference's)
NO_DECAY = ("norm", "bias", "b_gates", "ba", "bg", "lam")


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: Any                      # tree like params
    v: Any
    master: Any | None          # fp32 params if enabled


def _walk(tree, path: str, stacked: bool):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}" if path else str(k),
                             stacked)
    else:
        yield path, stacked, tree


def leaf_groups(tree) -> "list[tuple[str, bool, list]]":
    """(the reference's path, stacked, [tensors]) for each leaf of the
    reference's stacked tree, in its order: a layer group contributes one
    entry a leaf with that leaf of every layer, in layer order."""
    out = []
    for k in sorted(tree):
        sub = tree[k]
        if k in STACKED_GROUPS and isinstance(sub, list):
            if not sub:
                continue
            per_layer = [list(_walk(layer, k, True)) for layer in sub]
            for j, (path, _, _) in enumerate(per_layer[0]):
                out.append((path, True, [leaves[j][2]
                                         for leaves in per_layer]))
        else:
            out += [(path, False, [t]) for path, _, t in _walk(sub, k, False)]
    return out


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    master_weights: bool = False
    grad_clip_norm: float | None = 1.0

    @staticmethod
    def from_run(run: RunConfig) -> "AdamW":
        return AdamW(lr=run.lr, beta1=run.beta1, beta2=run.beta2,
                     eps=run.eps, weight_decay=run.weight_decay,
                     state_dtype=run.adam_dtype,
                     master_weights=run.master_weights)

    def init(self, params) -> AdamWState:
        dt = torch_dtype(self.state_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                          params) if self.master_weights else None
        step = torch.zeros((), dtype=torch.int32,
                           device=params["embed"].device)
        return AdamWState(step=step, m=tree_map(zeros, params),
                          v=tree_map(zeros, params), master=master)

    @staticmethod
    def _decayed(path: str) -> bool:
        """No weight decay on norms/biases (1-d leaves handled by caller)."""
        return not any(t in path for t in NO_DECAY)

    def decays(self, path: str, stacked: bool, leaf: torch.Tensor) -> bool:
        """The reference's decision for the leaf at ``path``: its stacked
        leaf has one axis more than a layer's."""
        ndim = leaf.dim() + (1 if stacked else 0)
        return ndim >= 2 and bool(self.weight_decay) and self._decayed(path)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr_scale=1.0):
        """Returns (params, state, metrics), ``params`` and the moments
        (and master weights) updated in place.  ``lr_scale`` comes from
        the LR schedule (a tensor on the device or a number)."""
        step = state.step + 1
        stepf = step.to(torch.float32)
        b1, b2 = self.beta1, self.beta2
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        lr = self.lr * lr_scale
        dt = torch_dtype(self.state_dtype)

        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            one = torch.ones((), dtype=torch.float32, device=gnorm.device)
            scale = torch.minimum(one, self.grad_clip_norm
                                  / torch.clamp_min(gnorm, 1e-12))
        else:
            gnorm = torch.zeros((), dtype=torch.float32,
                                device=stepf.device)
            scale = 1.0

        base = state.master if self.master_weights else params
        groups = zip(leaf_groups(grads), leaf_groups(state.m),
                     leaf_groups(state.v), leaf_groups(base),
                     leaf_groups(params))
        for (path, stacked, gs), (_, _, ms), (_, _, vs), (_, _, bs), \
                (_, _, ps) in groups:
            for g, m, v, b, p in zip(gs, ms, vs, bs, ps):
                g = g.to(torch.float32) * scale
                m32 = m.to(torch.float32) * b1 + (1 - b1) * g
                v32 = v.to(torch.float32) * b2 + (1 - b2) * torch.square(g)
                mhat = m32 / bc1
                vhat = v32 / bc2
                upd = mhat / (torch.sqrt(vhat) + self.eps)
                p32 = b.to(torch.float32)
                if self.decays(path, stacked, b):
                    upd = upd + self.weight_decay * p32
                p32 = p32 - lr * upd
                del g, mhat, vhat, upd
                m.copy_(m32.to(dt))
                v.copy_(v32.to(dt))
                if self.master_weights:
                    b.copy_(p32)
                p.copy_(p32.to(p.dtype))
        new_state = AdamWState(step, state.m, state.v,
                               state.master if self.master_weights else None)
        return params, new_state, {"grad_norm": gnorm}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in float32, leaf by leaf in
    the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for _, _, ts in leaf_groups(tree) for t in ts))
