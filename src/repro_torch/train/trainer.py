"""Training loop: a copy of ``repro/train/trainer.py`` on PyTorch for the
unsharded case (the reference's ``Trainer(model, run)`` with no mesh; the
port has none yet, ROADMAP.md queue 1), with gradient accumulation, AdamW
and optional int8 error-feedback gradient compression.

One step: the loss and its gradients (``torch.autograd.grad`` through the
model; on the ``cuda`` backend RMSNorm and attention go through their
forward and backward kernels), then the optional compression, the
``warmup_cosine`` scale and ``AdamW.update``.  The state's tensors are
updated in place where the reference donates them to its jitted step.
The parameters require grad only while their gradients are taken.

The dense family alone trains here: a MoE or hybrid config raises
``NotImplementedError`` (their backward kernels, of the grouped matmuls
and of the RG-LRU scan, are later work in ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch

from ..configs.base import RunConfig
from ..models.layers import tree_leaves, tree_map
from ..optim.adamw import AdamW, AdamWState, leaf_groups
from ..optim.schedule import warmup_cosine

# the families the trainer takes
TRAINED_FAMILIES = ("dense",)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any | None          # int8 error-feedback residual (grad compression)


# --------------------------------------------------------------------------
# int8 error-feedback gradient compression (numerics model)
# --------------------------------------------------------------------------


def _quantize_int8(x: torch.Tensor, scale: "torch.Tensor | None" = None
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Symmetric int8, one scale (``max |x| / 127`` unless given):
    ``round`` is half to even, as ``jnp.round``."""
    if scale is None:
        scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads_ef(grads, ef):
    """g' = dequant(quant(g + ef)); ef' = (g + ef) - g'.  Returns new trees
    (g' in each gradient's dtype, ef' float32).  The reference quantizes
    each stacked leaf with one scale, so a layer group's leaf of every
    layer shares the scale of their joint max |g + ef|."""
    out = {}
    for (_, _, gs), (_, _, es) in zip(leaf_groups(grads), leaf_groups(ef)):
        g32s = [g.to(torch.float32) + e for g, e in zip(gs, es)]
        top = torch.stack([torch.max(torch.abs(x)) for x in g32s]).max()
        scale = torch.clamp_min(top, 1e-12) / 127.0
        for g, g32 in zip(gs, g32s):
            q, _ = _quantize_int8(g32, scale)
            deq = q.to(torch.float32) * scale
            out[id(g)] = (deq.to(g.dtype), g32 - deq)
    return (tree_map(lambda g: out[id(g)][0], grads),
            tree_map(lambda g: out[id(g)][1], grads))


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------


class Trainer:
    """``Trainer(model, run)``: ``model`` a ``DecoderLM`` of the dense
    family on its device (``cuda`` unless the caller asked for another)."""

    def __init__(self, model, run: RunConfig):
        cfg = model.cfg
        if cfg.family not in TRAINED_FAMILIES:
            raise NotImplementedError(
                f"the port trains the families {TRAINED_FAMILIES}, not "
                f"{cfg.family!r} ({cfg.arch_id}): MoE and hybrid training "
                "need backward kernels of the grouped matmuls and of the "
                "RG-LRU scan, ssm training the sLSTM time loop under "
                "autograd (ROADMAP.md queue 1)")
        if run.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"unknown grad_compression "
                             f"{run.grad_compression!r}")
        self.model = model
        self.run = run
        self.opt = AdamW.from_run(run)

    # ------------------------------------------------------------ state ----

    def init_state(self, seed: int = 0) -> TrainState:
        """Parameters from ``model.init(seed)`` on the model's device, zero
        moments (and fp32 master weights, and a zero error-feedback
        residual, where the run asks for them)."""
        params = self.model.init(seed)
        return self.state_from_params(params)

    def state_from_params(self, params) -> TrainState:
        opt = self.opt.init(params)
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params) \
            if self.run.grad_compression == "int8_ef" else None
        return TrainState(params, opt, ef)

    # ------------------------------------------------------- train step ----

    def _value_and_grad(self, params, batch):
        """(loss, metrics, grads): the model's loss and its gradients,
        a tree like ``params`` in each parameter's dtype."""
        leaves = list(tree_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = self.model.loss(params, batch)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        it = iter(grads)
        tree = tree_map(lambda _: next(it), params)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree

    def _grads(self, params, batch):
        k = self.run.microbatches
        if k <= 1:
            return self._value_and_grad(params, batch)

        # gradient accumulation over k microbatches (B must divide)
        def split(x):
            B = x.shape[0]
            if B % k:
                raise ValueError(f"batch {B} not divisible by "
                                 f"microbatches {k}")
            return x.reshape(k, B // k, *x.shape[1:])

        micro = {name: split(x) for name, x in batch.items()}
        dev = batch["tokens"].device
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(k):
            mb = {name: x[i] for name, x in micro.items()}
            loss, _, g = self._value_and_grad(params, mb)
            tree_map(lambda a, b: a.add_(b.to(torch.float32) / k), acc, g)
            del g
            loss_acc = loss_acc + loss / k
        grads = tree_map(lambda g, p: g.to(p.dtype), acc, params)
        return loss_acc, {"ce": loss_acc,
                          "aux": torch.zeros((), dtype=torch.float32,
                                             device=dev)}, grads

    def make_train_step(self) -> Callable:
        run = self.run

        def train_step(state: TrainState, batch):
            loss, metrics, grads = self._grads(state.params, batch)
            ef = state.ef
            if run.grad_compression == "int8_ef":
                grads, ef = compress_grads_ef(grads, ef)
            lr_scale = warmup_cosine(state.opt.step, run.warmup_steps,
                                     run.total_steps)
            params, opt, opt_metrics = self.opt.update(
                grads, state.opt, state.params, lr_scale)
            del grads
            out_metrics = {"loss": loss, "lr_scale": lr_scale,
                           **metrics, **opt_metrics}
            return TrainState(params, opt, ef), out_metrics

        return train_step

    def device_batch(self, batch: dict) -> dict:
        """A host batch (numpy int32 arrays) on the model's device."""
        return {k: torch.as_tensor(v, device=self.model.device)
                for k, v in batch.items()}

    # ------------------------------------------------------------- loop ----

    def fit(self, state: TrainState, batches, steps: int,
            log_every: int = 10, callback=None):
        """Simple synchronous loop over an iterator of host batches."""
        step_fn = self.make_train_step()
        history = []
        t0 = time.perf_counter()
        for i in range(steps):
            _, batch = next(batches)
            state, metrics = step_fn(state, self.device_batch(batch))
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i + 1
                m["elapsed_s"] = time.perf_counter() - t0
                history.append(m)
                if callback:
                    callback(m)
        return state, history
