#!/usr/bin/env python3
"""How ``chip_smoke.py``'s train phase reads its parameter check under
faults of the attention backward.

Usage (on a machine with a CUDA card):

    python3 tools/train_update_gap.py

The train phase's cell (yi-9b at full width and 8 of its 48 layers, lr
3e-3 with a one-step warmup, the lcg stream at 4,096 tokens, global batch
2) takes its four steps on the plain path (remat full), then four through
the kernels: sound, and with each fault below wrapped around
``flash_attention_backward`` from step 2 on, where the step-1 gradient
check cannot see it.  Each kernel run's losses and its
``chip_smoke.update_gap`` against the plain path (each leaf's L2 distance
over the plain path's own L2 update from the init, the worst leaf) are
one JSON line, beside the tolerance the phase holds it to.  Nothing of
the package is changed: the faults are wrappers of this process alone.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402


def fault(kind: str, dq, dk, dv):
    if kind == "dv rolled a position":
        return dq, dk, dv.roll(1, dims=1)
    if kind == "dk's last 64 keys zero":
        dk = dk.clone()
        dk[:, -64:] = 0
        return dq, dk, dv
    if kind == "dq scaled 1.1":
        return dq * 1.1, dk, dv
    return dq, dk, dv


def main() -> int:
    if not torch.cuda.is_available():
        print("train_update_gap: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train import Trainer

    card = cs.nvidia_smi_line()
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(cs.TRAIN_ARCH).replace(n_layers=cs.TRAIN_LAYERS)
    batches = cs.train_batches(cfg, cs.TRAIN_STEPS)

    def trainer(backend: str, remat: str) -> Trainer:
        r = RunConfig(lr=cs.TRAIN_LR, warmup_steps=cs.TRAIN_WARMUP,
                      remat=remat)
        return Trainer(get_model(cfg, r, kernel_backend=backend), r)

    tr = trainer("torch", "full")
    out = cs.train_run(tr, batches)
    plain, plain_losses = out["state"].params, out["losses"]
    del out
    torch.cuda.empty_cache()
    init = tr.model.init(cs.TRAIN_SEED)
    sound = ops.flash_attention_backward
    calls = [0]

    def faulty(kind):
        def backward(*args, **kw):
            calls[0] += 1
            grads = sound(*args, **kw)
            return grads if calls[0] <= cs.TRAIN_LAYERS \
                else fault(kind, *grads)
        return backward

    for kind in ("none", "dv rolled a position", "dk's last 64 keys zero",
                 "dq scaled 1.1"):
        calls[0] = 0
        ops.flash_attention_backward = faulty(kind)
        try:
            out = cs.train_run(trainer("cuda", "none"), batches)
        finally:
            ops.flash_attention_backward = sound
        gap = cs.update_gap(cs.host_leaves(out["state"].params), plain, init)
        cs.emit("train_update_gap", card=card, fault=kind,
                losses=out["losses"], plain_losses=plain_losses,
                loss_rel_gaps=[abs(a - b) / abs(b) for a, b in
                               zip(out["losses"], plain_losses)],
                param_update_gap=gap, tolerance=cs.TRAIN_UPDATE_TOL,
                flagged=gap > cs.TRAIN_UPDATE_TOL)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
