"""Training launcher: a copy of ``repro/launch/train.py`` for one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 100 --seq-len 128 --global-batch 8 --ckpt-dir /tmp/ck \\
      --device cpu

Runs on ``cuda`` unless ``--device`` says otherwise (without a card it
raises); ``--kernel-backend torch`` swaps the CUDA kernels (RMSNorm and
attention, forward and backward) for their plain PyTorch versions.  The
weights are random, drawn on the device from a generator seeded with
``--seed``; the data is the reference's synthetic stream, bit for bit.
One process and one device: the checkpoint cadence's host count is 1.
Prints the reference's ``[train] {...}`` lines.
"""

from __future__ import annotations

import argparse
import json
import time

from .._device import KERNEL_BACKENDS
from ..configs.base import RunConfig
from ..data.pipeline import (DataConfig, Prefetcher, SyntheticDataset,
                             loss_floor)
from ..models.registry import ARCH_IDS, get_config, get_model
from ..train.checkpoint import Checkpointer
from ..train.fault import StragglerMonitor, checkpoint_cadence_steps
from ..train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="0 = Young/Daly auto cadence")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default="lcg", choices=["lcg", "copy",
                                                      "uniform"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=KERNEL_BACKENDS)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    run = RunConfig(arch=args.arch, lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1),
                    microbatches=args.microbatches,
                    grad_compression=args.grad_compression, seed=args.seed)
    model = get_model(cfg, run, device=args.device,
                      kernel_backend=args.kernel_backend)
    trainer = Trainer(model, run)

    dcfg = DataConfig(kind=args.data, vocab_size=cfg.vocab_size,
                      seq_len=args.seq_len, global_batch=args.global_batch,
                      seed=args.seed)
    ds = SyntheticDataset(dcfg)
    print(f"[train] {args.arch} (smoke={args.smoke}) "
          f"params={model.param_count():,} "
          f"floor={loss_floor(dcfg):.3f} nats device={model.device} "
          f"kernels={model.backend}")

    state = trainer.init_state(args.seed)
    start_step = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and args.resume and ck.latest_step() is not None:
        state, start_step = ck.restore(state, device=model.device)
        print(f"[train] resumed from step {start_step}")

    cadence = args.ckpt_every or checkpoint_cadence_steps(
        n_hosts=1, save_cost_s=1.0, step_time_s=1.0)
    straggler = StragglerMonitor()
    step_fn = trainer.make_train_step()
    pf = Prefetcher(ds, start_step=start_step)
    hist = []
    t_last = time.perf_counter()
    try:
        for i in range(start_step, args.steps):
            _, batch = next(pf)
            state, metrics = step_fn(state, trainer.device_batch(batch))
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            if straggler.observe(dt):
                print(f"[train] straggler event at step {i + 1}: {dt:.2f}s")
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                m = {k: round(float(v), 4)
                     for k, v in sorted(metrics.items())}
                m.update(step=i + 1, sec_per_step=round(dt, 3))
                hist.append(m)
                print(f"[train] {json.dumps(m)}")
            if ck and (i + 1) % cadence == 0:
                ck.save(i + 1, state, blocking=False)
    finally:
        pf.close()
    if ck:
        ck.wait()
        ck.save(args.steps, state)
    return hist


if __name__ == "__main__":
    main()
