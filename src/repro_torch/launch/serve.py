"""Serving launcher: batched prefill+decode with the ServeEngine.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
      --requests 8 --prompt-len 32 --max-new 16 --device cpu

Runs on ``cuda`` unless ``--device`` says otherwise (without a card it
raises); ``--kernel-backend torch`` swaps the CUDA kernels for their
plain PyTorch versions.  The weights are random, drawn on the device from
a generator seeded with ``--seed``.  The audio family (whisper-small) is
refused before any model is built, as the reference's launcher refuses
it: its requests need encoder frames as well as tokens, and
``EncDecLM``'s ``prefill`` / ``decode_step`` are driven directly
instead.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .._device import KERNEL_BACKENDS
from ..models.registry import ARCH_IDS, get_config, get_model
from ..serve.engine import Request, ServeEngine


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int) -> "list[Request]":
    """``n`` requests of ``prompt_len`` random tokens (numpy, from
    ``seed``), each asking for ``max_new`` tokens."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=prompt_len)
                    .astype(np.int32), max_new_tokens=max_new)
            for _ in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=KERNEL_BACKENDS)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in ("audio",):
        raise SystemExit("serve driver targets decoder LMs; whisper decode "
                         "is exercised in tests/benchmarks")
    model = get_model(cfg, device=args.device,
                      kernel_backend=args.kernel_backend)
    params = model.init(args.seed)
    print(f"[serve] {args.arch} (smoke={args.smoke}) "
          f"params={model.param_count():,} device={model.device} "
          f"kernels={model.backend}")

    max_len = args.prompt_len + args.max_new + 1
    eng = ServeEngine(model, params, max_batch=args.max_batch,
                      max_len=max_len, temperature=args.temperature,
                      seed=args.seed)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                         args.seed)
    t0 = time.perf_counter()
    eng.run(reqs)
    wall = time.perf_counter() - t0
    s = eng.stats
    print(f"[serve] {len(reqs)} requests in {wall:.2f}s | prefill "
          f"{s.prefill_s:.2f}s decode {s.decode_s:.2f}s | "
          f"{s.tokens_out} tokens | {s.decode_tok_per_s:.1f} tok/s")
    return s


if __name__ == "__main__":
    main()
