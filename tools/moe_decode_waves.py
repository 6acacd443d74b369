#!/usr/bin/env python3
"""Wall and device-busy time of mixtral's decode waves with this
checkout's grouped matmul and a parent's, in one process, in turns.

Usage (on a machine with a CUDA card):

    python3 tools/moe_decode_waves.py --parent DIR [--src DIR]
                                      [--rounds N] [--label NAME]

``repro_torch`` is imported from ``--src`` (default: this checkout's
``src``) and builds ``chip_smoke.py``'s ``moe_serve`` model: mixtral-8x22b
at full width, cut to MOE_LAYERS layers, random bf16 weights from
SERVE_SEED.  ``--parent`` names another checkout's ``src`` whose
``repro_torch.kernels.grouped_matmul`` is loaded beside it under another
name; the model's expert products (``repro_torch.models.moe.
expert_ffn_matmul``) are pointed at one package or the other, and
nothing else of the model changes.  Each round runs the sides in the
order parent, change, change, parent, so a drift of the host's speed
falls on both.  A side's turn:

* ``chip_smoke.py``'s ``serve_run`` (SERVE_REQUESTS requests of
  SERVE_PROMPT tokens, SERVE_NEW new ones, waves of SERVE_BATCH): its
  decode tok/s and decode seconds, and the grouped-matmul launches of
  the side's package;
* DECODE_WAVES decode waves of SERVE_NEW steps after one prefill of the
  first SERVE_BATCH prompts, each wave's wall by the host clock (the
  sampling and the host read of the tokens included, as in the engine)
  and the CPU time of the thread that drives it (``time.thread_time``:
  the host's own work, without its waits for the device);
* one such wave under ``torch.profiler`` (``chip_smoke.py``'s
  ``profile_decode_wave``): device busy ms and idle share.

One JSON line per turn, then one with each side's medians.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
DECODE_WAVES = 3


def decode_wave_walls(model, params, prompts, max_len: int, steps: int,
                      waves: int) -> "list[tuple[float, float]]":
    """The host-clock wall and the driving thread's CPU seconds of
    ``waves`` decode waves of ``steps`` steps, each from one prefill of
    ``prompts`` (the prefill not timed)."""
    walls = []
    for _ in range(waves):
        _, caches = model.prefill(params, prompts, max_len=max_len)
        tok = prompts[:, -1:]
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(steps):
            logits, caches = model.decode_step(params, tok, caches)
            tok = torch.argmax(logits, dim=-1)[:, None]
            tok.cpu()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0, time.thread_time() - c0))
        del caches
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--parent", required=True,
                    help="another checkout's src, its grouped matmul timed "
                         "beside this one's")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of parent, change, change, parent")
    ap.add_argument("--label", default="", help="tag of every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_decode_waves: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    sys.path.insert(2, str(ROOT / "tools"))
    import chip_smoke as cs
    from grouped_matmul_times import load_package
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config, get_model

    pgm = load_package(args.parent)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi_line()
    cfg = get_config(cs.MOE_ARCH).replace(n_layers=cs.MOE_LAYERS)
    model = get_model(cfg, kernel_backend="cuda")
    params = model.init(cs.SERVE_SEED)
    sides = {"change": (gm, gm.expert_ffn_matmul),
             "parent": (pgm, pgm.expert_ffn_matmul)}
    max_len = cs.SERVE_PROMPT + cs.SERVE_NEW + 1
    reqs = make_requests(cfg, cs.SERVE_BATCH, cs.SERVE_PROMPT, cs.SERVE_NEW,
                         cs.SERVE_SEED)
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                              device="cuda")
    # a short run of each side first: no timed run pays first use
    for _, fn in sides.values():
        moe.expert_ffn_matmul = fn
        cs.serve_run(cfg, model, params, 1, 64, 2)

    turns = {name: [] for name in sides}
    for rnd in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            pkg, fn = sides[name]
            moe.expert_ffn_matmul = fn
            pkg.reset_launch_counts()
            stats, _, wall, _ = cs.serve_run(cfg, model, params)
            launches = dict(pkg.LAUNCHES)
            walls = decode_wave_walls(model, params, prompts, max_len,
                                      cs.SERVE_NEW, DECODE_WAVES)
            prof = cs.profile_decode_wave(model, params, prompts, max_len)
            turn = {"round": rnd, "side": name,
                    "serve_wall_s": wall, "serve_waves": stats.waves,
                    "serve_decode_s": stats.decode_s,
                    "decode_tok_per_s": stats.decode_tok_per_s,
                    "grouped_matmul_launches": launches,
                    "decode_wave_wall_ms": [w * 1e3 for w, _ in walls],
                    "decode_wave_cpu_ms": [c * 1e3 for _, c in walls],
                    "profiled_wave_wall_ms": prof["wall_s"] * 1e3,
                    "device_busy_ms": prof["device_busy_ms"],
                    "device_idle_share": prof["device_idle_share"]}
            turns[name].append(turn)
            print(json.dumps({"tool": "moe_decode_waves",
                              "label": args.label, **turn, "card": card}),
                  flush=True)
    moe.expert_ffn_matmul = gm.expert_ffn_matmul

    def med(name, key):
        vals = []
        for t in turns[name]:
            v = t[key]
            vals.extend(v if isinstance(v, list) else [v])
        return statistics.median(vals)
    print(json.dumps({
        "tool": "moe_decode_waves", "label": args.label,
        "arch": cs.MOE_ARCH, "layers": cfg.n_layers,
        "medians": {name: {k: med(name, k) for k in (
            "decode_tok_per_s", "serve_decode_s", "decode_wave_wall_ms",
            "decode_wave_cpu_ms", "profiled_wave_wall_ms", "device_busy_ms",
            "device_idle_share")} for name in sides},
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
