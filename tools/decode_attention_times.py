#!/usr/bin/env python3
"""Device time of the port's decode attention at the five decode shapes
of ``chip_smoke.py``'s serve paths, for the package of a given checkout.

Usage (on a machine with a CUDA card):

    python3 tools/decode_attention_times.py [--src DIR] [--label NAME]

``repro_torch`` is imported from DIR (default: this checkout's ``src``),
so one command can time two commits' kernels on one card by the same
rules, those of ``chip_smoke.py``: CUDA events around back-to-back calls
(``time_ms``, the Python wrapper included), ``torch.profiler``'s device
time per call (``device_time``) and 20 calls in one CUDA graph timed by
CUDA events (``graph_ms``), for ``flash_attention`` in bfloat16 and for
SDPA on the same inputs.  One JSON line per shape, with the device time
of each kernel name the call ran; a package's own build directory
(``DIR/../build``) holds its compiled kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (arch, case, B, K, G, Dh, cache slots, positions written, window): the
# decode steps of chip_smoke.py's serve paths.  yi-9b and mixtral-8x22b
# decode over the 1,057-slot cache of a 1,024-token prompt and 32 new
# tokens after 1,040 positions; the window waves' last step over the
# wrapped ring (4,160 + 8 positions into 4,096 slots, 2,304 + 8 into
# 2,048); recurrentgemma-2b's ring is min(1,057, its 2,048 window).
SHAPES = [
    ("yi-9b", "decode", 4, 4, 8, 128, 1057, 1040, None),
    ("mixtral-8x22b", "decode", 4, 8, 6, 128, 1057, 1040, 4096),
    ("mixtral-8x22b", "window decode", 1, 8, 6, 128, 4096, 4168, 4096),
    ("recurrentgemma-2b", "decode", 4, 1, 10, 256, 1057, 1040, 2048),
    ("recurrentgemma-2b", "window decode", 1, 1, 10, 256, 2048, 2312,
     2048),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default="", help="tag of every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_attention_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    card = cs.nvidia_smi_line()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for arch, case, B, K, G, Dh, cap, written, window in SHAPES:
        q_pos = cs.position_at(written - 1)
        kv_pos = cs.ring_kv_pos(cap, written, "cuda")
        q, k, v = cs.attention_inputs(gen, B, 1, K, G, cap, Dh,
                                      torch.bfloat16)
        kw = dict(causal=True, window=window)
        qs = q.reshape(B, 1, K * G, Dh).transpose(1, 2).contiguous()
        ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = fa.attention_mask(q_pos, kv_pos, True, window)

        def call():
            fa.flash_attention(q, k, v, q_pos, kv_pos, **kw)

        def lib_call():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)

        want = fa.attention_ref(q, k, v, q_pos, kv_pos, **kw).float()
        err = float((fa.flash_attention(q, k, v, q_pos, kv_pos, **kw).float()
                     - want).abs().max())
        before = dict(fa.LAUNCHES)
        call()
        launched = {n: c - before[n] for n, c in fa.LAUNCHES.items()
                    if c != before[n]}
        # each kernel name's mean device time over the runs recorded
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        kernels = {n[:100]: {"runs": c, "mean_ms": t / c / 1e3}
                   for n, c, t in cs.device_events(prof)}
        kern = cs.device_time(call, "flash_attention_kernel")
        lib = cs.device_time(lib_call, "")
        print(json.dumps({
            "tool": "decode_attention_times", "label": args.label,
            "src": args.src, "arch": arch, "case": case,
            "q": list(q.shape), "kv": list(k.shape), "window": window,
            "launched": launched, "max_abs_err_vs_plain": err,
            "ms": cs.time_ms(call), "device_ms": kern["ms"],
            "device_runs_recorded": kern["recorded"],
            "graph_ms": cs.graph_ms(call), "kernels": kernels,
            "library": "scaled_dot_product_attention(attn_mask, "
                       "enable_gqa=True)",
            "library_ms": cs.time_ms(lib_call),
            "library_device_ms": lib["ms"],
            "library_graph_ms": cs.graph_ms(lib_call),
            **cs.attention_cost(q, k, q_pos, kv_pos, True, window),
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
