#!/usr/bin/env python3
"""Time of the port's attention backward at the yi-9b train cell and at
the window and head-dim 64 / 256 shapes of ``chip_smoke.py``'s
``check_attention_backward``, for the package of a given checkout, beside
a parent's and SDPA's.

Usage (on a machine with a CUDA card):

    python3 tools/attention_backward_times.py [--src DIR] [--parent DIR]
                                              [--label NAME]

``repro_torch`` is imported from DIR (default: this checkout's ``src``);
``--parent`` names another checkout's ``src`` (an unpacked parent:
``git archive <commit> | tar -x -C build/repro_torch/parent``), whose
``repro_torch.kernels.flash_attention`` is loaded beside it under another
name.  Every shape is bfloat16 and causal, its inputs standard normal
from a seed, ``o`` and each row's LSE from this checkout's forward.  In
one process, on one card, by the rules of ``chip_smoke.py``: CUDA events
around back-to-back calls (``time_ms``, the Python wrapper included), the
samples taken in turns (parent, change, change without the LSE, SDPA,
SDPA, change without the LSE, change, parent), ``nvidia-smi``'s SM clock
read before each sample; then ``torch.profiler``'s device ms of each
kernel name a call runs (each pass), in the same order.  The change runs
with the forward's LSE (the train path's call) and without it; the
parent's API takes no LSE, so it runs the common call alone.  Every
gradient is held against ``attention_backward_ref`` at 2e-2 of its max.
SDPA (``is_causal`` with no window, else a boolean mask; ``enable_gqa``)
is the yardstick, timed as ``torch.autograd.grad`` of its output.  One
JSON line per shape, with the bound and the achieved TFLOP/s of each
timed call.  A package's own build directory (``DIR/../build``) holds its
compiled kernels.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (case, B, S, K, G, Dh, window): the train cell (yi-9b, q (2, 4096, 4,
# 8, 128)) and check_attention_backward's shapes
SHAPES = [("cell", 2, 4096, 4, 8, 128, None),
          ("window-g8-dh128", 1, 1024, 2, 8, 128, 256),
          ("causal-g1-dh64", 2, 384, 8, 1, 64, None),
          ("window-g1-dh256", 1, 300, 2, 1, 256, 64),
          ("causal-g4-dh256", 1, 256, 2, 4, 256, None)]
TOL = 2e-2
ORDER = ["parent", "change", "change_without_lse", "sdpa", "sdpa",
         "change_without_lse", "change", "parent"]


def load_package(src: str, name: str = "parent_repro_torch"):
    """The ``repro_torch.kernels.flash_attention`` package under ``src``,
    imported as ``<name>.kernels.flash_attention`` (the kernels import
    each other relatively, and the top package's own ``__init__`` is not
    run)."""
    top = types.ModuleType(name)
    top.__path__ = [str(Path(src) / "repro_torch")]
    sys.modules[name] = top
    return importlib.import_module(f"{name}.kernels.flash_attention")


def max_rel_err(got, want) -> float:
    """max over the three gradients of max |got - want| / max |want|."""
    return max(float((g.float() - w.float()).abs().max())
               / float(w.float().abs().max()) for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--parent", default=None,
                    help="another checkout's src, timed beside it")
    ap.add_argument("--label", default="", help="tag of every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_backward_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    card = cs.nvidia_smi_line()
    parent = load_package(args.parent) if args.parent else None
    libs = [fa.ops.LIBRARY, fa.ops.BACKWARD_LIBRARY]
    if parent is not None:
        libs.append(parent.ops.BACKWARD_LIBRARY)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        builds = list(pool.map(lambda lib: lib.build(), libs))
    for lib, (path, log) in zip(libs, builds):
        lib.load()
        print(json.dumps({
            "tool": "attention_backward_times", "build": str(path),
            "ptxas": [l.strip() for l in log.splitlines()
                      if "registers" in l or "spill" in l
                      or "Compiling entry" in l]}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(12)
    for case, B, S, K, G, Dh, window in SHAPES:
        q, k, v = cs.attention_inputs(gen, B, S, K, G, S, Dh,
                                      torch.bfloat16)
        do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
        pos = cs.positions_range(S)
        kw = dict(causal=True, window=window)
        with torch.no_grad():
            o, lse = fa.flash_attention_with_lse(q, k, v, pos, pos, **kw)
        bwd = (q, k, v, o, do, pos, pos)
        qs = q.reshape(B, S, K * G, Dh).transpose(1, 2).detach()
        ks, vs = (t.transpose(1, 2).detach() for t in (k, v))
        leaves = [t.requires_grad_(True) for t in (qs, ks, vs)]
        mask = None if window is None else \
            fa.attention_mask(pos, pos, True, window)
        y = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=mask is None, enable_gqa=True)
        dy = do.reshape(B, S, K * G, Dh).transpose(1, 2)
        fns = {
            "change": lambda: fa.flash_attention_backward(*bwd, **kw,
                                                          lse=lse),
            "change_without_lse": lambda: fa.flash_attention_backward(
                *bwd, **kw),
            "sdpa": lambda: torch.autograd.grad(y, leaves, dy,
                                                retain_graph=True),
        }
        if parent is not None:
            fns["parent"] = lambda: parent.flash_attention_backward(*bwd,
                                                                    **kw)
        want = fa.attention_backward_ref(*bwd, **kw)
        errs = {}
        for name in fns:
            if name == "sdpa":
                continue
            got = fns[name]()
            errs[name] = max_rel_err(got, want)
            if errs[name] > TOL:
                raise AssertionError(f"{case} {name}: {errs[name]} of the "
                                     f"plain gradients' max away")
        del want
        torch.cuda.empty_cache()
        reps = 3 if case == "cell" else 10
        samples = {name: [] for name in fns}
        clocks = {name: [] for name in fns}
        order = [n for n in ORDER if n in fns]
        for name in order:
            clocks[name].append(cs.sm_clock_mhz())
            samples[name].append(cs.time_ms(fns[name], reps=reps,
                                            samples=3))
        passes = {name: [] for name in fns}
        for name in order:
            passes[name].append(cs.pass_device_ms(fns[name], "", reps=reps))
        cost = cs.attention_backward_cost(q, k, pos, pos, True, window)
        ms = {name: statistics.median(v) for name, v in samples.items()}
        print(json.dumps({
            "tool": "attention_backward_times", "label": args.label,
            "src": args.src, "parent": args.parent, "case": case,
            "q": list(q.shape), "kv": list(k.shape), "window": window,
            "dtype": "bfloat16", "kernel_route":
                fa.ops._backward_route(q.dtype),
            "max_rel_err_vs_plain": errs, "tolerance": TOL,
            "ms": ms, "ms_samples": samples, "sm_clock_mhz": clocks,
            "pass_device_ms": passes,
            "achieved_TFLOPs": {n: cost["flops"] / (t * 1e-3) / 1e12
                                for n, t in ms.items()},
            "parent_over_change": (ms["parent"] / ms["change"]
                                   if parent is not None else None),
            "library": "scaled_dot_product_attention(enable_gqa=True) "
                       "backward",
            **cost, "card": card}), flush=True)
        del q, k, v, do, o, lse, bwd, qs, ks, vs, leaves, y, dy, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
