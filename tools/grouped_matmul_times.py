#!/usr/bin/env python3
"""Device time of the port's grouped matmuls at mixtral-8x22b's expert
shapes, for the package of a given checkout, beside a parent's.

Usage (on a machine with a CUDA card):

    python3 tools/grouped_matmul_times.py [--src DIR] [--parent DIR]
                                          [--label NAME]
                                          [--tile-variant BN:STAGES ...]

``repro_torch`` is imported from DIR (default: this checkout's ``src``);
``--parent`` names another checkout's ``src`` (an unpacked parent:
``git archive <commit> | tar -x -C build/repro_torch/parent``), whose
``repro_torch.kernels.grouped_matmul`` is loaded beside it under another
name, so the two kernels are timed in one process, on one card, by the
same rules, those of ``chip_smoke.py``: CUDA events around back-to-back
calls (``time_ms``, the Python wrapper included; the change's, the
parent's and the library's samples taken in turns), ``torch.profiler``'s
device time per call (``device_time``) and calls captured in one CUDA
graph timed by CUDA events (``graph_ms``), device and graph ms in the
order parent, change, change, parent, with the SM clock (``nvidia-smi``)
around each shape.  ``grouped_matmul`` runs at the five shapes of
``chip_smoke.py``'s ``check_grouped_matmul`` beside ``torch.bmm``, each
line with its K splits, whether its output equals the parent's bit for
bit, and (at the decode shapes) the host us a call of the wrapper, the
parent's and ``torch.bmm`` by the host clock, in turns; then the ``mma`` route's K split is forced to each of 1, 2, 4 and
8 at decode down and gate/up (``ops._launch``), each S's output held to
the plain version and, at S = 1, to the parent's bits; the host us of
the entry's launch at S = 1 and at S = 2 and of the S = 2 workspace's
``torch.empty`` alone, in turns, split the split's host cost into its
parts.  Each ``--tile-variant BN:STAGES`` builds a copy of DIR's package
whose ``mma`` tile is 16 x BN with STAGES stages (``Decode`` in the
``.cu``, ``MMA_TILE`` in ``ops.py``, under ``build/repro_torch/
variants/``) and times it unsplit at both decode shapes beside the
change's own call: event ms in turns, device and graph ms change,
variant, variant, change, its blocks an SM and grid, and whether its
output equals the change's S = 1 bits.
``ragged_grouped_matmul`` runs at a seeded routed layout of 8,192 rows
(4,096 tokens, top-2 of 8 experts, ownership blocks of 128 rows), as
routed and with every group padded to 128 rows, beside
``torch._grouped_mm``.  One JSON line per shape, with the device time of
each kernel name the call ran, and one with the blocks per SM of each
bf16 kernel (CUDA's occupancy calculator) and the mma route's slots.  A
package's own build directory (``DIR/../build``) holds its compiled
kernels.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import statistics
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (case, E, rows per expert, K, N): chip_smoke.py's check_grouped_matmul
E, D_MODEL, D_EXPERT = 8, 6144, 16384
SHAPES = [("prefill gate/up", E, 1280, D_MODEL, D_EXPERT),
          ("prefill down", E, 1280, D_EXPERT, D_MODEL),
          ("decode gate/up", E, 2, D_MODEL, D_EXPERT),
          ("decode down", E, 2, D_EXPERT, D_MODEL),
          ("window gate/up", E, 1300, D_MODEL, D_EXPERT)]
RAGGED_TOKENS, TOP_K, BLOCK_M = 4096, 2, 128
SWEEP = (1, 2, 4, 8)
# host-clock timing of a decode call: calls a sample (their device time,
# about 30 ms, stays within the launch queue) and samples (median)
HOST_CALLS, HOST_SAMPLES = 50, 7


def load_package(src: str, name: str = "parent_repro_torch",
                 kernel: str = "grouped_matmul"):
    """The ``repro_torch.kernels.<kernel>`` package under ``src``,
    imported as ``<name>.kernels.<kernel>`` (the kernels import each
    other relatively, and the top package's own ``__init__`` is not
    run)."""
    top = types.ModuleType(name)
    top.__path__ = [str(Path(src) / "repro_torch")]
    sys.modules[name] = top
    return importlib.import_module(f"{name}.kernels.{kernel}")


def tile_variant(src: str, bn: int, stages: int) -> str:
    """A copy of ``src``'s ``repro_torch`` whose mma tile is 16 x ``bn``
    with ``stages`` stages, under ``build/repro_torch/variants/``; its
    ``src`` directory (the copy builds its kernels beside it)."""
    dst = ROOT / "build" / "repro_torch" / "variants" / f"16x{bn}x{stages}"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(Path(src) / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = dst / "src" / "repro_torch" / "kernels" / "grouped_matmul"
    for path, old, new in (
            (pkg / "csrc" / "grouped_matmul.cu",
             "using Decode = Bf16Config<16, 128, 64, 1, 4, 4>;",
             f"using Decode = Bf16Config<16, {bn}, 64, 1, 4, {stages}>;"),
            (pkg / "ops.py", "MMA_TILE = (16, 128)",
             f"MMA_TILE = (16, {bn})")):
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"tile_variant: {old!r} not once in {path}")
        path.write_text(text.replace(old, new))
    return str(dst / "src")


def host_us(fns: dict) -> dict:
    """Median over samples of the host time per call of each function
    (us), the functions' samples taken in turns, the device idle at the
    start of each sample."""
    per_call = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(HOST_SAMPLES):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            per_call[name].append((time.perf_counter() - t0) / HOST_CALLS
                                  * 1e6)
    torch.cuda.synchronize()
    return {name: statistics.median(v) for name, v in per_call.items()}


def turns_ms(fns: dict, reps: int, samples: int = 7) -> dict:
    """``chip_smoke.py``'s ``time_ms`` for several functions in turns:
    each sample times ``reps`` back-to-back calls of each function by
    CUDA events, so a drift of the host's speed falls on all; the median
    of each."""
    for _ in range(3):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    per_call = {name: [] for name in fns}
    for _ in range(samples):
        for name, fn in fns.items():
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            t1.synchronize()
            per_call[name].append(t0.elapsed_time(t1) / reps)
    return {name: statistics.median(v) for name, v in per_call.items()}


def routed_layout(gen) -> "tuple[torch.Tensor, torch.Tensor]":
    """Group sizes of RAGGED_TOKENS tokens routed to their top-2 of E
    experts by standard normal logits, as routed and padded to BLOCK_M."""
    logits = torch.randn(RAGGED_TOKENS, E, device="cuda", generator=gen)
    top = torch.topk(logits, TOP_K, dim=-1).indices.reshape(-1)
    sizes = torch.bincount(top, minlength=E)
    return sizes, (sizes + BLOCK_M - 1) // BLOCK_M * BLOCK_M


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--parent", default=None,
                    help="another checkout's src, timed beside it")
    ap.add_argument("--label", default="", help="tag of every line")
    ap.add_argument("--tile-variant", action="append", default=[],
                    metavar="BN:STAGES",
                    help="an mma tile of 16 x BN with STAGES stages, timed "
                         "unsplit at the decode shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grouped_matmul_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import grouped_matmul as gm

    pgm = load_package(args.parent) if args.parent else None
    variants = []
    for spec in args.tile_variant:
        bn, stages = (int(v) for v in spec.split(":"))
        variants.append(((bn, stages), load_package(
            tile_variant(args.src, bn, stages), f"variant_{bn}x{stages}")))
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def kernel_names(call, reps: int) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        return {n[:100]: {"runs": c, "mean_ms": t / c / 1e3}
                for n, c, t in cs.device_events(prof)}

    def measure(call, parent_call, lib_call, heavy: bool) -> dict:
        """Event ms of the change, the parent and the library in turns;
        device and graph ms parent, change, change, parent (a / b)."""
        before = dict(gm.LAUNCHES)
        call()
        launched = {n: c - before[n] for n, c in gm.LAUNCHES.items()
                    if c != before[n]}
        reps, calls = (3, 5) if heavy else (20, 20)
        fns = {"change": call, "library": lib_call}
        if parent_call:
            fns["parent"] = parent_call
        clocks = [cs.sm_clock_mhz()]
        ms = turns_ms(fns, reps)
        clocks.append(cs.sm_clock_mhz())
        order = (["parent", "change", "change", "parent"] if parent_call
                 else ["change", "change"])
        dev, graph = {}, {}
        for who in order:
            fn = call if who == "change" else parent_call
            dev.setdefault(who, []).append(
                cs.device_time(fn, "gmm_", reps=reps)["ms"])
            graph.setdefault(who, []).append(cs.graph_ms(fn, calls))
        clocks.append(cs.sm_clock_mhz())
        lib = cs.device_time(lib_call, "", reps=reps)
        out = {"launched": launched, "ms": ms["change"],
               "device_ms_a_b": dev["change"], "graph_ms_a_b": graph["change"],
               "device_ms": dev["change"][0], "graph_ms": graph["change"][0],
               "kernels": kernel_names(call, reps),
               "sm_clock_mhz_around_ms_device_graph": clocks,
               "library_ms": ms["library"], "library_device_ms": lib["ms"],
               "library_graph_ms": cs.graph_ms(lib_call, calls)}
        if parent_call:
            out.update(parent_ms=ms["parent"],
                       parent_device_ms_a_b=dev["parent"],
                       parent_graph_ms_a_b=graph["parent"],
                       parent_kernels=kernel_names(parent_call, reps))
        return out

    def emit(**fields):
        flops, ms = fields["flops"], fields["device_ms"]
        print(json.dumps({
            "tool": "grouped_matmul_times", "label": args.label,
            "src": args.src, "parent": args.parent, **fields,
            "device_TFLOPs": flops / (ms * 1e-3) / 1e12 if ms else None,
            "graph_TFLOPs": flops / (fields["graph_ms"] * 1e-3) / 1e12,
            "card": card}), flush=True)

    for case, e, m, k, n in SHAPES:
        x, w = cs.expert_inputs(gen, e, m, k, n, torch.bfloat16)
        got = gm.grouped_matmul(x, w)
        want = gm.grouped_matmul_ref(x, w)
        err = cs.row_rel_err(got, want)
        same = (bool(torch.equal(got, pgm.grouped_matmul(x, w)))
                if pgm else None)
        splits = gm.ops.call_splits(x, w)
        n_bytes = 2 * (x.numel() + w.numel() + e * m * n)
        host = None
        if m <= 64:
            fns = {"wrapper": lambda: gm.grouped_matmul(x, w),
                   "library_call": lambda: torch.bmm(x, w)}
            if pgm:
                fns["parent_wrapper"] = lambda: pgm.grouped_matmul(x, w)
            host = host_us(fns)
        emit(kernel="grouped_matmul", case=case, x=list(x.shape),
             w=list(w.shape), kernel_route=gm.ops.call_route(x),
             splits=splits, max_row_rel_err_vs_plain=err,
             bits_equal_to_parent=same, host_us=host,
             **measure(lambda: gm.grouped_matmul(x, w),
                       (lambda: pgm.grouped_matmul(x, w)) if pgm else None,
                       lambda: torch.bmm(x, w), m > 2),
             library="torch.bmm (bf16)",
             **cs.gmm_cost(2 * e * m * k * n, n_bytes, x.dtype))

        if m <= 64:
            # the mma route at each forced K split, in turns
            dims = gm.ops._dims(x, w, None)
            outs = {s: torch.empty_like(got) for s in SWEEP}

            def forced(s):
                return lambda: gm.ops._launch("grouped_matmul", x, w,
                                              outs[s], None, dims, "mma",
                                              splits=s)
            calls = {f"S={s}": forced(s) for s in SWEEP}
            ms = turns_ms(calls, 20)
            parent_out = pgm.grouped_matmul(x, w) if pgm else None
            for s in SWEEP:
                calls[f"S={s}"]()
                print(json.dumps({
                    "tool": "grouped_matmul_times", "label": args.label,
                    "sweep": case, "splits": s,
                    "chosen": s == splits, "ms": ms[f"S={s}"],
                    "device_ms": cs.device_time(calls[f"S={s}"], "gmm_",
                                                reps=20)["ms"],
                    "graph_ms": cs.graph_ms(calls[f"S={s}"], 20),
                    "max_row_rel_err_vs_plain": cs.row_rel_err(outs[s],
                                                               want),
                    "bits_equal_to_auto": bool(torch.equal(outs[s], got)),
                    "bits_equal_to_parent": (
                        bool(torch.equal(outs[s], parent_out))
                        if pgm else None),
                    "card": card}), flush=True)
            # the split's host cost in parts: the entry's launch at S = 1
            # and at S = 2 (its workspace, both kernels), the workspace
            # alone
            ws_shape = (2, *got.shape)
            print(json.dumps({
                "tool": "grouped_matmul_times", "label": args.label,
                "host_us_of_the_split": case,
                **host_us({"launch S=1": calls["S=1"],
                           "launch S=2": calls["S=2"],
                           "workspace torch.empty": lambda: torch.empty(
                               ws_shape, dtype=torch.float32,
                               device="cuda")}),
                "card": card}), flush=True)
            for (bn, stages), vgm in variants:
                vout = torch.empty_like(got)

                def variant(vgm=vgm, vout=vout):
                    vgm.ops._launch("grouped_matmul", x, w, vout, None,
                                    vgm.ops._dims(x, w, None), "mma",
                                    splits=1)
                variant()
                torch.cuda.synchronize()
                auto = lambda: gm.grouped_matmul(x, w)
                ms = turns_ms({"change": auto, "variant": variant}, 20)
                dev, graph = {}, {}
                for who in ("change", "variant", "variant", "change"):
                    fn = auto if who == "change" else variant
                    dev.setdefault(who, []).append(
                        cs.device_time(fn, "gmm_", reps=20)["ms"])
                    graph.setdefault(who, []).append(cs.graph_ms(fn, 20))
                blocks = vgm.ops.occupancy("mma")
                units = vgm.ops.mma_units(vgm.ops._dims(x, w, None))
                slots = blocks * torch.cuda.get_device_properties(
                    x.device.index).multi_processor_count
                print(json.dumps({
                    "tool": "grouped_matmul_times", "label": args.label,
                    "tile_variant": case, "tile": [16, bn],
                    "stages": stages, "splits": 1, "blocks_per_sm": blocks,
                    "slots": slots, "grid_blocks": units,
                    "slot_fill": units / (-(-units // slots) * slots),
                    "ms": ms["variant"], "change_ms": ms["change"],
                    "change_splits": splits,
                    "device_ms_a_b": dev["variant"],
                    "change_device_ms_a_b": dev["change"],
                    "graph_ms_a_b": graph["variant"],
                    "change_graph_ms_a_b": graph["change"],
                    "max_row_rel_err_vs_plain": cs.row_rel_err(vout, want),
                    "bits_equal_to_change_s1": bool(torch.equal(
                        vout, outs[1])),
                    "card": card}), flush=True)
                del vout
            del outs, parent_out
        del x, w, got, want
        torch.cuda.empty_cache()

    sizes, padded = routed_layout(gen)
    w = cs.expert_inputs(gen, E, 1, D_MODEL, D_EXPERT, torch.bfloat16)[1]
    for case, gs in (("routed", sizes), ("padded to 128", padded)):
        T = int(gs.sum())
        x = torch.randn(T, D_MODEL, device="cuda",
                        generator=gen).to(torch.bfloat16)
        got = gm.ragged_grouped_matmul(x, w, gs, BLOCK_M)
        want = gm.ragged_grouped_matmul_masked_ref(x, w, gs, BLOCK_M)
        owner, inside = gm.block_owners(gs, T, BLOCK_M)
        err = cs.row_rel_err(got[inside], want[inside])
        masked_zero = bool((got[~inside] == 0).all())
        same = (bool(torch.equal(got, pgm.ragged_grouped_matmul(
            x, w, gs, BLOCK_M))) if pgm else None)
        del got, want
        kept = int(inside.sum())
        owners = int(torch.unique(owner[inside]).numel())
        offs = torch.cumsum(gs, 0).to(torch.int32)
        n_bytes = 2 * (x.numel() + owners * D_MODEL * D_EXPERT
                       + T * D_EXPERT)
        emit(kernel="ragged_grouped_matmul", case=case, x=list(x.shape),
             w=list(w.shape), block_m=BLOCK_M, group_sizes=gs.tolist(),
             rows_kept=kept, kernel_route=gm.ops.call_route(x, BLOCK_M),
             splits=gm.ops.call_splits(x, w, BLOCK_M),
             max_row_rel_err_vs_plain=err, masked_rows_zero=masked_zero,
             bits_equal_to_parent=same,
             **measure(lambda: gm.ragged_grouped_matmul(x, w, gs, BLOCK_M),
                       (lambda: pgm.ragged_grouped_matmul(x, w, gs, BLOCK_M))
                       if pgm else None,
                       lambda: torch._grouped_mm(x, w, offs=offs), True),
             library="torch._grouped_mm(offs=cumsum(group_sizes))",
             **cs.gmm_cost(2 * kept * D_MODEL * D_EXPERT, n_bytes,
                           x.dtype))
        del x
        torch.cuda.empty_cache()
    idx = torch.cuda.current_device()
    print(json.dumps({"tool": "grouped_matmul_times", "label": args.label,
                      "src": args.src,
                      "blocks_per_sm": {
                          "wgmma": gm.ops.occupancy("wgmma"),
                          "mma decode (16 x 128 x 64)":
                              gm.ops.occupancy("mma")},
                      "sms": torch.cuda.get_device_properties(
                          idx).multi_processor_count,
                      "mma_slots": gm.ops.slots(idx),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
