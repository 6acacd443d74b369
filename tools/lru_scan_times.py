#!/usr/bin/env python3
"""Time of the port's RG-LRU scan at recurrentgemma-2b's prefill and
window-wave shapes, for the package of a given checkout, beside a
parent's.

Usage (on a machine with a CUDA card):

    python3 tools/lru_scan_times.py [--src DIR] [--parent DIR]
                                    [--label NAME]

``repro_torch`` is imported from DIR (default: this checkout's ``src``);
``--parent`` names another checkout's ``src`` (an unpacked parent:
``git archive <commit> | tar -x -C build/repro_torch/parent``), whose
``repro_torch.kernels.rg_lru`` is loaded beside it under another name,
and so is a copy of it whose register kernel takes 32-thread blocks (the
parent's ``kThreads = 128`` rewritten, under
``build/repro_torch/variants/``): every SM busy, the parent's loads in
flight a thread.  All run in one process, on one card, by the rules of
``chip_smoke.py``: CUDA events around back-to-back calls (``time_ms``,
the Python wrapper included; the change's, the parent's and the
variant's samples taken in turns), ``torch.profiler``'s device time per
call (``device_time``: per kernel name, the mean over the runs it
recorded) and 20 calls in one CUDA graph timed by CUDA events
(``graph_ms``), device and graph ms in the order parent, variant,
change, change, variant, parent, with the SM clock (``nvidia-smi``)
before and after each shape.  Every output is held bit for bit against
``lru_scan_ref``.

At the prefill shape the wrapper's host time per call is split into its
parts, each timed alone by the host clock over back-to-back calls, in
turns: the whole wrapper (and the parent's), the checks,
``torch.empty_like`` for y and ``new_empty`` for h_last, the two ways to
find the current stream (a ``torch.cuda.Stream`` object's
``cuda_stream``, and ``torch._C._cuda_getCurrentRawStream``), the
``torch.cuda.device`` context manager, the plan and the cached word, the
bare ctypes launch with its arguments already computed, and the same
ctypes call refused at the entry point's first check (B = 0), which is
ctypes alone.

Then the sweep: the kernel's block and ring are constants of
``csrc/lru_scan.cu``, so each plan of (threads 32 / 64 / 128) x (stages
2 / 4 / 6) x (steps 16 / 32 / 64) whose ring fits 48 KB of shared memory
a block (``SWEEP``: 10 of the 27) is a copy of the package with those
constants rewritten (``plan_variant``, under
``build/repro_torch/variants/``; the copies are compiled in parallel).
Each is run at the prefill shape with each width of moves (vec 4 and 1,
forced through the launch word by ``entry_call``): the bits of each, and
its device and graph ms in two passes over the plans, the second in the
reverse order.

With ``--probe``, copies of the change's kernel with one part of a time
step taken out (``PROBES``: the y stores, the copies of a and b) are
built the same way and timed at the prefill shape beside the kernel,
with each width of moves, in turns (kernel, copy, copy, kernel): what
each part costs alone.  One JSON line per shape, one for the host split,
one for the sweep and one for the probes.  A package's own build
directory (``DIR/../build``) holds its compiled kernels.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ROOT / "build" / "repro_torch" / "variants"

# (case, B, S, W): recurrentgemma-2b's prefill of 4 requests of 1,024
# tokens (lru_width 2,560), and its window wave's one request of 2,304
SHAPES = [("prefill", 4, 1024, 2560), ("window", 1, 2304, 2560)]
PARENT_THREADS = "constexpr int kThreads = 128;"
# --probe: copies of the change's kernel with one part of a step taken out
# (text of csrc/lru_scan.cu -> its replacement, each found at least once)
PROBES = {
    "no_y_store": [("*reinterpret_cast<T*>(gy + t * width) =",
                    "if (false) *reinterpret_cast<T*>(gy + t * width) =")],
    "no_copies": [("copy<kVec>(d, ga", "if (false) copy<kVec>(d, ga"),
                  ("copy<kVec>(d + 4u * kSteps * 32, gb",
                   "if (false) copy<kVec>(d + 4u * kSteps * 32, gb")],
}
# the sweep's blocks and rings: (threads, stages, steps) of 32 / 64 / 128
# x 2 / 4 / 6 x 16 / 32 / 64 whose ring, (threads / 32) x (2 stages + 1)
# x steps rows of 128 bytes, fits the 48 KB a block takes without an
# opt-in (csrc/lru_scan.cu refuses to compile a larger one)
SWEEP = [(threads, stages, steps) for threads in (32, 64, 128)
         for stages in (2, 4, 6) for steps in (16, 32, 64)
         if threads // 32 * (2 * stages + 1) * steps * 128 <= 48 * 1024]


def threads_variant(src: str, threads: int) -> str:
    """A copy of ``src``'s ``repro_torch`` whose register kernel takes
    ``threads``-thread blocks (the parent's), under ``VARIANTS``; its
    ``src`` directory (the copy builds its kernels beside it)."""
    return source_variant(src, f"parent_t{threads}", [
        (PARENT_THREADS, f"constexpr int kThreads = {threads};")])


def plan_variant(src: str, threads: int, stages: int, steps: int,
                 root: Path = VARIANTS) -> str:
    """A copy of ``src``'s ``repro_torch`` whose scan kernel is compiled
    with ``threads`` a block and a ring of ``stages`` slots of ``steps``
    time steps (``csrc/lru_scan.cu``'s constants and ``ops.py``'s mirror
    of them rewritten), under ``root``; its ``src`` directory."""
    edits = [(rf"constexpr int {name} = \d+;", f"constexpr int {name} = "
              f"{value};") for name, value in (
                  ("kThreads", threads), ("kStages", stages),
                  ("kSteps", steps))]
    return source_variant(
        src, f"plan_{threads}x{stages}x{steps}", edits,
        ops_edits=[(r"(?m)^THREADS, STAGES, STEPS = .*$",
                    f"THREADS, STAGES, STEPS = {threads}, {stages}, "
                    f"{steps}")], root=root, regex=True)


def source_variant(src: str, name: str, edits, ops_edits=(),
                   root: Path = VARIANTS, regex: bool = False) -> str:
    """A copy of ``src``'s ``repro_torch`` whose ``lru_scan.cu`` has each
    (old, new) of ``edits`` replaced, and its ``rg_lru/ops.py`` each of
    ``ops_edits`` (``old`` a pattern where ``regex``, to be found once),
    under ``root/<name>``; its ``src`` directory."""
    dst = root / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(Path(src) / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = dst / "src" / "repro_torch" / "kernels" / "rg_lru"
    for path, pairs in ((pkg / "csrc" / "lru_scan.cu", edits),
                        (pkg / "ops.py", ops_edits)):
        text = path.read_text()
        for old, new in pairs:
            if regex:
                text, n = re.subn(old, new, text)
                if n != 1:
                    raise RuntimeError(f"source_variant: {old!r} found "
                                       f"{n} times in {path}")
            elif old not in text:
                raise RuntimeError(f"source_variant: {old!r} not in {path}")
            else:
                text = text.replace(old, new)
        path.write_text(text)
    return str(dst / "src")


def build_all(packages) -> None:
    """Compile each package's scan library, all at once (one nvcc each)."""
    with ThreadPoolExecutor(max_workers=len(packages)) as pool:
        list(pool.map(lambda pkg: pkg.ops.LIBRARY.build(), packages))


def entry_call(ops, a, b, h0, vec: int):
    """``ops``'s scan entry point on a, b, h0 with ``vec`` floats a lane
    forced through the launch word (y and h_last; not counted in
    ``LAUNCHES``): the kernel's other width of moves where the wrapper's
    plan would pick one.  A word the entry point refuses raises."""
    B, S, W = a.shape
    y, h = torch.empty_like(a), a.new_empty((B, W))
    idx = a.device.index
    rc = ops.LIBRARY.function("lru_scan_forward")(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), B, S, W, ops.launch_word(vec, idx),
        torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        ops.LIBRARY.fail("lru_scan", rc)
    return y, h


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--parent", default=None,
                    help="another checkout's src, timed beside it")
    ap.add_argument("--label", default="", help="tag of every line")
    ap.add_argument("--probe", action="store_true",
                    help="time copies of the kernel with a part taken out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lru_scan_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    sys.path.insert(2, str(ROOT / "tools"))
    import chip_smoke as cs
    from grouped_matmul_times import host_us, load_package, turns_ms
    from repro_torch.kernels import rg_lru
    from repro_torch.kernels.rg_lru import ops

    others = {}
    if args.parent:
        others["parent"] = load_package(args.parent, kernel="rg_lru")
        others["parent_t32"] = load_package(
            threads_variant(args.parent, 32), "parent_t32_repro_torch",
            kernel="rg_lru")
    card = cs.nvidia_smi_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    idx = dev.index
    gen = torch.Generator(device=dev).manual_seed(11)

    def emit(**fields):
        print(json.dumps({"tool": "lru_scan_times", "label": args.label,
                          "src": args.src, "parent": args.parent, **fields,
                          "card": card}), flush=True)

    for case, B, S, W in SHAPES:
        a = torch.empty(B, S, W, device=dev).uniform_(0.4, 0.999,
                                                      generator=gen)
        b = torch.randn(B, S, W, device=dev, generator=gen)
        h0 = torch.randn(B, W, device=dev, generator=gen)
        wy, wh = rg_lru.lru_scan_ref(a, b, h0)
        fns = {"change": lambda: rg_lru.lru_scan(a, b, h0)}
        for who, pkg in others.items():
            fns[who] = (lambda p: lambda: p.lru_scan(a, b, h0))(pkg)
        bits = {}
        for who, fn in fns.items():
            y, h = fn()
            bits[who] = bool(torch.equal(y, wy) and torch.equal(h, wh))
        torch.cuda.synchronize()
        if not bits["change"]:
            raise AssertionError(f"lru_scan {case}: not bit for bit equal "
                                 "to lru_scan_ref")
        cost = cs.lru_scan_cost(a)
        clock_before = cs.sm_clock_mhz()
        ms = turns_ms(fns, reps=20)
        order = (["parent", "parent_t32", "change", "change", "parent_t32",
                  "parent"] if others else ["change", "change"])
        device, graph = {}, {}
        for who in order:
            device.setdefault(who, []).append(
                cs.device_time(fns[who], "lru_scan_kernel")["ms"])
            graph.setdefault(who, []).append(cs.graph_ms(fns[who]))
        clock_after = cs.sm_clock_mhz()
        vec = ops.call_plan(a, b)
        gw, gb = ops.grid(B, W)
        emit(case=case, shape=[B, S, W],
             plan={"threads": ops.THREADS, "stages": ops.STAGES,
                   "steps": ops.STEPS, "vec": vec}, blocks=gw * gb,
             shared_bytes=ops.SHARED_BYTES, bitwise_equal_to_plain=bits,
             ms=ms, device_ms_a_b=device, graph_ms_a_b=graph,
             device_GBps={who: [cost["bytes"] / (t * 1e-3) / 1e9
                                for t in v if t] for who, v in
                          device.items()},
             bound_share_by_device_ms={who: [cost["bound_ms"] / t
                                             for t in v if t]
                                       for who, v in device.items()},
             sm_clock_mhz_before=clock_before,
             sm_clock_mhz_after=clock_after, **cost)
        if case != "prefill":
            continue

        # the wrapper's host time, split into its parts
        forward = ops.LIBRARY.function("lru_scan_forward")
        y, h = torch.empty_like(a), a.new_empty((B, W))
        word = ops.launch_word(vec, idx)
        stream = torch._C._cuda_getCurrentRawStream(idx)
        fargs = (a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 h.data_ptr(), B, S, W, word, stream)
        refused = fargs[:5] + (0,) + fargs[6:]   # B = 0: refused first

        def device_context():
            with torch.cuda.device(dev):
                pass

        parts = {
            "wrapper": fns["change"],
            "checks": lambda: ops.check_inputs(a, b, h0),
            "empty_like_y": lambda: torch.empty_like(a),
            "new_empty_h_last": lambda: a.new_empty((B, W)),
            "stream_object": lambda: torch.cuda.current_stream(dev)
            .cuda_stream,
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(idx),
            "device_context": device_context,
            "plan_and_word": lambda: ops.launch_word(
                ops.plan(W, ops.aligned_inputs(fargs[0], fargs[1])), idx),
            "bare_launch": lambda: forward(*fargs),
            "ctypes_only": lambda: forward(*refused),
        }
        if "parent" in fns:
            parts["parent_wrapper"] = fns["parent"]
        emit(case=case, shape=[B, S, W], host_us=host_us(parts))

        # every plan of the sweep, a copy of the package compiled with it
        variants = {plan: load_variant(plan_variant(args.src, *plan),
                                       "plan_{}x{}x{}_repro_torch"
                                       .format(*plan))
                    for plan in SWEEP}
        build_all(list(variants.values()))
        clock_before = cs.sm_clock_mhz()
        sweep = {}
        for vec in ops.VECS:
            for (threads, stages, steps), pkg in variants.items():
                y, h = entry_call(pkg.ops, a, b, h0, vec)
                torch.cuda.synchronize()
                sweep[threads, stages, steps, vec] = {
                    "threads": threads, "stages": stages, "steps": steps,
                    "vec": vec, "shared_bytes": pkg.ops.SHARED_BYTES,
                    "bitwise_equal_to_plain": bool(torch.equal(y, wy)
                                                   and torch.equal(h, wh)),
                    "device_ms": [], "graph_ms": []}
        # two passes over the plans, the second in the reverse order
        for key in [*sweep, *reversed(sweep)]:
            def call(ops=variants[key[:3]].ops, vec=key[3]):
                return entry_call(ops, a, b, h0, vec)

            sweep[key]["device_ms"].append(
                cs.device_time(call, "lru_scan_kernel")["ms"])
            sweep[key]["graph_ms"].append(cs.graph_ms(call))
        sweep = list(sweep.values())
        emit(case=case, shape=[B, S, W], sweep=sweep,
             sm_clock_mhz_before=clock_before,
             sm_clock_mhz_after=cs.sm_clock_mhz(),
             default=[ops.THREADS, ops.STAGES, ops.STEPS])
        if args.probe:
            emit(case=case, shape=[B, S, W],
                 probe=probe(a, b, h0, args.src, ops, cs))
        del y, h
    return 0


def probe(a, b, h0, src: str, ops, cs) -> list:
    """Device and graph ms of each ``PROBES`` copy of the kernel with each
    width of moves (vec 1 and 4), beside the kernel itself, in turns
    (kernel, copy, copy, kernel)."""
    pkgs = {name: load_variant(source_variant(src, f"probe_{name}", edits),
                               f"probe_{name}_repro_torch")
            for name, edits in PROBES.items()}
    build_all(list(pkgs.values()))
    rows = []
    for name, pkg in pkgs.items():
        for vec in ops.VECS:
            calls = {"kernel": lambda: entry_call(ops, a, b, h0, vec),
                     name: lambda: entry_call(pkg.ops, a, b, h0, vec)}
            row = {"probe": name, "vec": vec}
            for who in ("kernel", name, name, "kernel"):
                row.setdefault(f"{who}_device_ms", []).append(
                    cs.device_time(calls[who], "lru_scan_kernel")["ms"])
                row.setdefault(f"{who}_graph_ms", []).append(
                    cs.graph_ms(calls[who]))
            rows.append(row)
    return rows


def load_variant(src: str, name: str):
    from grouped_matmul_times import load_package
    return load_package(src, name, kernel="rg_lru")


if __name__ == "__main__":
    sys.exit(main())
