#!/usr/bin/env python3
"""Time of the port's RMSNorm at the serve paths' six main-path shapes,
for the package of a given checkout, beside ``F.rms_norm``.

Usage (on a machine with a CUDA card):

    python3 tools/rmsnorm_times.py [--src DIR] [--label NAME]

``repro_torch`` is imported from DIR (default: this checkout's ``src``),
so one command can time two commits' kernels on one card by the same
rules, those of ``chip_smoke.py``: CUDA events around back-to-back calls
(``time_ms``, the Python wrapper included; here the kernel's and the
library's samples taken in turns), ``torch.profiler``'s device
time per call (``device_time``) and 20 calls in one CUDA graph timed by
CUDA events (``graph_ms``), each beside ``torch.nn.functional.rms_norm``
on the same bf16 inputs, with the SM clock (``nvidia-smi``) before and
after.  The wrapper's host time per call is split into its parts, each
timed alone by the host clock over back-to-back calls: the input checks;
``torch.empty``, and beside it ``x.new_empty`` and ``torch.empty_like``;
the two ways to find the current stream (a ``torch.cuda.Stream``
object's ``cuda_stream``, and ``torch._C._cuda_getCurrentRawStream``);
the ``torch.cuda.device`` context manager; the bare ctypes launch with
its arguments already computed; and the same ctypes call refused at the
entry point's first check (0 rows), which is ctypes alone.  One JSON
line per shape.  A package's own build
directory (``DIR/../build``) holds its compiled kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (arch, case, rows, d_model): the serve paths' RMSNorm calls in bf16,
# prefill of 4 requests of 1,024 tokens and a decode step of 4
SHAPES = [("yi-9b", "prefill", 4096, 4096), ("yi-9b", "decode", 4, 4096),
          ("mixtral-8x22b", "prefill", 4096, 6144),
          ("mixtral-8x22b", "decode", 4, 6144),
          ("recurrentgemma-2b", "prefill", 4096, 2560),
          ("recurrentgemma-2b", "decode", 4, 2560)]
EPS = 1e-6
# host-clock timing: calls a sample (fewer than the launch queue holds,
# so the host never waits for the device) and samples (median)
HOST_CALLS, HOST_SAMPLES = 200, 7


def host_us(fn) -> float:
    """Median over samples of the host time per call of ``fn`` (us),
    the device idle at the start of each sample."""
    fn()
    per_call = []
    for _ in range(HOST_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def paired_ms(fn, other, reps: int = 20, samples: int = 7
              ) -> "tuple[float, float]":
    """``chip_smoke.py``'s ``time_ms`` for two functions in turns: each
    sample times ``reps`` back-to-back calls of ``fn`` and then of
    ``other`` by CUDA events, so a drift of the host's speed falls on
    both; the median of each."""
    for _ in range(3):
        fn()
        other()
    torch.cuda.synchronize()
    per_call = ([], [])
    for _ in range(samples):
        for f, times in zip((fn, other), per_call):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                f()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(per_call[0]), statistics.median(per_call[1])


def parent_checks(x, scale):
    """The checks of a wrapper that has no check function of its own:
    those of the first CUDA RMSNorm wrapper, in its order, each reading
    the tensors' attributes anew."""
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError("shape")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("dtype")
    if scale.dtype != x.dtype:
        raise TypeError("scale dtype")
    if scale.device != x.device:
        raise ValueError("device")
    if x.device.type == "cpu":
        raise ValueError("cpu")
    if x.device.type != "cuda":
        raise ValueError("device type")
    N, D = x.shape
    ld = x.stride(0) if N > 1 else D
    if (x.stride(1) != 1 and D > 1) or ld < D or not scale.is_contiguous():
        raise ValueError("strides")


def launch_args(ops, x, scale, out) -> tuple:
    """The entry point's arguments for one call, computed ahead: the
    first wrapper's nine, or the launch word's eight."""
    N, D = x.shape
    dev = x.device.index
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), scale.data_ptr(), out.data_ptr())
    if not hasattr(ops, "launch_word"):
        code = {torch.float32: 0, torch.bfloat16: 1}[x.dtype]
        return ptrs + (N, D, D, EPS, code, stream)
    aligned = ops.aligned_rows(ptrs[0], ptrs[1], D, D, x.dtype)
    return ptrs + (N, D, EPS, ops.launch_word(D, x.dtype, aligned, dev),
                   stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default="", help="tag of every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rmsnorm_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.rmsnorm import ops

    card = cs.nvidia_smi_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(7)
    forward = ops.LIBRARY.load().rmsnorm_forward
    checks = getattr(ops, "check_inputs", parent_checks)
    for arch, case, rows, d in SHAPES:
        x = torch.randn(rows, d, device=dev, generator=gen).bfloat16()
        s = torch.randn(d, device=dev, generator=gen).bfloat16()
        got, want = rn.rmsnorm(x, s, EPS), rn.rmsnorm_ref(x, s, EPS)
        err = cs.check_close("rmsnorm", got, rn.rmsnorm(x, s, EPS), want,
                             5e-2, f"{arch} {case}")
        row_err = cs.row_rel_err(got, want)

        def call():
            rn.rmsnorm(x, s, EPS)

        def lib_call():
            F.rms_norm(x, (d,), weight=s, eps=EPS)

        clock_before = cs.sm_clock_mhz()
        ms, library_ms = paired_ms(call, lib_call)
        timed = {"ms": ms, "library_ms": library_ms,
                 "device_ms": cs.device_time(call, "rmsnorm")["ms"],
                 "library_device_ms": cs.device_time(lib_call, "")["ms"],
                 "graph_ms": cs.graph_ms(call),
                 "library_graph_ms": cs.graph_ms(lib_call)}
        clock_after = cs.sm_clock_mhz()

        out = torch.empty_like(x)
        fargs = launch_args(ops, x, s, out)
        nargs = fargs[:3] + (0,) + fargs[4:]   # 0 rows: refused
        idx = dev.index
        host = {
            "wrapper": host_us(call),
            "library_call": host_us(lib_call),
            "checks": host_us(lambda: checks(x, s)),
            "torch_empty": host_us(lambda: torch.empty(
                (rows, d), dtype=torch.bfloat16, device=dev)),
            "new_empty": host_us(lambda: x.new_empty((rows, d))),
            "empty_like": host_us(lambda: torch.empty_like(x)),
            "stream_object": host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "stream_raw": host_us(
                lambda: torch._C._cuda_getCurrentRawStream(idx)),
            "device_context": host_us(_device_context(dev)),
            "bare_launch": host_us(lambda: forward(*fargs)),
            # the entry point refusing 0 rows at its first check: ctypes
            # and its argument conversion alone
            "ctypes_only": host_us(lambda: forward(*nargs)),
        }
        del out
        p = ops.call_plan(x, s) if hasattr(ops, "call_plan") else None
        print(json.dumps({
            "tool": "rmsnorm_times", "label": args.label, "src": args.src,
            "arch": arch, "case": case, "shape": [rows, d],
            "dtype": "bfloat16", "route": p._asdict() if p else None,
            "max_abs_err": err, "max_row_rel_err": row_err, **timed,
            "library": "torch.nn.functional.rms_norm",
            "sm_clock_mhz_before": clock_before,
            "sm_clock_mhz_after": clock_after, "host_us": host,
            **cs.rmsnorm_cost(x, s), "card": card}), flush=True)
        del x, s, got, want
    return 0


def _device_context(dev):
    def enter_exit():
        with torch.cuda.device(dev):
            pass
    return enter_exit


if __name__ == "__main__":
    sys.exit(main())
