#!/usr/bin/env python3
"""Device time of the port's grouped matmuls at mixtral-8x22b's expert
shapes, for the package of a given checkout.

Usage (on a machine with a CUDA card):

    python3 tools/grouped_matmul_times.py [--src DIR] [--label NAME]

``repro_torch`` is imported from DIR (default: this checkout's ``src``),
so one command can time two commits' kernels on one card by the same
rules, those of ``chip_smoke.py``: CUDA events around back-to-back calls
(``time_ms``, the Python wrapper included), ``torch.profiler``'s device
time per call (``device_time``) and calls captured in one CUDA graph
timed by CUDA events (``graph_ms``), with the SM clock (``nvidia-smi``)
before and after each.  ``grouped_matmul`` runs at the five shapes of
``chip_smoke.py``'s ``check_grouped_matmul`` beside ``torch.bmm``;
``ragged_grouped_matmul`` at a seeded routed layout of 8,192 rows (4,096
tokens, top-2 of 8 experts, ownership blocks of 128 rows), as routed and
with every group padded to 128 rows, beside ``torch._grouped_mm``.  One
JSON line per shape, with the device time of each kernel name the call
ran, and one with the blocks per SM of each bf16 kernel of that source
(CUDA's occupancy calculator).  A package's own build directory
(``DIR/../build``) holds its compiled kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
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

# a source without the occupancy entry point (a parent) is probed by a
# file that includes it: each kernel instance it may hold, with its
# threads and dynamic shared memory
PROBE = """#include "{source}"
extern "C" int probe_occupancy(int which, int* blocks) {{
  switch (which) {{
{cases}
  }}
  return 1;
}}
"""
PROBE_CASE = """    case {i}: {{
      cudaError_t e = cudaFuncSetAttribute({fn},
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int){smem});
      if (e != cudaSuccess) return (int)e;
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, {fn}, {threads}, {smem});
    }}"""
PROBED = {"mma prefill (128 x 128 x 32)": "Prefill",
          "mma decode (16 x 128 x 64)": "Decode"}


def occupancy(gm) -> dict:
    """Blocks per SM of each bf16 kernel of the imported package's
    source."""
    if hasattr(gm.ops, "occupancy"):
        return {"wgmma": gm.ops.occupancy("wgmma"),
                "mma decode (16 x 128 x 64)": gm.ops.occupancy("mma")}
    from repro_torch.kernels import _build

    source = gm.ops.LIBRARY.source
    text = source.read_text()
    names = [n for n, cfg in PROBED.items() if f"using {cfg} =" in text]
    cases = "\n".join(PROBE_CASE.format(
        i=i, fn=f"gmm_bf16_kernel<{PROBED[n]}>",
        threads=f"{PROBED[n]}::kThreads", smem=f"{PROBED[n]}::kSmem")
        for i, n in enumerate(names))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = _build.BUILD_DIR / "grouped_matmul_occupancy_probe.cu"
    probe.write_text(PROBE.format(source=source, cases=cases))
    lib = probe.with_suffix(".so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(probe)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).probe_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = {}
    for i, name in enumerate(names):
        blocks = ctypes.c_int(0)
        rc = fn(i, ctypes.byref(blocks))
        out[name] = blocks.value if rc == 0 else f"CUDA error {rc}"
    return out


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
    ap.add_argument("--label", default="", help="tag of every line")
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

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def measure(call, lib_call, heavy: bool) -> dict:
        before = dict(gm.LAUNCHES)
        call()
        launched = {n: c - before[n] for n, c in gm.LAUNCHES.items()
                    if c != before[n]}
        reps, calls = (3, 5) if heavy else (20, 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        kernels = {n[:100]: {"runs": c, "mean_ms": t / c / 1e3}
                   for n, c, t in cs.device_events(prof)}
        clocks = [cs.sm_clock_mhz()]
        ms = cs.time_ms(call, reps=reps)
        clocks.append(cs.sm_clock_mhz())
        kern = cs.device_time(call, "gmm_", reps=reps)
        clocks.append(cs.sm_clock_mhz())
        graph = cs.graph_ms(call, calls)
        clocks.append(cs.sm_clock_mhz())
        lib = cs.device_time(lib_call, "", reps=reps)
        return {"launched": launched, "ms": ms, "device_ms": kern["ms"],
                "device_runs_recorded": kern["recorded"],
                "device_runs_expected": reps, "graph_ms": graph,
                "kernels": kernels,
                "sm_clock_mhz_around_ms_device_graph": clocks,
                "library_ms": cs.time_ms(lib_call, reps=reps),
                "library_device_ms": lib["ms"],
                "library_graph_ms": cs.graph_ms(lib_call, calls)}

    def emit(**fields):
        flops, ms = fields["flops"], fields["device_ms"]
        print(json.dumps({
            "tool": "grouped_matmul_times", "label": args.label,
            "src": args.src, **fields,
            "device_TFLOPs": flops / (ms * 1e-3) / 1e12 if ms else None,
            "graph_TFLOPs": flops / (fields["graph_ms"] * 1e-3) / 1e12,
            "card": card}), flush=True)

    for case, e, m, k, n in SHAPES:
        x, w = cs.expert_inputs(gen, e, m, k, n, torch.bfloat16)
        err = cs.row_rel_err(gm.grouped_matmul(x, w),
                             gm.grouped_matmul_ref(x, w))
        n_bytes = 2 * (x.numel() + w.numel() + e * m * n)
        emit(kernel="grouped_matmul", case=case, x=list(x.shape),
             w=list(w.shape), max_row_rel_err_vs_plain=err,
             **measure(lambda: gm.grouped_matmul(x, w),
                       lambda: torch.bmm(x, w), m > 2),
             library="torch.bmm (bf16)",
             **cs.gmm_cost(2 * e * m * k * n, n_bytes, x.dtype))
        del x, w
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
        del got, want
        kept = int(inside.sum())
        owners = int(torch.unique(owner[inside]).numel())
        offs = torch.cumsum(gs, 0).to(torch.int32)
        n_bytes = 2 * (x.numel() + owners * D_MODEL * D_EXPERT
                       + T * D_EXPERT)
        emit(kernel="ragged_grouped_matmul", case=case, x=list(x.shape),
             w=list(w.shape), block_m=BLOCK_M, group_sizes=gs.tolist(),
             rows_kept=kept, max_row_rel_err_vs_plain=err,
             masked_rows_zero=masked_zero,
             **measure(lambda: gm.ragged_grouped_matmul(x, w, gs, BLOCK_M),
                       lambda: torch._grouped_mm(x, w, offs=offs), True),
             library="torch._grouped_mm(offs=cumsum(group_sizes))",
             **cs.gmm_cost(2 * kept * D_MODEL * D_EXPERT, n_bytes,
                           x.dtype))
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"tool": "grouped_matmul_times", "label": args.label,
                      "src": args.src,
                      "blocks_per_sm": occupancy(gm),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
