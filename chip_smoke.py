#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the exit code is
nonzero:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``: nvcc builds the three kernel libraries from ``src/``
   (segment reduce, RMSNorm, flash attention), one nvcc each, all started
   together, with each kernel's registers and spills.
3. ``kernel``: the segment kernels against their plain PyTorch versions
   on the card, at edge-case sizes and at the sim path's shapes
   (mphx-4p-86x9 uniform: the incidence's edge and flow columns), twice
   for bitwise repeatability, with their time, the time of the plain
   version and of the one PyTorch call that computes the same function,
   and their bound.
4. ``main_path``: ``--suite sim`` on mphx-4p-86x9 (uniform and
   neighbor_shift, loads 0.5 and 0.9) through the hand-written kernels,
   with the launch counts read around that run alone; then again with
   the plain versions on the card; every row must agree at 1e-9
   relative, integers exactly.
5. ``golden``: the mphx-2p-8x8 cells and the staggered trace of
   ``tests/golden/fairshare_golden.json`` on the card, with the exact
   epoch count.
6. ``model_kernel``: RMSNorm and flash attention against their plain
   versions (edge cases: ragged sizes, decode, GQA and MQA, a window, a
   ring cache with empty and wrapped slots, float32 and bfloat16), at
   the serve path's shapes (float32 at 2e-5; bfloat16, and for
   attention each output row within 2e-2 of its max), twice for bitwise
   repeatability, with the same times and bounds as phase 3.
7. ``serve``: yi-9b at full width and depth (random bf16 weights drawn
   on the card from a seed) serves 8 requests of 1,024 prompt tokens and
   32 new tokens each in waves of 4 through the kernels, with the launch
   counts read around that run alone (97 RMSNorm and 48 attention
   launches per forward pass); then the same requests on the plain path.
   Prefill and teacher-forced decode logits of the two paths must agree,
   and a float32 2-layer yi-9b must agree at 2e-5; a decode wave is
   profiled for the device's idle share.
8. A ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "repro_torch" / "chip_smoke"
GOLDEN = ROOT / "tests" / "golden" / "fairshare_golden.json"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float64 and float32
# outside the tensor cores, bf16 on the tensor cores (dense).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

MAIN_TOPO = "mphx-4p-86x9"
MAIN_SCENARIOS = ["uniform", "neighbor_shift"]
MAIN_LOADS = (0.5, 0.9)
# wall clocks, and the size of round-off (each row's agrees_1e-6 flag
# holds that one to its bound)
UNCOMPARED_KEYS = ("sim_wall_s", "max_abs_util_diff")

KERNELS = {
    "segment_sum": "src/repro/kernels/segment_fairshare/kernel.py:97",
    "segment_min": "src/repro/kernels/segment_fairshare/kernel.py:107",
}
SOURCE = "src/repro_torch/kernels/segment_fairshare/csrc/segment_reduce.cu"
MODEL_KERNELS = {
    "rmsnorm": ("src/repro/kernels/rmsnorm/kernel.py:25",
                "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"),
    "flash_attention": (
        "src/repro/kernels/flash_attention/kernel.py:97",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
}
# the serve path: yi-9b, 8 requests of 1,024 tokens, 32 new, waves of 4
SERVE_ARCH = "yi-9b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_BATCH = 8, 1024, 32, 4
SERVE_SEED = 0
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_NEW + 1
# logits of the kernel path vs the plain path, as max |diff| / max |logit|:
# bf16 at tests/test_kernels.py's 5e-2, float32 at its 2e-5
SERVE_TOL = {"bfloat16": 5e-2, "float32": 2e-5}
# bf16 attention at the serve path's shapes, per output row (one query
# head's Dh values): max |kernel - plain| within this share of the row's
# max |plain|.  The kernel keeps the softmax weights in fp32 where the
# plain version rounds them to bf16 before the PV product; the two then
# differ by one bf16 ulp of the row's max (2^-7 of it on an NVIDIA H100
# 80GB HBM3 at 700 W), and 2e-2 leaves 2.5 times that.
ATTN_ROW_TOL_BF16 = 2e-2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, samples: int = 7) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events (after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        per_call.append(t0.elapsed_time(t1) / reps)
    return statistics.median(per_call)


def device_ms(fn, kernel_name: str, reps: int = 20) -> "float | None":
    """Mean device time per call of the kernels whose name contains
    ``kernel_name`` (all kernels for ""), from ``torch.profiler``; None
    when the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(t for name, _, t in device_events(prof)
                if kernel_name in name)
    return total / reps / 1e3 if total > 0 else None


def device_events(prof) -> "list[tuple[str, int, float]]":
    """(name, count, total microseconds) of the work the profiler saw on
    the device (kernels, copies, fills), longest first."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
                  key=lambda k: -k[2])


def bound(nnz: int, n_seg: int, permuted: bool) -> dict:
    """Least time for one segment reduction: each value (8 B), each
    permutation entry (4 B), each CSR offset (4 B) read once and each
    output (8 B) written once, or one float64 operation per entry."""
    n_bytes = 8 * nnz + (4 * nnz if permuted else 0) + 4 * (n_seg + 1) \
        + 8 * n_seg
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = nnz / PEAK_FP64_PER_S
    return {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_kernel(name: str, vals, ids, n_seg: int, plan=None) -> float:
    """Kernel vs plain version on the card; returns the max abs error.
    Sum: within 1e-12 * max|v| * NNZ.  Min: exact.  Two runs: same bits."""
    from repro_torch.kernels import segment_fairshare as sf

    kern = getattr(sf, name)
    ref = getattr(sf, f"{name}_ref")
    got = kern(vals, ids, n_seg, plan=plan)
    again = kern(vals, ids, n_seg, plan=plan)
    want = ref(vals, ids, n_seg)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs differ (nnz={vals.numel()})")
    if got.shape != (n_seg,):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {n_seg}")
    both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
    diff = torch.where(both_inf, 0.0, (got - want).abs())
    err = float(diff.max()) if n_seg else 0.0
    if name == "segment_min":
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: differs from plain version "
                                 f"(max abs err {err})")
    else:
        vmax = float(vals.abs().max()) if vals.numel() else 0.0
        tol = 1e-12 * vmax * vals.numel()
        if err > tol:
            raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def phase_kernels() -> dict:
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_vec import uniform_demands
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.kernels.segment_fairshare import (make_plan,
                                                       segment_min_ref,
                                                       segment_sum_ref)
    from repro_torch.kernels.segment_fairshare import ops
    from repro_torch.sim.fairshare import SolveProblem, flow_incidence

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # edge cases: (nnz, segments, id range low, id range high)
    cases = [(0, 5, 0, 5), (1, 1, 0, 1), (1, 3, 0, 3), (1000, 37, 0, 37),
             (1025, 2000, 0, 2000), (3000, 1, 0, 1), (4097, 64, 0, 67),
             (10, 0, 0, 1)]
    for nnz, n_seg, lo, hi in cases:
        vals = torch.randn(nnz, dtype=torch.float64, device=dev,
                           generator=gen)
        ids = torch.randint(lo, hi, (nnz,), device=dev, generator=gen)
        for name in KERNELS:
            err = check_kernel(name, vals, ids, n_seg)
            srt = torch.sort(ids).values
            check_kernel(name, vals, srt, n_seg,
                         plan=make_plan(srt, n_seg, presorted=True))
            emit("kernel", kernel=name, case="edge", nnz=nnz, segments=n_seg,
                 max_abs_err=err, ok=True)

    # the main path's shapes: mphx-4p-86x9 uniform incidence
    topo = SWEEP_TOPOLOGIES[MAIN_TOPO]
    router = make_router(topo, device=dev)
    inc = flow_incidence(router, uniform_demands(topo, topo.nic_bw_gbps,
                                                 device=dev))
    prob = SolveProblem.build(inc, "cuda")
    nnz, E, F = inc.nnz, prob.n_edges, inc.n_flows
    rand = torch.rand(nnz, dtype=torch.float64, device=dev, generator=gen)
    bneck_vals = inc.capacity[inc.edge] / inc.frac
    edge = (prob.edge, E, prob.edge_plan, True)
    flow = (inc.flow, F, prob.flow_plan, False)
    # (kernel, call site, values, (ids, segments, plan, permuted)); the
    # first shape of each kernel is the one its summary line reports
    shapes = [
        # per-edge live weight of a water-filling round, and the epoch's
        # edge bytes: edge-major, through the permutation
        ("segment_sum", "edge", inc.frac, edge),
        # per-flow saturated share of a round, and switch hops: flow-major
        ("segment_sum", "flow", inc.frac, flow),
        # per-flow bottleneck (FlowIncidence.bottleneck_gbps): flow-major
        ("segment_min", "flow", bneck_vals, flow),
        ("segment_min", "edge", bneck_vals, edge),
    ]
    refs = {"segment_sum": segment_sum_ref, "segment_min": segment_min_ref}
    results = {}
    for name, site, vals, (ids, n_seg, plan, permuted) in shapes:
        err = check_kernel(name, vals, ids, n_seg, plan)
        check_kernel(name, rand, ids, n_seg, plan)
        kern, ref = getattr(ops, name), refs[name]
        out = torch.empty(n_seg, dtype=torch.float64, device=dev)
        if name == "segment_sum":
            library = "index_add_"

            def lib_call():
                out.zero_().index_add_(0, ids, vals)
        else:
            library = "scatter_reduce_(amin)"

            def lib_call():
                out.fill_(math.inf).scatter_reduce_(0, ids, vals, "amin")

        def call():
            kern(vals, ids, n_seg, plan=plan)

        ms = time_ms(call)
        plain_ms = time_ms(lambda: ref(vals, ids, n_seg))
        lib_ms = time_ms(lib_call)
        b = bound(nnz, n_seg, permuted)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, **b}
        results.setdefault(name, row)
        emit("kernel", kernel=name, case=f"{MAIN_TOPO} uniform", site=site,
             nnz=nnz, segments=n_seg, permuted=permuted, max_abs_err=err,
             ms=ms, plain_ms=plain_ms, library=library, library_ms=lib_ms,
             kernel_device_ms=device_ms(call, "segment_reduce_kernel"),
             library_device_ms=device_ms(lib_call, ""),
             bytes=b["bytes"], bound_ms=b["bound_ms"], bound_by=b["bound_by"],
             achieved_GBps=b["bytes"] / (ms * 1e-3) / 1e9, ok=True)
    return results


def compare_rows(a: dict, b: dict, where: str) -> None:
    """Every key of ``a`` but ``UNCOMPARED_KEYS``: ints and strings
    exact, floats at 1e-9 relative."""
    for k, v in a.items():
        if k in UNCOMPARED_KEYS:
            continue
        w = b.get(k)
        if isinstance(v, float) and isinstance(w, float):
            if abs(v - w) > 1e-9 * max(abs(v), abs(w)):
                raise AssertionError(f"{where}: {k} {v} != {w}")
        elif v != w:
            raise AssertionError(f"{where}: {k} {v!r} != {w!r}")


def run_suite(backend: str, topo: str, out: str) -> "tuple[dict, float]":
    from repro_torch.experiments.simsuite import run_sim_suite

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = run_sim_suite(str(OUT_DIR / out), topo_names=[topo],
                            scenario_names=MAIN_SCENARIOS,
                            load_fractions=MAIN_LOADS, sim_backend=backend,
                            device="cuda")
    torch.cuda.synchronize()
    return payload, time.perf_counter() - t0


def phase_main_path() -> dict:
    from repro_torch.kernels.segment_fairshare import (LAUNCHES,
                                                       reset_launch_counts)

    # a small run first, so that neither timed run pays the first use of
    # torch's own kernels
    run_suite("cuda", "mphx-2p-8x8", "warmup")
    reset_launch_counts()
    runs = {"cuda": run_suite("cuda", MAIN_TOPO, "cuda")}
    launches = dict(LAUNCHES)
    runs["torch"] = run_suite("torch", MAIN_TOPO, "torch")
    for backend, (payload, wall) in runs.items():
        for r in payload["rows"]:
            if r.get("kind") != "fct":
                continue
            emit("main_path", backend=backend, scenario=r["scenario"],
                 offered_fraction=r["offered_fraction"],
                 flows=r["sim_flows"], nnz=r["sim_nnz"],
                 epochs=r["sim_epochs"],
                 waterfill_rounds=r["sim_waterfill_rounds"],
                 fct_p50_us=r["fct_p50_us"], fct_p99_us=r["fct_p99_us"],
                 slowdown_p99=r["slowdown_p99"],
                 sim_wall_s=r["sim_wall_s"])
        emit("main_path", backend=backend, suite_wall_s=wall,
             device_name=payload["params"]["device_name"])
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    if not runs["cuda"][0]["params"]["all_steady_checks_agree_1e-6"]:
        raise AssertionError("steady-state loads diverge from the analytic "
                             "engine")
    rows = {b: [r for r in p["rows"] if r.get("kind") in ("fct",
                                                         "steady_check")]
            for b, (p, _) in runs.items()}
    if len(rows["cuda"]) != len(MAIN_SCENARIOS) * (1 + len(MAIN_LOADS)):
        raise AssertionError(f"unexpected row count {len(rows['cuda'])}")
    for a, b in zip(rows["cuda"], rows["torch"]):
        compare_rows(a, b, f"{a['scenario']}/{a['kind']}")
        for k, v in a.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{a['scenario']}: {k} = {v}")
    emit("main_path", launches=launches, rows_agree=True, ok=True)

    # where the time goes: the same run once more under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = run_suite("cuda", MAIN_TOPO, "profiled")
    kernels = device_events(prof)
    busy_ms = sum(k[2] for k in kernels) / 1e3
    emit("main_path", profiled_wall_s=wall, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / (wall * 1e3),
         top_device_ops=[{"name": n[:80], "count": c, "ms": t / 1e3}
                         for n, c, t in kernels[:10]])
    return launches


def phase_golden() -> None:
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_vec import (neighbor_shift_demands,
                                              uniform_demands)
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.sim.events import simulate_demands, simulate_incidence
    from repro_torch.sim.fairshare import flow_incidence, max_min_rates

    fixture = json.loads(GOLDEN.read_text())
    topo = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    router = make_router(topo, device="cuda")
    builders = {"uniform": uniform_demands,
                "neighbor_shift": neighbor_shift_demands}
    for scen, build in builders.items():
        cell = fixture["cells"][f"array/mphx-2p-8x8/{scen}"]
        for load_key, want in cell["loads"].items():
            dem = build(topo, float(load_key) * topo.nic_bw_gbps,
                        device="cuda")
            inc = flow_incidence(router, dem)
            assert (inc.n_flows, inc.n_edges, inc.nnz) == (
                want["n_flows"], want["n_edges"], want["nnz"])
            caps = dem.gbps
            scale = max(float(caps.max()), 1.0)
            rates = max_min_rates(inc, caps, backend="cuda",
                                  device="cuda").cpu().numpy()
            err = float(np.abs(rates - np.asarray(want["rates_gbps"])).max())
            if err > 1e-9 * scale:
                raise AssertionError(f"{scen}@{load_key}: rates err {err}")
            loads = inc.loads(rates, "cuda").cpu().numpy()
            golden = np.zeros(inc.n_edges)
            for e, v in want["link_loads_gbps_nonzero"].items():
                golden[int(e)] = v
            lerr = float(np.abs(loads - golden).max())
            if lerr > 1e-9 * scale:
                raise AssertionError(f"{scen}@{load_key}: loads err {lerr}")
            row = simulate_demands(router, dem, fixture["flow_time_s"],
                                   backend="cuda", inc=inc)
            for k, v in want["fct"].items():
                got = row[k]
                if isinstance(v, float) and v != 0:
                    if abs(got - v) > 1e-9 * abs(v) + 1e-12:
                        raise AssertionError(f"{scen}@{load_key}: {k} "
                                             f"{got} != {v}")
                elif got != v:
                    raise AssertionError(f"{scen}@{load_key}: {k} "
                                         f"{got} != {v}")
            emit("golden", cell=f"mphx-2p-8x8/{scen}", load=load_key,
                 rates_max_abs_err=err, loads_max_abs_err=lerr,
                 epochs=row["sim_epochs"], ok=True)
    rec = fixture["staggered"]
    inc = flow_incidence(router, neighbor_shift_demands(topo, 800.0,
                                                        device="cuda"))
    res = simulate_incidence(inc, rec["size_bytes"], rec["rate_caps_gbps"],
                             start_s=rec["start_s"], backend="cuda",
                             device="cuda")
    makespan = rec["makespan_s"]
    if res.n_epochs != rec["n_epochs"]:
        raise AssertionError(f"staggered: {res.n_epochs} epochs != "
                             f"{rec['n_epochs']}")
    ferr = float(np.abs(res.finish_s.cpu().numpy()
                        - np.asarray(rec["finish_s"])).max())
    cerr = float(np.abs(res.fct_s.cpu().numpy()
                        - np.asarray(rec["fct_s"])).max())
    if max(ferr, cerr, abs(res.makespan_s - makespan)) > 1e-9 * makespan:
        raise AssertionError(f"staggered: finish err {ferr}, fct err {cerr}")
    golden_bytes = np.zeros(inc.n_edges)
    for e, v in rec["edge_bytes_nonzero"].items():
        golden_bytes[int(e)] = v
    size_sum = float(np.sum(rec["size_bytes"]))
    berr = np.abs(res.edge_bytes.cpu().numpy() - golden_bytes)
    if np.any(berr > 1e-9 * np.abs(golden_bytes) + 1e-9 * size_sum):
        raise AssertionError(f"staggered: edge bytes err {berr.max()}")
    emit("golden", cell="staggered mphx-2p-8x8/neighbor_shift",
         epochs=res.n_epochs, finish_max_abs_err=ferr, ok=True)


def phase_build() -> None:
    """nvcc for the three libraries at once (one process each)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention.ops import LIBRARY as attn_lib
    from repro_torch.kernels.rmsnorm.ops import LIBRARY as norm_lib
    from repro_torch.kernels.segment_fairshare.ops import LIBRARY as seg_lib

    def build(lib):
        t0 = time.perf_counter()
        path, log = lib.build()
        return lib, path, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        built = list(pool.map(build, (seg_lib, norm_lib, attn_lib)))
    wall = time.perf_counter() - t0
    for lib, path, log, seconds in built:
        lib.load()
        emit("build", library=os.path.relpath(path, ROOT), seconds=seconds,
             ptxas=[l.strip() for l in log.splitlines()
                    if "Compiling entry" in l or "registers" in l
                    or "spill" in l])
    emit("build", parallel_wall_s=wall, ok=True)


def check_close(name: str, got, again, want, tol: float,
                where: str) -> float:
    """Kernel vs plain version: within ``tol`` absolute and relative (the
    dtype's tolerance), the same shape and dtype, two kernel runs the same
    bits.  Returns the max abs error."""
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {where}: two runs differ")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {where}: {tuple(got.shape)} "
                             f"{got.dtype} != {tuple(want.shape)} "
                             f"{want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name} {where}: non-finite output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
        raise AssertionError(f"{name} {where}: max abs err {err} beyond "
                             f"{tol} abs + {tol} rel")
    return err


def row_rel_err(got, want) -> float:
    """max over the last axis's rows of max |got - want| / max |want|."""
    g, w = got.float(), want.float()
    gap = (g - w).abs().amax(dim=-1)
    top = w.abs().amax(dim=-1)
    if bool((gap > 0).logical_and(top == 0).any()):
        return math.inf
    return float((gap / top.clamp_min(torch.finfo(torch.float32).tiny))
                 .max())


def ring_kv_pos(cap: int, written: int, device) -> torch.Tensor:
    """kv_pos of a ring cache after positions 0..written-1: -1 = empty."""
    kv_pos = torch.full((cap,), -1, dtype=torch.int32)
    for p in range(written):
        kv_pos[p % cap] = p
    return kv_pos.to(device)


def attention_inputs(gen, B, Sq, K, G, Skv, Dh, dtype):
    """q (B,Sq,K,G,Dh), k and v (B,Skv,K,Dh), standard normal."""
    dev = torch.device("cuda")
    q = torch.randn(B, Sq, K, G, Dh, device=dev, generator=gen).to(dtype)
    kv = [torch.randn(B, Skv, K, Dh, device=dev, generator=gen).to(dtype)
          for _ in range(2)]
    return q, kv[0], kv[1]


def attention_cost(q, k, q_pos, kv_pos, causal, window) -> dict:
    """Least time for one attention call: q, o and the attended keys'
    k and v moved once, or 4*Dh operations per attended (query head,
    key) pair on the bf16 tensor cores (float32 outside them)."""
    from repro_torch.kernels.flash_attention import attention_mask

    B, Sq, K, G, Dh = q.shape
    mask = attention_mask(q_pos, kv_pos, causal, window)
    pairs = int(mask.sum())
    keys = int(mask.any(dim=0).sum())
    elt = q.element_size()
    n_bytes = 2 * q.numel() * elt + 2 * B * keys * K * Dh * elt \
        + 4 * (q_pos.numel() + kv_pos.numel())
    ops = 4 * Dh * B * K * G * pairs
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_FP32_PER_S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / peak
    return {"bytes": n_bytes, "flops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rmsnorm_cost(x, scale) -> dict:
    """Least time for one RMSNorm: x read and written once, the scale
    read once, or 4 float32 operations per element outside the tensor
    cores."""
    n_bytes = 2 * x.numel() * x.element_size() \
        + scale.numel() * scale.element_size()
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = 4 * x.numel() / PEAK_FP32_PER_S
    return {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_model_kernels() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = (torch.float32, torch.bfloat16)

    # RMSNorm edge cases: (N, D), ragged and misaligned rows
    for n, d in [(1, 16), (7, 64), (5, 13), (33, 1000), (9, 8192)]:
        for dt in dtypes:
            x = torch.randn(n, d, device=dev, generator=gen).to(dt)
            s = torch.randn(d, device=dev, generator=gen).to(dt)
            err = check_close("rmsnorm", rn.rmsnorm(x, s, 1e-6),
                              rn.rmsnorm(x, s, 1e-6),
                              rn.rmsnorm_ref(x, s, 1e-6), tol[dt],
                              f"({n}, {d}) {dt}")
            emit("model_kernel", kernel="rmsnorm", case="edge",
                 shape=[n, d], dtype=str(dt), max_abs_err=err, ok=True)

    # rows of a wider buffer (the prefill's last position), with and
    # without 16-byte vector loads
    for pad in (8, 3):
        x = torch.randn(4, 4096 + pad, device=dev, generator=gen).to(
            torch.bfloat16)[:, :4096]
        s = torch.randn(4096, device=dev, generator=gen).to(torch.bfloat16)
        err = check_close("rmsnorm", rn.rmsnorm(x, s, 1e-6),
                          rn.rmsnorm(x, s, 1e-6), rn.rmsnorm_ref(x, s, 1e-6),
                          tol[x.dtype], f"strided rows, pad {pad}")
        emit("model_kernel", kernel="rmsnorm", case=f"strided rows +{pad}",
             shape=[4, 4096], dtype="bfloat16", max_abs_err=err, ok=True)

    # attention edge cases: (name, B, Sq, K, G, Skv, Dh, positions, window)
    # positions: None = right-aligned contiguous, else (q_pos, cap, written)
    edge = [("prefill-gqa-ragged", 2, 100, 2, 4, 100, 64, None, None),
            ("prefill-mha-1024-rows", 1, 1030, 2, 1, 1030, 128, None, None),
            ("mqa-window", 2, 80, 1, 8, 80, 16, None, 8),
            ("cross-ragged-dh32", 1, 33, 2, 2, 77, 32, None, None),
            ("decode-ring-empty", 4, 1, 4, 8, 70, 128, ([40], 70, 41), None),
            ("decode-ring-wrapped", 2, 1, 2, 4, 64, 64, ([150], 64, 151),
             16)]
    for name, B, Sq, K, G, Skv, Dh, pos, window in edge:
        for dt in dtypes:
            q, k, v = attention_inputs(gen, B, Sq, K, G, Skv, Dh, dt)
            if pos is None:
                q_pos, kv_pos = fa.right_aligned_positions(Sq, Skv, dev)
            else:
                q_pos = torch.tensor(pos[0], dtype=torch.int32, device=dev)
                kv_pos = ring_kv_pos(pos[1], pos[2], dev)
            args = (q, k, v, q_pos, kv_pos)
            kw = dict(causal=True, window=window)
            err = check_close("flash_attention", fa.flash_attention(*args,
                                                                    **kw),
                              fa.flash_attention(*args, **kw),
                              fa.attention_ref(*args, **kw), tol[dt],
                              f"{name} {dt}")
            emit("model_kernel", kernel="flash_attention", case=name,
                 dtype=str(dt), q=list(q.shape), kv=list(k.shape),
                 window=window, max_abs_err=err, ok=True)

    results = {}
    # the serve path's RMSNorm shapes: prefill rows B*S, decode rows B;
    # float32 at its tolerance, then bf16 (timed)
    for rows in (SERVE_BATCH * SERVE_PROMPT, SERVE_BATCH):
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, 4096, device=dev, generator=gen).to(dt)
            s = torch.randn(4096, device=dev, generator=gen).to(dt)
            errs[dt] = check_close("rmsnorm", rn.rmsnorm(x, s, 1e-6),
                                   rn.rmsnorm(x, s, 1e-6),
                                   rn.rmsnorm_ref(x, s, 1e-6), tol[dt],
                                   f"path ({rows}, 4096) {dt}")
        # x and s are now the bf16 inputs: timed below

        def call():
            rn.rmsnorm(x, s, 1e-6)

        def lib_call():
            F.rms_norm(x, (4096,), weight=s, eps=1e-6)

        row = {"max_abs_err": errs[torch.bfloat16], "ms": time_ms(call),
               "plain_ms": time_ms(lambda: rn.rmsnorm_ref(x, s, 1e-6)),
               "library_ms": time_ms(lib_call), **rmsnorm_cost(x, s)}
        results.setdefault("rmsnorm", row)
        emit("model_kernel", kernel="rmsnorm",
             case="prefill" if rows > SERVE_BATCH else "decode",
             shape=[rows, 4096], dtype="bfloat16", **row,
             float32_max_abs_err=errs[torch.float32],
             library="torch.nn.functional.rms_norm",
             kernel_device_ms=device_ms(call, "rmsnorm_kernel"),
             library_device_ms=device_ms(lib_call, ""),
             achieved_GBps=row["bytes"] / (row["ms"] * 1e-3) / 1e9, ok=True)

    # the serve path's attention: prefill over the prompt's own keys (as
    # the reference's prefill), the same queries over a 1,057-slot cache
    # holding the prompt, and a decode step over 1,040 filled slots
    B, K, G, Dh = SERVE_BATCH, 4, 8, 128
    S, cap = SERVE_PROMPT, SERVE_MAX_LEN
    cache_pos = ring_kv_pos(cap, S, dev)
    path = [("prefill", S, S, None, None),
            ("prefill-over-cache", S, cap, None, cache_pos),
            ("decode", 1, cap, [1039], ring_kv_pos(cap, 1040, dev))]
    for name, Sq, Skv, qp, kv_pos in path:
        if kv_pos is None:
            q_pos, kv_pos = fa.right_aligned_positions(Sq, Skv, dev)
        else:
            q_pos = torch.arange(Sq, dtype=torch.int32, device=dev) \
                if qp is None else torch.tensor(qp, dtype=torch.int32,
                                                device=dev)
        # float32 at its tolerance first: no bf16 rounding hides a
        # dropped tile or a wrong mask; then bf16 (timed), held per row
        q, k, v = attention_inputs(gen, B, Sq, K, G, Skv, Dh, torch.float32)
        args = (q, k, v, q_pos, kv_pos)
        err32 = check_close("flash_attention", fa.flash_attention(*args),
                            fa.flash_attention(*args),
                            fa.attention_ref(*args), tol[q.dtype],
                            f"path {name} float32")
        q, k, v = attention_inputs(gen, B, Sq, K, G, Skv, Dh,
                                   torch.bfloat16)
        args = (q, k, v, q_pos, kv_pos)
        got, want = fa.flash_attention(*args), fa.attention_ref(*args)
        err = check_close("flash_attention", got, fa.flash_attention(*args),
                          want, tol[q.dtype], f"path {name}")
        row_err = row_rel_err(got, want)
        if row_err > ATTN_ROW_TOL_BF16:
            raise AssertionError(f"flash_attention path {name}: a row "
                                 f"differs by {row_err} of its max |o| > "
                                 f"{ATTN_ROW_TOL_BF16}")
        del got, want
        # the yardstick: SDPA on (B, H, S, Dh) copies made beforehand
        qs = q.reshape(B, Sq, K * G, Dh).transpose(1, 2).contiguous()
        ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = fa.attention_mask(q_pos, kv_pos, True, None)
        sdpa_kw = dict(is_causal=True) if name == "prefill" else \
            dict(attn_mask=mask)

        def call():
            fa.flash_attention(*args)

        def lib_call():
            return F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True,
                                                  **sdpa_kw)

        lib_err = float((lib_call().transpose(1, 2).reshape(q.shape).float()
                         - fa.attention_ref(*args).float()).abs().max())
        heavy = Sq > 1
        row = {"max_abs_err": err,
               "ms": time_ms(call, reps=5 if heavy else 20),
               "plain_ms": time_ms(lambda: fa.attention_ref(*args),
                                   reps=3 if heavy else 20, samples=3),
               "library_ms": time_ms(lib_call, reps=5 if heavy else 20),
               **attention_cost(q, k, q_pos, kv_pos, True, None)}
        results.setdefault("flash_attention", row)
        emit("model_kernel", kernel="flash_attention", case=name,
             q=list(q.shape), kv=list(k.shape), dtype="bfloat16", **row,
             max_row_rel_err=row_err, row_tolerance=ATTN_ROW_TOL_BF16,
             float32_max_abs_err=err32, float32_tolerance=tol[torch.float32],
             library="scaled_dot_product_attention(enable_gqa=True, "
                     + ("is_causal=True)" if name == "prefill"
                        else "attn_mask)"),
             library_max_abs_err_vs_plain=lib_err,
             kernel_device_ms=device_ms(call, "flash_attention_kernel",
                                        reps=5),
             library_device_ms=device_ms(lib_call, "", reps=5),
             achieved_TFLOPs=row["flops"] / (row["ms"] * 1e-3) / 1e12,
             ok=True)
    return results


def logits_gap(got, want) -> "tuple[float, float]":
    """max |got - want| and max |want| over finite logits."""
    if not bool(torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite logits")
    return float((got - want).abs().max()), float(want.abs().max())


def teacher_forced(kern, plain, params, prompts, steps: int, tol: float,
                   where: str) -> dict:
    """Prefill and ``steps`` decode steps on both paths, each fed the
    plain path's greedy token, so one near-tie cannot decide the
    comparison.  Every logit within ``tol * max |logit|``."""
    lk, ck = kern.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    lp, cp = plain.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    if lk.shape != (prompts.shape[0], kern.cfg.vocab_size) \
            or lk.dtype != torch.float32:
        raise AssertionError(f"{where}: logits {tuple(lk.shape)} {lk.dtype}")
    gap, top = logits_gap(lk, lp)
    worst = {"prefill_max_abs_diff": gap, "prefill_max_abs_logit": top}
    rel = [gap / top]
    for _ in range(steps):
        tok = torch.argmax(lp, dim=-1)[:, None]
        lk, ck = kern.decode_step(params, tok, ck)
        lp, cp = plain.decode_step(params, tok, cp)
        gap, top = logits_gap(lk, lp)
        rel.append(gap / top)
    worst.update(decode_steps=steps, max_rel_diff=max(rel),
                 prefill_rel_diff=rel[0], decode_max_rel_diff=max(rel[1:]),
                 tolerance=tol)
    if max(rel) > tol:
        raise AssertionError(f"{where}: logits differ by {max(rel)} of "
                             f"max |logit| > {tol}")
    return worst


def phase_serve(card: str) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(SERVE_ARCH)
    kern = get_model(cfg, kernel_backend="cuda")
    plain = get_model(cfg, kernel_backend="torch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = kern.init(SERVE_SEED)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    n_params = kern.param_count()
    emit("serve", card=card, arch=SERVE_ARCH, params=n_params,
         param_dtype=cfg.param_dtype, layers=cfg.n_layers,
         weight_fill_s=fill_s,
         weights_GB=torch.cuda.memory_allocated() / 1e9)

    def serve(model, requests: int, prompt: int, new: int):
        reqs = make_requests(cfg, requests, prompt, new, SERVE_SEED)
        eng = ServeEngine(model, params, max_batch=SERVE_BATCH,
                          max_len=prompt + new + 1, seed=SERVE_SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        return eng.stats, reqs, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated()

    # a short run of each path first: neither timed run pays first use
    serve(kern, 1, 64, 2)
    serve(plain, 1, 64, 2)
    rn.reset_launch_counts()
    fa.reset_launch_counts()
    runs = {"cuda": serve(kern, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW)}
    launches = {"rmsnorm": rn.LAUNCHES["rmsnorm"],
                "flash_attention": fa.LAUNCHES["flash_attention"]}
    runs["torch"] = serve(plain, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW)
    for backend, (stats, reqs, wall, peak) in runs.items():
        if stats.tokens_out != SERVE_REQUESTS * SERVE_NEW or any(
                len(r.output) != SERVE_NEW or not r.done for r in reqs):
            raise AssertionError(f"{backend}: {stats.tokens_out} tokens out")
        emit("serve", card=card, kernel_backend=backend,
             requests=SERVE_REQUESTS,
             prompt_tokens=SERVE_PROMPT, new_tokens=SERVE_NEW,
             max_batch=SERVE_BATCH, waves=stats.waves, wall_s=wall,
             prefill_s=stats.prefill_s, decode_s=stats.decode_s,
             decode_tok_per_s=stats.decode_tok_per_s,
             prefill_tok_per_s=SERVE_REQUESTS * SERVE_PROMPT
             / stats.prefill_s, peak_memory_GB=peak / 1e9)
    # each wave: one prefill, then one decode step per new token (the
    # last step's logits are not sampled, as in the reference's engine)
    passes = runs["cuda"][0].waves * (1 + SERVE_NEW)
    want = {"rmsnorm": passes * (2 * cfg.n_layers + 1),
            "flash_attention": passes * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"serve launches {launches} != {want} "
                             f"({passes} forward passes)")
    same = sum(a == b for r, p in zip(runs["cuda"][1], runs["torch"][1])
               for a, b in zip(r.output, p.output))
    emit("serve", launches=launches, forward_passes=passes,
         launches_per_pass={k: v / passes for k, v in launches.items()},
         tokens_equal_to_plain_path=same,
         tokens_total=SERVE_REQUESTS * SERVE_NEW)

    prompts = torch.as_tensor(np.stack(
        [r.prompt for r in runs["cuda"][1][:SERVE_BATCH]]), device="cuda")
    bf16 = teacher_forced(kern, plain, params, prompts, SERVE_NEW,
                          SERVE_TOL["bfloat16"], "yi-9b bf16")
    emit("serve", check="teacher-forced logits, kernels vs plain",
         dtype="bfloat16", **bf16, ok=True)

    # where the time goes in one decode wave (sampling and the host read
    # of the tokens included, as in the engine)
    _, caches = kern.prefill(params, prompts, max_len=SERVE_MAX_LEN)
    tok = prompts[:, -1:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_NEW):
            logits, caches = kern.decode_step(params, tok, caches)
            tok = torch.argmax(logits, dim=-1)[:, None]
            tok.cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    busy_ms = sum(e[2] for e in events) / 1e3
    emit("serve", card=card, profiled="decode wave", steps=SERVE_NEW,
         wall_s=wall, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / (wall * 1e3),
         top_device_ops=[{"name": n[:80], "count": c, "ms": t / 1e3}
                         for n, c, t in events[:10]])
    del caches, params
    torch.cuda.empty_cache()

    # float32, 2 layers at full width: the kernels without bf16 rounding
    cfg32 = cfg.replace(n_layers=2, param_dtype="float32",
                        activation_dtype="float32")
    kern32 = get_model(cfg32, kernel_backend="cuda")
    params32 = kern32.init(SERVE_SEED)
    f32 = teacher_forced(kern32, get_model(cfg32, kernel_backend="torch"),
                         params32, prompts, 8, SERVE_TOL["float32"],
                         "yi-9b 2-layer float32")
    emit("serve", check="teacher-forced logits, kernels vs plain",
         dtype="float32", layers=2, **f32, ok=True)
    del params32
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch and tests/golden are missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    card = nvidia_smi_line()
    emit("env", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    phase_build()
    kernel_results = phase_kernels()
    launches = phase_main_path()
    phase_golden()
    kernel_results.update(phase_model_kernels())
    launches.update(phase_serve(card))

    sources = {name: (replaces, SOURCE) for name, replaces in KERNELS.items()}
    sources.update(MODEL_KERNELS)
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": kernel_results[name]["max_abs_err"],
                "ms": kernel_results[name]["ms"],
                "plain_ms": kernel_results[name]["plain_ms"],
                "bound_ms": kernel_results[name]["bound_ms"],
                "bound_by": kernel_results[name]["bound_by"],
                "library_ms": kernel_results[name]["library_ms"],
                "ok": True}
               for name, (replaces, source) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
