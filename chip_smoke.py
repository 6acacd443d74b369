#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the exit code
is nonzero:

1. ``env``: the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``: nvcc builds the segment-reduce kernels from ``src/``.
3. ``kernel``: each kernel against its plain PyTorch version on the card,
   at edge-case sizes and at the main path's shapes (mphx-4p-86x9
   uniform: the incidence's edge and flow columns), twice for bitwise
   repeatability, with its time, the time of its plain version and of
   the one PyTorch call that computes the same function, and its bound.
4. ``main_path``: ``--suite sim`` on mphx-4p-86x9 (uniform and
   neighbor_shift, loads 0.5 and 0.9) through the hand-written kernels,
   with the launch counts read around that run alone; then again with
   the plain versions on the card; every row must agree at 1e-9
   relative, integers exactly.
5. ``golden``: the mphx-2p-8x8 cells and the staggered trace of
   ``tests/golden/fairshare_golden.json`` on the card, with the exact
   epoch count.
6. A ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float64 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12

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

    from repro_torch.kernels.segment_fairshare import build

    t0 = time.perf_counter()
    path, log = build.build()
    build.load_library()
    emit("build", seconds=time.perf_counter() - t0,
         library=os.path.relpath(path, ROOT),
         ptxas=[l for l in log.splitlines() if "registers" in l
                or "spill" in l])

    kernel_results = phase_kernels()
    launches = phase_main_path()
    phase_golden()

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": kernel_results[name]["max_abs_err"],
                "ms": kernel_results[name]["ms"],
                "plain_ms": kernel_results[name]["plain_ms"],
                "bound_ms": kernel_results[name]["bound_ms"],
                "bound_by": kernel_results[name]["bound_by"],
                "library_ms": kernel_results[name]["library_ms"],
                "ok": True}
               for name, replaces in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
