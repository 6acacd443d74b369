#!/usr/bin/env python3
"""Time of the port's segment reductions at the sim path's four shapes,
for the package of a given checkout, beside ``index_add_`` and
``scatter_reduce_``.

Usage (on a machine with a CUDA card):

    python3 tools/segment_times.py [--src DIR] [--label NAME]

``repro_torch`` is imported from DIR (default: this checkout's ``src``),
so one command can time two commits' kernels on one card by the same
rules, those of ``chip_smoke.py``.  The shapes are ``phase_kernels``'s:
the mphx-4p-86x9 uniform incidence (2,177,262 entries), summed and
min'd edge-major (71,982 used edges, through the plan's permutation)
and flow-major (598,302 flows, presorted).  For each, one JSON line
with: CUDA events around back-to-back calls (the Python wrapper
included; the kernel's and the library call's samples taken in turns),
``torch.profiler``'s device time per call (``device_time``) and 20 calls
in one CUDA graph (``graph_ms``), each beside the library call's; the
SM clock (``nvidia-smi``) before and after; the plan's ``lanes`` (32,
one warp a segment, for a package without them); whether the sums, of
the call's values and of uniform random ones, equal this checkout's
ordered twin (``ref.segment_sum_ordered_ref``) at the plan's lanes and
at 32, bit for bit, and the mins the plain version exactly; and the
wrapper's host time per call, split into its parts, each timed alone
by the host clock over back-to-back calls: the input checks,
``torch.empty`` and ``new_empty``, the two ways to find the current
stream (a ``torch.cuda.Stream`` object's ``cuda_stream``, and
``torch._C._cuda_getCurrentRawStream``), the ``torch.cuda.device``
context manager, the bare ctypes launch with its arguments already
computed, and the same call refused at the entry point's first check
(0 segments), which is ctypes alone.  Then ``chip_smoke.py``'s sim main
path (``--suite sim`` on mphx-4p-86x9) five times through the kernels:
each run's wall and the launches of the last.  For a package whose plans
carry lanes, a sweep of the lanes at the flow-major shape follows, one
line per (kernel, lanes).  A package's own build directory
(``DIR/../build``) holds its compiled kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from rmsnorm_times import host_us, paired_ms  # noqa: E402

TOPO = "mphx-4p-86x9"
# (kernel, call site) in phase_kernels's order
SHAPES = [("segment_sum", "edge"), ("segment_sum", "flow"),
          ("segment_min", "flow"), ("segment_min", "edge")]
SWEEP_LANES = (1, 2, 4, 8, 16, 32)
SIM_RUNS = 5
ENTRY = {"segment_sum": "segment_sum_f64", "segment_min": "segment_min_f64"}


def this_checkout_ref():
    """This checkout's ``segment_fairshare/ref.py`` (it imports only
    torch), whatever package ``--src`` names: the twin it holds is the
    yardstick for both."""
    path = (ROOT / "src" / "repro_torch" / "kernels" / "segment_fairshare"
            / "ref.py")
    spec = importlib.util.spec_from_file_location("segment_ref_here", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wrapper_parts(ops):
    """``(checks, lanes, args)`` of the package's wrapper: its input
    checks as one call, a plan's lanes, and ``args(values, plan, n_seg,
    out, dev)``, the entry point's arguments for one call, computed
    ahead."""
    def args(values, plan, n_seg, out, dev):
        return (*_pointers(values, plan), n_seg, plan.lanes, dev,
                out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    return ops.check_inputs, (lambda plan: plan.lanes), args


def _pointers(values, plan) -> tuple:
    return (values.data_ptr(),
            None if plan.perm is None else plan.perm.data_ptr(),
            plan.offsets.data_ptr())


def _parts_before_lanes(ops):
    """The same for a package from before plans had lanes, kept so that
    its times can be taken again beside a newer one's: one warp a
    segment, a six-argument entry point, and checks split between
    ``ops._check`` and the launch, replayed here in its order."""
    def checks(values, ids, n_seg, plan):
        ops._check(values, ids, n_seg, plan)
        if values.device.type != "cuda":
            raise ValueError("device")
        if not values.is_contiguous():
            raise ValueError("contiguous")
        for t in (plan.offsets, plan.perm):
            if t is not None and (t.device != values.device
                                  or t.dtype != torch.int32
                                  or not t.is_contiguous()):
                raise ValueError("plan")

    def args(values, plan, n_seg, out, dev):
        return (*_pointers(values, plan), n_seg, out.data_ptr(),
                torch._C._cuda_getCurrentRawStream(dev))
    return checks, (lambda plan: 32), args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default="", help="tag of every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.netsim import make_router
    from repro_torch.core.routing_vec import uniform_demands
    from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES
    from repro_torch.kernels.segment_fairshare import ops
    from repro_torch.sim.fairshare import SolveProblem, flow_incidence

    twin = this_checkout_ref().segment_sum_ordered_ref
    card = cs.nvidia_smi_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    idx = dev.index
    topo = SWEEP_TOPOLOGIES[TOPO]
    inc = flow_incidence(make_router(topo, device=dev),
                         uniform_demands(topo, topo.nic_bw_gbps, device=dev))
    prob = SolveProblem.build(inc, "cuda")
    columns = {"edge": (prob.edge, prob.n_edges, prob.edge_plan, True),
               "flow": (inc.flow, inc.n_flows, prob.flow_plan, False)}
    inputs = {"segment_sum": inc.frac,
              "segment_min": inc.capacity[inc.edge] / inc.frac}
    rand = torch.rand(inc.nnz, dtype=torch.float64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    before_lanes = not hasattr(ops, "lanes_for")
    checks, lanes_of, launch_args = (_parts_before_lanes(ops) if before_lanes
                                     else wrapper_parts(ops))
    ops.LIBRARY.load()
    torch.cuda.synchronize()

    def emit(**fields):
        print(json.dumps({"tool": "segment_times", "label": args.label,
                          "src": args.src, "case": f"{TOPO} uniform",
                          **fields, "card": card}), flush=True)

    def verdict(name, vals, ids, n_seg, plan) -> dict:
        got = getattr(ops, name)(vals, ids, n_seg, plan=plan)
        again = getattr(ops, name)(vals, ids, n_seg, plan=plan)
        want = getattr(ops, f"{name}_ref")(vals, ids, n_seg)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two runs differ")
        both_inf = torch.isinf(got) & (got == want)
        err = float(torch.where(both_inf, 0.0, (got - want).abs()).max())
        lanes = lanes_of(plan)
        if name == "segment_min":
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: differs from plain version")
            return {"lanes": lanes, "max_abs_err": err, "equals_plain": True}
        tol = 1e-12 * float(vals.abs().max()) * vals.numel()
        if err > tol:
            raise AssertionError(f"{name}: max abs err {err} > {tol}")
        # the bits on the call's values, and on uniform random ones (the
        # incidence's fractions here are 0.5 and 1.0, which every order
        # adds exactly)
        rand_got = getattr(ops, name)(rand, ids, n_seg, plan=plan)
        return {"lanes": lanes, "max_abs_err": err,
                "equals_twin": torch.equal(got, twin(vals, plan, lanes)),
                "equals_twin_lanes_32": torch.equal(got,
                                                    twin(vals, plan, 32)),
                "random_equals_twin": torch.equal(
                    rand_got, twin(rand, plan, lanes)),
                "random_equals_twin_lanes_32": torch.equal(
                    rand_got, twin(rand, plan, 32))}

    def library(name, vals, ids, out):
        if name == "segment_sum":
            return "index_add_", lambda: out.zero_().index_add_(0, ids, vals)
        return "scatter_reduce_(amin)", lambda: out.fill_(
            math.inf).scatter_reduce_(0, ids, vals, "amin")

    for name, site in SHAPES:
        vals = inputs[name]
        ids, n_seg, plan, permuted = columns[site]
        out = torch.empty(n_seg, dtype=torch.float64, device=dev)
        lib_name, lib_call = library(name, vals, ids, out)
        kern = getattr(ops, name)

        def call():
            kern(vals, ids, n_seg, plan=plan)

        checked = verdict(name, vals, ids, n_seg, plan)
        clock_before = cs.sm_clock_mhz()
        ms, library_ms = paired_ms(call, lib_call)
        timed = {"ms": ms, "library_ms": library_ms,
                 "device_ms": cs.device_time(
                     call, "segment_reduce_kernel")["ms"],
                 "library_device_ms": cs.device_time(lib_call, "")["ms"],
                 "graph_ms": cs.graph_ms(call),
                 "library_graph_ms": cs.graph_ms(lib_call)}
        clock_after = cs.sm_clock_mhz()

        fn = ops.LIBRARY.functions[ENTRY[name]]
        fargs = launch_args(vals, plan, n_seg, out, idx)
        nargs = fargs[:3] + (0,) + fargs[4:]   # 0 segments: refused
        host = {
            "wrapper": host_us(call),
            "library_call": host_us(lib_call),
            "checks": host_us(lambda: checks(vals, ids, n_seg, plan)),
            "torch_empty": host_us(lambda: torch.empty(
                n_seg, dtype=torch.float64, device=dev)),
            "new_empty": host_us(lambda: vals.new_empty(n_seg)),
            "stream_object": host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "stream_raw": host_us(
                lambda: torch._C._cuda_getCurrentRawStream(idx)),
            "device_context": host_us(_device_context(dev)),
            "bare_launch": host_us(lambda: fn(*fargs)),
            # the entry point refusing 0 segments at its first check:
            # ctypes and its argument conversion alone
            "ctypes_only": host_us(lambda: fn(*nargs)),
        }
        emit(kernel=name, site=site, nnz=vals.numel(), segments=n_seg,
             permuted=permuted, **checked, **timed, library=lib_name,
             sm_clock_mhz_before=clock_before,
             sm_clock_mhz_after=clock_after, host_us=host,
             **cs.bound(vals.numel(), n_seg, permuted))

    # the sim through these kernels: chip_smoke.py's main path (its
    # warm-up first), timed by the host clock, with the launches of the
    # last run
    cs.run_suite("cuda", "mphx-2p-8x8", "segment_times_warmup")
    walls = []
    for _ in range(SIM_RUNS):
        ops.reset_launch_counts()
        walls.append(cs.run_suite("cuda", TOPO, "segment_times")[1])
    emit(kernel="sim", suite="--suite sim", scenarios=cs.MAIN_SCENARIOS,
         loads=list(cs.MAIN_LOADS), suite_wall_s=walls,
         launches=dict(ops.LAUNCHES))

    if before_lanes:   # no lanes to sweep
        return 0
    # the lanes at the flow-major shape, each forced through the plan
    ids, n_seg, plan, permuted = columns["flow"]
    for name in ("segment_sum", "segment_min"):
        vals = inputs[name]
        kern = getattr(ops, name)
        for lanes in SWEEP_LANES:
            forced = dataclasses.replace(plan, lanes=lanes)

            def call():
                kern(vals, ids, n_seg, plan=forced)

            checked = verdict(name, vals, ids, n_seg, forced)
            clock_before = cs.sm_clock_mhz()
            emit(kernel=name, site="flow", sweep=True, **checked,
                 ms=cs.time_ms(call),
                 device_ms=cs.device_time(call,
                                          "segment_reduce_kernel")["ms"],
                 graph_ms=cs.graph_ms(call),
                 sm_clock_mhz_before=clock_before,
                 sm_clock_mhz_after=cs.sm_clock_mhz())
    return 0


def _device_context(dev):
    def enter_exit():
        with torch.cuda.device(dev):
            pass
    return enter_exit


if __name__ == "__main__":
    sys.exit(main())
