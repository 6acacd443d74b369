"""CLI of the port's experiment suites: ``table2`` (the paper's Table 2
joined with the closed-form latency/throughput/all-reduce model), ``sim``
(measured flow-completion times from the event loop, and measured
collectives sprayed over the planes), ``sweep`` (routed
latency/throughput vs offered load in the three routing modes),
``failures`` (degraded fabrics: healthy-vs-degraded throughput and the
recovery curves of the three reroute modes), ``cosim`` (one training
step's collective phases co-simulated on the fabric: measured step time
and tokens/sec per topology) and ``serving`` (serving, training and
background tenants sharing one fabric: per-tenant SLO rows); ``all``
runs them in the reference's order (table2, sweep, sim, cosim, serving,
failures).

Examples::

    PYTHONPATH=src python -m repro_torch.experiments.run --suite table2 \
        --out results/experiments_torch
    PYTHONPATH=src python -m repro_torch.experiments.run --suite sim \
        --trace sim_trace.json --out results/experiments_torch

    PYTHONPATH=src python -m repro_torch.experiments.run --suite sim \
        --topos mphx-4p-86x9 --scenarios uniform neighbor_shift \
        --loads 0.5 0.9 --device cuda --out results/experiments_torch
    PYTHONPATH=src python -m repro_torch.experiments.run --suite sweep \
        --topos mphx-2p-16x16 --modes minimal valiant adaptive \
        --loads 0.5 1.0 --simulate --out results/experiments_torch
    PYTHONPATH=src python -m repro_torch.experiments.run --suite failures \
        --topos mphx-4p-86x9 --failures link:0.01,plane:1 \
        switch:0.02,seed:3 --reroute-modes none local global \
        --out results/experiments_torch
    PYTHONPATH=src python -m repro_torch.experiments.run --suite cosim \
        --topos mphx-4p-86x9 --ranks 16384 --out results/experiments_torch
    PYTHONPATH=src python -m repro_torch.experiments.run --suite serving \
        --tenants chat burst train web --seed 7 \
        --out results/experiments_torch

MPHX presets route on the array engine and the Table-2 baselines
(``ft3-*``, ``mpft-*``, ``dragonfly-*``, ``dfplus-*``) on the graph
engine; ``--engine graph`` routes MPHX on the graph engine too, and
``--engine array`` turns the baselines into skip records.  ``cosim``
runs every MPHX topology on the array engine under the linear and the
mapped placement and on the graph engine under the linear one, whatever
``--engine`` says.
``--device`` defaults to ``cuda``; on a machine without a GPU pass
``--device cpu``.  ``--sim-backend`` picks the fair-share solver's and
the router's reductions (``cuda``: the hand-written kernels; ``torch``:
the plain versions).  ``table2`` is host arithmetic and ignores both.
``--suite failures`` always re-routes on the graph engine (``--engine
array`` turns every topology into a skip record); a malformed
``--failures`` spec exits 2, naming its bad part.  ``--seed`` makes the
serving suite's artifacts byte-identical run to run.
Artifacts: ``<out>/<suite>.json`` and ``<out>/<suite>.md`` (schema v7
rows, see :mod:`repro_torch.experiments.artifacts`).

``--trace OUT.json`` runs the suites under the fabric flight recorder
(:mod:`repro_torch.telemetry`) and exports one Chrome/Perfetto
``trace_event`` JSON; a suite with nothing to trace (``table2``,
``sweep`` without ``--simulate``, a suite whose cells were all skipped)
leaves an explicit skip record in the trace's ``otherData.skipped``, and
the artifacts gain the schema-v5 ``telemetry`` block.
"""

from __future__ import annotations

import argparse
import sys
from contextlib import nullcontext

from .._device import SIM_BACKENDS, resolve_device
from ..cosim import PHASE_METHODS
from ..routing.protection import REROUTE_MODES
from ..sim.failures import parse_failure_spec
from ..telemetry import TraceRecorder, recording
from .cosuite import (DEFAULT_COSIM_CONFIGS, DEFAULT_COSIM_RANKS,
                      DEFAULT_COSIM_TOPOS, run_cosim_suite)
from .scenarios import SCENARIOS
from .servesuite import (DEFAULT_SERVING_TOPOS, DEFAULT_TENANTS,
                         TENANT_PRESETS, run_serving_suite)
from .simsuite import (DEFAULT_FAILURE_SPECS, DEFAULT_SIM_SCENARIOS,
                       DEFAULT_SIM_TOPOS, run_failures_suite, run_sim_suite)
from .sweep import (DEFAULT_OUTDIR, DEFAULT_SWEEP_TOPOS, ROUTING_MODES,
                    SWEEP_TOPOLOGIES, run_sweep_suite, run_table2_suite)

SUITES = ["table2", "sim", "sweep", "failures", "cosim", "serving", "all"]
# the suites ``all`` runs, in the reference's order
ALL_ORDER = ["table2", "sweep", "sim", "cosim", "serving", "failures"]

# why a suite leaves no trace events (the reference's reasons)
UNTRACED = {
    "table2": "analytic cost/diameter table — nothing crosses the "
              "simulator",
    "sweep": "analytic routing sweep without --simulate — nothing "
             "crosses the simulator",
    "sim": "suite produced no trace events (all cells skipped)",
    "failures": "suite produced no trace events (all cells skipped)",
    "cosim": "suite produced no trace events (all cells skipped)",
    "serving": "suite produced no trace events (all cells skipped)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.run",
        description="MPHX flow-simulator and routing suites on "
                    "PyTorch/CUDA")
    p.add_argument("--suite", choices=SUITES, default="sim")
    p.add_argument("--out", default=DEFAULT_OUTDIR,
                   help=f"artifact directory (default {DEFAULT_OUTDIR})")
    p.add_argument("--topos", nargs="+", choices=sorted(SWEEP_TOPOLOGIES),
                   default=None,
                   help="topologies (default: sim and failures "
                   f"{' '.join(DEFAULT_SIM_TOPOS)}; sweep "
                   f"{' '.join(DEFAULT_SWEEP_TOPOS)}; cosim "
                   f"{' '.join(DEFAULT_COSIM_TOPOS)}; serving "
                   f"{' '.join(DEFAULT_SERVING_TOPOS)})")
    p.add_argument("--scenarios", nargs="+", choices=sorted(SCENARIOS),
                   default=None, help="scenarios (default: sim "
                   f"{' '.join(DEFAULT_SIM_SCENARIOS)}; failures uniform; "
                   "sweep all, inapplicable ones recorded as skipped)")
    p.add_argument("--modes", nargs="+", choices=list(ROUTING_MODES),
                   default=None,
                   help="sweep: routing modes (default: all three; the sim "
                   "suite always routes minimal)")
    p.add_argument("--engine", choices=["auto", "array", "graph"],
                   default="auto",
                   help="routing engine (auto: array for MPHX, graph for "
                   "the baseline topologies; a topology the forced engine "
                   "cannot route is recorded as skipped; failures always "
                   "re-route on graph, so array yields skip records)")
    p.add_argument("--loads", nargs="+", type=float, default=None,
                   help="offered load fractions of NIC bandwidth (default: "
                   "0.5 0.9 for sim, 0.1..1.0 for sweep)")
    p.add_argument("--simulate", action="store_true",
                   help="sweep: add measured-FCT columns from the flow "
                   "simulator (minimal mode only)")
    p.add_argument("--msg-bytes", type=float, default=4096)
    p.add_argument("--flow-time-us", type=float, default=200.0,
                   help="flow size as transfer time at the offered rate")
    p.add_argument("--sim-backend", choices=SIM_BACKENDS, default="cuda",
                   help="fair-share solver and router reductions: cuda "
                   "(hand-written kernels) or torch (plain PyTorch "
                   "versions)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass cpu "
                   "on a machine without a GPU)")
    p.add_argument("--collective-mb", type=float, default=256.0,
                   help="all-reduce payload for the table2 suite")
    p.add_argument("--sim-collective-mb", type=float, default=16.0,
                   help="sim suite: measured-collective payload per NIC")
    p.add_argument("--failures", nargs="+", default=None, metavar="SPEC",
                   help="failure specs for the failures suite, e.g. "
                   "'link:0.01' 'link:0.01,plane:1' 'switch:0.02,seed:3' "
                   f"(default: {' '.join(DEFAULT_FAILURE_SPECS)})")
    p.add_argument("--failure-load", type=float, default=0.5,
                   help="offered load fraction for the failures suite")
    p.add_argument("--failure-mode", choices=list(ROUTING_MODES),
                   default="adaptive",
                   help="routing mode for degraded-fabric re-routing")
    p.add_argument("--reroute-modes", nargs="+", default=None,
                   choices=list(REROUTE_MODES), metavar="MODE",
                   help="recovery-curve reroute modes for the failures "
                   "suite: none (global recompute), local (precomputed "
                   "backup paths, no BFS), global (local bridge + full "
                   "reconvergence); default: all three")
    p.add_argument("--protection-layers", type=int, default=4,
                   help="FatPaths/MRC protection layers for the local and "
                   "global reroute modes (default 4)")
    p.add_argument("--config", nargs="+", default=None, metavar="ARCH",
                   help="cosim suite: model configs to co-simulate "
                   "(underscores normalize to the registry's hyphenated "
                   f"arch ids; default: {' '.join(DEFAULT_COSIM_CONFIGS)})")
    p.add_argument("--ranks", type=int, default=DEFAULT_COSIM_RANKS,
                   help="cosim suite: training job size in ranks "
                   f"(default {DEFAULT_COSIM_RANKS})")
    p.add_argument("--device-tflops", type=float, default=989.0,
                   help="cosim suite: per-device peak for the overlapped "
                   "compute term (default 989, H100 bf16 dense)")
    p.add_argument("--cosim-method", choices=list(PHASE_METHODS),
                   default="steady",
                   help="cosim phase execution: steady-state step scaling "
                   "or the fully serialized batch schedule")
    p.add_argument("--tenants", nargs="+", choices=sorted(TENANT_PRESETS),
                   default=None,
                   help="serving suite: tenant presets to mix on each "
                   f"fabric (default: {' '.join(DEFAULT_TENANTS)})")
    p.add_argument("--seed", type=int, default=0,
                   help="root seed for workload RNG (one SeedSequence "
                   "spawning a child per tenant): same seed, same "
                   "artifact, byte for byte")
    p.add_argument("--serving-duration-ms", type=float, default=None,
                   help="serving suite: override every open-loop "
                   "tenant's window")
    p.add_argument("--serving-rate-scale", type=float, default=1.0,
                   help="serving suite: scale every open-loop tenant's "
                   "arrival rate")
    p.add_argument("--trace", default=None, metavar="OUT.json",
                   help="run the suites under the fabric flight recorder "
                   "and export a Chrome/Perfetto trace_event JSON; the "
                   "artifacts gain the schema-v5 telemetry block")
    return p


def _note_if_untraced(rec, suite: str, n_before: int) -> None:
    """Explicit skip record when a suite crossed no traced layer."""
    if rec is not None and rec.n_events == n_before:
        rec.note_skip(suite, UNTRACED[suite])


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    args.failure_specs = None
    if args.failures is not None:
        try:
            args.failure_specs = [parse_failure_spec(s)
                                  for s in args.failures]
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    rec, ctx = None, nullcontext()
    if args.trace:
        rec = TraceRecorder()
        ctx = recording(rec)
    rc = 0
    suites = ALL_ORDER if args.suite == "all" else [args.suite]
    if set(suites) - {"table2"}:
        resolve_device(args.device)   # no card: refuse before any artifact
    with ctx:
        for suite in suites:
            n0 = rec.n_events if rec is not None else 0
            rc = max(rc, RUNNERS[suite](args))
            _note_if_untraced(rec, suite, n0)
    if rec is not None:
        rec.export(args.trace)
        print(f"trace: {rec.n_events} events, "
              f"{len(rec.notes)} untraced suites -> {args.trace}")
    return rc


def _table2(args) -> int:
    payload = run_table2_suite(args.out, args.collective_mb, args.msg_bytes)
    print(f"table2: {len(payload['rows'])} topologies -> "
          f"{args.out}/table2.json, {args.out}/table2.md")
    return 0


def _sweep(args) -> int:
    payload = run_sweep_suite(
        args.out, topo_names=args.topos, scenario_names=args.scenarios,
        modes=args.modes,
        load_fractions=tuple(args.loads) if args.loads
        else (0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        msg_bytes=args.msg_bytes, engine=args.engine,
        simulate=args.simulate, flow_time_s=args.flow_time_us * 1e-6,
        sim_backend=args.sim_backend, device=args.device)
    print(f"sweep: {payload['params']['n_routed_rows']} routed rows, "
          f"{payload['params']['n_skipped']} skipped on "
          f"{payload['params']['device_name']} -> {args.out}/sweep.json, "
          f"{args.out}/sweep.md")
    return 0


def _failures(args) -> int:
    payload = run_failures_suite(
        args.out, topo_names=args.topos, scenario_names=args.scenarios,
        failure_specs=args.failure_specs,
        offered_fraction=args.failure_load, mode=args.failure_mode,
        engine=args.engine, reroute_modes=args.reroute_modes,
        protection_layers=args.protection_layers,
        sim_backend=args.sim_backend, device=args.device)
    print(f"failures: {payload['params']['n_rows']} rows, "
          f"{payload['params']['n_skipped']} skipped on "
          f"{payload['params']['device_name']} -> "
          f"{args.out}/failures.json, {args.out}/failures.md")
    return 0


def _cosim(args) -> int:
    # --topos names the fabrics of every suite; the cosim default is the
    # fabrics big enough for the default job
    payload = run_cosim_suite(
        args.out, config_names=args.config,
        topo_names=args.topos or list(DEFAULT_COSIM_TOPOS),
        n_ranks=args.ranks, device_tflops=args.device_tflops,
        method=args.cosim_method, sim_backend=args.sim_backend,
        device=args.device)
    print(f"cosim: {payload['params']['n_rows']} cells, "
          f"{payload['params']['n_skipped']} skipped on "
          f"{payload['params']['device_name']} -> "
          f"{args.out}/cosim.json, {args.out}/cosim.md")
    return 0


def _serving(args) -> int:
    payload = run_serving_suite(
        args.out, topo_names=args.topos or list(DEFAULT_SERVING_TOPOS),
        tenant_names=args.tenants, seed=args.seed, engine=args.engine,
        sim_backend=args.sim_backend,
        duration_ms=args.serving_duration_ms,
        rate_scale=args.serving_rate_scale, device=args.device)
    print(f"serving: {payload['params']['n_rows']} tenant rows, "
          f"{payload['params']['n_skipped']} skipped on "
          f"{payload['params']['device_name']} -> "
          f"{args.out}/serving.json, {args.out}/serving.md")
    return 0


def _sim(args) -> int:
    payload = run_sim_suite(
        args.out, topo_names=args.topos, scenario_names=args.scenarios,
        load_fractions=tuple(args.loads) if args.loads else (0.5, 0.9),
        flow_time_s=args.flow_time_us * 1e-6, msg_bytes=args.msg_bytes,
        collective_mb=args.sim_collective_mb, sim_backend=args.sim_backend,
        engine=args.engine, device=args.device)
    agree = payload["params"]["all_steady_checks_agree_1e-6"]
    print(f"sim: {len(payload['rows'])} rows on "
          f"{payload['params']['device_name']} (steady-state agreement: "
          f"{agree}) -> {args.out}/sim.json, {args.out}/sim.md")
    if agree is False:
        # remember the failure but keep going: the suites after it are
        # independent and their artifacts still land
        print("sim: FAIL — simulator steady-state loads diverge from the "
              "analytic engine (>1e-6)", file=sys.stderr)
        return 1
    return 0


RUNNERS = {"table2": _table2, "sweep": _sweep, "sim": _sim,
           "failures": _failures, "cosim": _cosim, "serving": _serving}


if __name__ == "__main__":
    sys.exit(main())
