"""CLI of the port's experiment suites.

Example::

    PYTHONPATH=src python -m repro_torch.experiments.run --suite sim \\
        --topos mphx-4p-86x9 --scenarios uniform neighbor_shift \\
        --loads 0.5 0.9 --device cuda --out results/experiments_torch

``--device`` defaults to ``cuda``; on a machine without a GPU pass
``--device cpu``.  Artifacts: ``<out>/sim.json`` and ``<out>/sim.md``
(schema v7 rows, see :mod:`repro_torch.experiments.artifacts`).
"""

from __future__ import annotations

import argparse
import sys

from .._device import SIM_BACKENDS
from .scenarios import SCENARIOS
from .simsuite import DEFAULT_SIM_SCENARIOS, DEFAULT_SIM_TOPOS, run_sim_suite
from .sweep import DEFAULT_OUTDIR, SWEEP_TOPOLOGIES

SUITES = ["sim"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.run",
        description="MPHX flow-simulator suites on PyTorch/CUDA")
    p.add_argument("--suite", choices=SUITES, default="sim")
    p.add_argument("--out", default=DEFAULT_OUTDIR,
                   help=f"artifact directory (default {DEFAULT_OUTDIR})")
    p.add_argument("--topos", nargs="+", choices=sorted(SWEEP_TOPOLOGIES),
                   default=None,
                   help=f"topologies (default: {' '.join(DEFAULT_SIM_TOPOS)})")
    p.add_argument("--scenarios", nargs="+", choices=sorted(SCENARIOS),
                   default=None, help="scenarios (default: "
                   f"{' '.join(DEFAULT_SIM_SCENARIOS)})")
    p.add_argument("--loads", nargs="+", type=float, default=[0.5, 0.9],
                   help="offered load fractions of NIC bandwidth")
    p.add_argument("--msg-bytes", type=float, default=4096)
    p.add_argument("--flow-time-us", type=float, default=200.0,
                   help="flow size as transfer time at the offered rate")
    p.add_argument("--sim-backend", choices=SIM_BACKENDS, default="cuda",
                   help="fair-share solver: cuda (hand-written kernels) or "
                   "torch (plain PyTorch versions)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass cpu "
                   "on a machine without a GPU)")
    return p


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    payload = run_sim_suite(
        args.out, topo_names=args.topos, scenario_names=args.scenarios,
        load_fractions=tuple(args.loads),
        flow_time_s=args.flow_time_us * 1e-6, msg_bytes=args.msg_bytes,
        sim_backend=args.sim_backend, device=args.device)
    agree = payload["params"]["all_steady_checks_agree_1e-6"]
    print(f"sim: {len(payload['rows'])} rows on "
          f"{payload['params']['device_name']} (steady-state agreement: "
          f"{agree}) -> {args.out}/sim.json, {args.out}/sim.md")
    if agree is False:
        print("sim: FAIL — simulator steady-state loads diverge from the "
              "analytic engine (>1e-6)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
