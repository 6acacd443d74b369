"""The ``sim`` and ``failures`` suites (port of
``repro/experiments/simsuite.py``).

``sim``: measured flow-completion times.
For each (topology, scenario): a steady-state cross-validation row
(simulator load accounting vs the analytic routing engine) and one
measured-FCT row per offered load from the event loop, on the array
engine for MPHX and on the graph engine for the Table-2 baselines; then
one measured-vs-analytic row per collective schedule
(:mod:`repro_torch.sim.collective_sim`: sprayed flows over every plane)
on topologies of at most ``MAX_COLLECTIVE_NICS`` NICs.  A collective on
a larger fabric, a scenario that does not apply to a topology, and a
topology that a forced ``engine`` cannot route are explicit skip
records, with the reference's reasons.

``failures``: degraded-fabric sweeps.  For each (topology, failure spec,
scenario), healthy-vs-degraded throughput and the recovery curve in
every requested reroute mode (``none``: global recompute; ``local``:
precomputed-backup fast reroute through
:mod:`repro_torch.routing.protection`; ``global``: the local bridge,
then full reconvergence), plus one ``recovery_summary`` row a mode with
the measured time to 90 % throughput (:mod:`repro_torch.sim.failures`).
Degraded fabrics re-route on the graph engine; a forced ``engine=
"array"``, a topology without a switch graph, a plane count the spec
kills, a coordinate-only scenario under switch failures and
disconnected survivors are explicit skip records.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from .._device import resolve_device, resolve_sim_backend, synchronize
from ..core.netsim import load_sweep, make_router, resolve_engine
from ..routing.protection import (REROUTE_MODES, ProtectedRouter,
                                  validate_reroute_mode)
from ..sim.collective_sim import SIM_COLLECTIVES, simulate_collective
from ..sim.failures import (FailureSpec, failure_throughput,
                            parse_failure_spec, recovery_curve,
                            time_to_recover)
from ..sim.fairshare import flow_incidence
from .artifacts import (artifact_payload, markdown_table, write_json,
                        write_markdown)
from .scenarios import get_scenario
from .sweep import DEFAULT_OUTDIR, SWEEP_TOPOLOGIES

DEFAULT_SIM_TOPOS = ["mphx-2p-8x8", "dragonfly-small"]
DEFAULT_SIM_SCENARIOS = ["uniform", "neighbor_shift"]
DEFAULT_FAILURE_SPECS = ["link:0.01", "link:0.05"]
SIM_MODE = "minimal"

# collective schedules serialize O(n_nics) phases — at the 65K-NIC
# Table-2 presets that is ~130k fabric solves per collective, which is a
# dedicated benchmark, not a suite row (the reference's limit and reason)
MAX_COLLECTIVE_NICS = 4096


def _sim_topo_rows(topo, scenario_names, load_fractions, flow_time_s,
                   msg_bytes, collective_mb, sim_backend, engine,
                   device) -> "list[dict]":
    engine_name = resolve_engine(topo, engine)
    router = make_router(topo, engine, device=device)
    graph = getattr(router, "graph", None)
    rows = []
    for name in scenario_names:
        sc = get_scenario(name)
        reason = sc.skip_reason(topo)
        if reason is not None:
            print(f"sim: skipping scenario {name!r} on {topo.name!r}: "
                  f"{reason}", file=sys.stderr)
            rows.append({"topology": topo.name, "scenario": name,
                         "kind": "skip", "engine": engine_name,
                         "skipped": True, "reason": reason})
            continue

        def build(t, o, sc=sc):
            return sc.build(t, o, graph=graph, device=device)

        # steady-state cross-validation at full injection
        dem = build(topo, topo.nic_bw_gbps)
        ll = router.route(dem, SIM_MODE, backend=sim_backend)
        inc = flow_incidence(router, dem, SIM_MODE, backend=sim_backend)
        u_sim = inc.utilization(dem.gbps, sim_backend)
        diff = float((u_sim - ll.utilization_array()).abs().max()) \
            if u_sim.numel() else 0.0
        rows.append({"topology": topo.name, "scenario": name,
                     "kind": "steady_check", "mode": SIM_MODE,
                     "engine": engine_name,
                     "max_util_analytic": round(ll.max_utilization(), 6),
                     "max_util_sim": round(float(u_sim.max()), 6)
                     if u_sim.numel() else 0.0,
                     "max_abs_util_diff": diff,
                     "agrees_1e-6": bool(diff < 1e-6)})
        # measured FCTs per load level
        t0 = time.perf_counter()
        sweep = load_sweep(topo, build, mode=SIM_MODE,
                           load_fractions=load_fractions,
                           msg_bytes=msg_bytes, router=router, simulate=True,
                           flow_time_s=flow_time_s, sim_backend=sim_backend)
        synchronize(device)
        dt = time.perf_counter() - t0
        for r in sweep:
            rows.append({"topology": topo.name, "scenario": name,
                         "kind": "fct", "mode": SIM_MODE,
                         "engine": engine_name, **r,
                         "sim_wall_s": round(dt, 4)})
    # measured collectives (every registered collective schedule kind)
    for kind in SIM_COLLECTIVES:
        if topo.n_nics > MAX_COLLECTIVE_NICS:
            reason = (f"{topo.n_nics} NICs > {MAX_COLLECTIVE_NICS}: "
                      "collective schedules serialize O(n_nics) phases; "
                      "use benchmarks/run.py sim-scale for 65K fabrics")
            print(f"sim: skipping collective {kind!r} on {topo.name!r}: "
                  f"{reason}", file=sys.stderr)
            rows.append({"topology": topo.name, "scenario": kind,
                         "kind": "skip", "engine": engine_name,
                         "skipped": True, "reason": reason})
            continue
        t0 = time.perf_counter()
        row = simulate_collective(topo, kind, collective_mb * 2**20,
                                  router=router, mode=SIM_MODE,
                                  backend=sim_backend)
        synchronize(device)
        rows.append({"kind": "collective", "mode": SIM_MODE,
                     "engine": engine_name, **row,
                     "sim_wall_s": round(time.perf_counter() - t0, 4)})
    return rows


def device_params(device: torch.device) -> dict:
    """What the suite ran on, for the artifact's params."""
    if device.type == "cuda":
        return {"device": str(device),
                "device_name": torch.cuda.get_device_name(device),
                "device_count": torch.cuda.device_count()}
    return {"device": str(device), "device_name": "cpu", "device_count": 0}


def run_sim_suite(outdir: str = DEFAULT_OUTDIR,
                  topo_names: "list[str] | None" = None,
                  scenario_names: "list[str] | None" = None,
                  load_fractions=(0.5, 0.9),
                  flow_time_s: float = 200e-6,
                  msg_bytes: float = 4096,
                  collective_mb: float = 16.0,
                  sim_backend: "str | None" = None, engine: str = "auto",
                  device=None) -> dict:
    """Run the flow simulator over (topology, scenario, load) cells and
    the measured collectives (``collective_mb`` MiB a NIC) on ``device``
    (default ``cuda``) and write ``sim.json`` / ``sim.md``.
    ``sim_backend`` is the fair-share solver's and the router's backend
    (``cuda``: the hand-written kernels, the default; ``torch``: the
    plain versions); ``engine`` (``auto``, ``array`` or ``graph``) picks
    the router."""
    sim_backend = resolve_sim_backend(sim_backend)
    dev = resolve_device(device)
    names = topo_names or list(DEFAULT_SIM_TOPOS)
    scenario_names = scenario_names or list(DEFAULT_SIM_SCENARIOS)
    all_rows = []
    for tn in names:
        topo = SWEEP_TOPOLOGIES[tn]
        try:
            resolve_engine(topo, engine)
        except ValueError as e:
            print(f"sim: skipping topology {topo.name!r}: {e}",
                  file=sys.stderr)
            all_rows.append({"topology": topo.name, "scenario": "*",
                             "engine": engine, "skipped": True,
                             "reason": str(e)})
            continue
        all_rows += _sim_topo_rows(topo, scenario_names, load_fractions,
                                   flow_time_s, msg_bytes, collective_mb,
                                   sim_backend, engine, dev)
    checks = [r for r in all_rows if r.get("kind") == "steady_check"]
    payload = artifact_payload(
        "sim",
        {"topologies": names, "scenarios": scenario_names,
         "mode": SIM_MODE, "load_fractions": list(load_fractions),
         "flow_time_s": flow_time_s, "msg_bytes": msg_bytes,
         "collective_mb": collective_mb, "engine": engine,
         "sim_backend": sim_backend,
         **device_params(dev),
         "n_steady_checks": len(checks),
         "all_steady_checks_agree_1e-6":
             bool(all(r["agrees_1e-6"] for r in checks)) if checks
             else None,
         "n_skipped": sum(1 for r in all_rows if r.get("skipped"))},
        all_rows)
    write_json(os.path.join(outdir, "sim.json"), payload)
    sections = [
        ("", "Measured flow-completion times from the PyTorch port of the "
             "event-driven flow simulator (`repro_torch.sim`), "
             f"run on {payload['params']['device_name']}."),
        ("Steady-state cross-validation (sim vs analytic loads)",
         markdown_table(checks,
                        ["topology", "scenario", "engine",
                         "max_util_analytic", "max_util_sim",
                         "max_abs_util_diff", "agrees_1e-6"])),
        ("Measured FCTs",
         markdown_table([r for r in all_rows if r.get("kind") == "fct"],
                        ["topology", "scenario", "offered_fraction",
                         "max_util", "sim_delivered_fraction",
                         "fct_p50_us", "fct_p99_us", "slowdown_mean",
                         "slowdown_p99", "sim_stalled", "sim_epochs",
                         "sim_wall_s"])),
        ("Collectives: measured vs analytic",
         markdown_table([r for r in all_rows
                         if r.get("kind") == "collective"],
                        ["topology", "collective", "bytes_per_nic", "steps",
                         "sim_flows_per_step", "measured_us", "analytic_us",
                         "analytic_algo", "measured_over_analytic",
                         "sim_wall_s"])),
        ("Skipped",
         markdown_table([r for r in all_rows if r.get("skipped")],
                        ["topology", "scenario", "reason"])),
    ]
    write_markdown(os.path.join(outdir, "sim.md"),
                   "Flow-level simulation (PyTorch port) — measured FCTs "
                   "& collectives",
                   sections)
    return payload


def _failure_cells(topo, specs, scenario_names, offered_fraction, mode,
                   modes, protection_layers, sim_backend, dev
                   ) -> "list[dict]":
    """The ``failures`` rows of one routable topology: per (spec,
    scenario) a ``throughput`` row, the ``recovery`` rows of every mode
    and one ``recovery_summary`` row a mode, or a skip record."""
    offered = offered_fraction * topo.nic_bw_gbps
    rows = []
    protection = None
    if any(m != "none" for m in modes):
        # provisioned once per fabric, shared across specs and scenarios
        protection = ProtectedRouter(topo, n_layers=protection_layers,
                                     backend=sim_backend, device=dev)
        protection.backup_next_hops()
    for spec in specs:
        if spec.planes_down >= topo.n_planes:
            rows.append({"topology": topo.name, "failures": spec.label(),
                         "skipped": True,
                         "reason": f"planes_down={spec.planes_down} "
                                   f">= {topo.n_planes} planes"})
            continue
        for name in scenario_names:
            sc = get_scenario(name)
            reason = sc.skip_reason(topo)
            if reason is None and spec.switch_fraction > 0 \
                    and sc.graph_builder is None:
                # dead switches change the NIC set, so demands must be
                # rebuilt from the degraded graph: coordinate-only
                # scenarios cannot
                reason = (f"scenario {name!r} has no graph builder "
                          "for switch-failure demand rebuild")
            if reason is not None:
                rows.append({"topology": topo.name,
                             "failures": spec.label(), "scenario": name,
                             "skipped": True, "reason": reason})
                continue
            if spec.switch_fraction > 0:
                def build(t, o, g, sc=sc):
                    return sc.graph_builder(t, o, graph=g, device=dev)
            else:
                def build(t, o, g, sc=sc):
                    return sc.build(t, o, graph=g, device=dev)
            t0 = time.perf_counter()
            try:
                ft = failure_throughput(topo, build, spec, offered,
                                        mode=mode, device=dev,
                                        backend=sim_backend)
                synchronize(dev)
                ft_wall = time.perf_counter() - t0
                curves = {rm: recovery_curve(
                    topo, build, spec, offered, mode=mode,
                    throughput_row=ft, reroute_wall_s=ft_wall, reroute=rm,
                    protection=protection if rm != "none" else None,
                    n_layers=protection_layers, device=dev,
                    backend=sim_backend) for rm in modes}
            except ValueError as e:
                # survivors disconnected: an explicit skip record, flagged
                # so it lands in the markdown skip table and n_skipped
                rows.append({"topology": topo.name,
                             "failures": spec.label(), "scenario": name,
                             "skipped": True, "disconnected": True,
                             "reason": str(e)})
                continue
            synchronize(dev)
            dt = round(time.perf_counter() - t0, 4)
            rows.append({"topology": topo.name, "failures": spec.label(),
                         "scenario": name, "kind": "throughput",
                         "offered_fraction": offered_fraction, **ft,
                         "sim_wall_s": dt})
            for rm, phases in curves.items():
                for ph in phases:
                    rows.append({"topology": topo.name,
                                 "failures": spec.label(),
                                 "scenario": name, "kind": "recovery",
                                 "mode": mode, **ph})
                summary = {"topology": topo.name, "failures": spec.label(),
                           "scenario": name, "kind": "recovery_summary",
                           "mode": mode, "reroute": rm,
                           "time_to_90_s": time_to_recover(phases),
                           "recovered_delivered_fraction":
                               phases[-1].get("delivered_fraction"),
                           "n_phases": len(phases)}
                if rm != "none":
                    summary["protection_layers"] = protection_layers
                    summary["protection_coverage"] = round(
                        protection.protection_coverage(), 6)
                rows.append(summary)
    return rows


def run_failures_suite(outdir: str = DEFAULT_OUTDIR,
                       topo_names: "list[str] | None" = None,
                       scenario_names: "list[str] | None" = None,
                       failure_specs: "list[str | FailureSpec] | None" = None,
                       offered_fraction: float = 0.5,
                       mode: str = "adaptive",
                       engine: str = "auto",
                       reroute_modes: "list[str] | None" = None,
                       protection_layers: int = 4,
                       sim_backend: "str | None" = None,
                       device=None) -> dict:
    """Degraded-fabric sweep over (topology, failure spec, scenario) on
    ``device`` (default ``cuda``), writing ``failures.json`` /
    ``failures.md``.

    Each routable cell yields one ``throughput`` row, ``recovery`` rows
    per phase of every mode in ``reroute_modes`` (default all of
    ``none`` / ``local`` / ``global``) and one ``recovery_summary`` row a
    mode with the measured ``time_to_90_s``.  One
    :class:`~repro_torch.routing.protection.ProtectedRouter` with
    ``protection_layers`` layers is provisioned per topology and shared
    across its specs and scenarios.  ``sim_backend`` is the reductions'
    (``cuda``: the hand-written kernels, the default; ``torch``: the
    plain versions).  A forced ``engine="array"`` or a topology without
    an explicit switch graph yields one skip record a topology.
    """
    sim_backend = resolve_sim_backend(sim_backend)
    dev = resolve_device(device)
    names = topo_names or list(DEFAULT_SIM_TOPOS)
    scenario_names = scenario_names or ["uniform"]
    specs = [parse_failure_spec(s) if isinstance(s, str) else s
             for s in (failure_specs or DEFAULT_FAILURE_SPECS)]
    modes = [validate_reroute_mode(m)
             for m in (reroute_modes or list(REROUTE_MODES))]
    rows = []
    for tn in names:
        topo = SWEEP_TOPOLOGIES[tn]
        reason = None
        if engine == "array":
            reason = ("array engine lacks failure re-route support "
                      "(coordinate walks assume an intact mesh); use "
                      "engine=auto/graph")
        else:
            try:
                topo.build_graph()
            except NotImplementedError as e:
                reason = str(e)
        if reason is not None:
            print(f"failures: skipping topology {topo.name!r}: {reason}",
                  file=sys.stderr)
            rows.append({"topology": topo.name, "failures": "*",
                         "skipped": True, "reason": reason})
            continue
        rows += _failure_cells(topo, specs, scenario_names,
                               offered_fraction, mode, modes,
                               protection_layers, sim_backend, dev)
    routed = [r for r in rows if not r.get("skipped")]
    payload = artifact_payload(
        "failures",
        {"topologies": names, "scenarios": scenario_names,
         "failure_specs": [s.label() for s in specs],
         "offered_fraction": offered_fraction, "mode": mode,
         "reroute_modes": modes, "protection_layers": protection_layers,
         "engine": engine, "sim_backend": sim_backend,
         **device_params(dev),
         "n_rows": len(routed),
         "n_skipped": sum(1 for r in rows if r.get("skipped"))},
        rows)
    write_json(os.path.join(outdir, "failures.json"), payload)
    sections = [
        ("", "Degraded-fabric evaluation on the PyTorch port: link, "
             "switch and plane failures are masked out of the switch "
             "graph and survivors re-route on the graph engine, run on "
             f"{payload['params']['device_name']}."),
        ("Healthy vs degraded throughput",
         markdown_table([r for r in routed
                         if r.get("kind") == "throughput"],
                        ["topology", "failures", "scenario", "mode",
                         "healthy_max_util", "degraded_max_util",
                         "throughput_retained", "plane_capacity_factor",
                         "failed_links", "failed_switches"])),
        ("Recovery phases",
         markdown_table([r for r in routed
                         if r.get("kind") == "recovery"],
                        ["topology", "failures", "scenario", "reroute",
                         "phase", "delivered_fraction", "stalled_share",
                         "max_util", "t_offset_s", "phase_wall_s"])),
        ("Recovery summary (local vs global time-to-90%)",
         markdown_table([r for r in routed
                         if r.get("kind") == "recovery_summary"],
                        ["topology", "failures", "scenario", "reroute",
                         "time_to_90_s", "recovered_delivered_fraction",
                         "protection_coverage"])),
    ]
    skipped = [r for r in rows if r.get("skipped")]
    if skipped:
        sections.append(
            ("Skipped (no re-route support / undefined cell / "
             "disconnected survivors)",
             markdown_table(skipped, ["topology", "failures", "scenario",
                                      "reason"])))
    write_markdown(os.path.join(outdir, "failures.md"),
                   "Failure injection (PyTorch port) — degraded "
                   "throughput & recovery", sections)
    return payload
