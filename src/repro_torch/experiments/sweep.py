"""Topology presets, the ``table2`` suite and the ``sweep`` suite (port
of ``repro/experiments/sweep.py``).

:func:`run_table2_suite` reproduces the paper's Table 2 (cost, size,
diameter) joined with the closed-form latency, throughput and all-reduce
model: host arithmetic, as in the reference.  :func:`run_sweep_suite`
routes every (topology, scenario, mode, load)
cell with :func:`repro_torch.core.netsim.load_sweep` and writes
``sweep.json`` / ``sweep.md``.  MPHX presets route on the array engine,
the Table-2 baselines on the graph engine over their switch graphs;
every row records its ``engine``.  The collective scenarios route like
the synthetic ones, their patterns scaled by the plane spray's chunk
schedule.  Nothing is dropped silently: a scenario that does not apply
to a topology and a topology that a forced ``engine`` cannot route each
give a skip record with its reason (and a note on stderr).
"""

from __future__ import annotations

import os
import sys
import time

import torch

from .._device import resolve_device, resolve_sim_backend
from ..core.dragonfly import Dragonfly, DragonflyPlus
from ..core.fattree import MultiPlaneFatTree, ThreeTierFatTree
from ..core.cost import PAPER_TABLE2, cost_report, table2_topologies
from ..core.hyperx import MPHX
from ..core.netsim import (DEFAULT_NET, allreduce_time, avg_latency,
                           load_sweep, make_router, resolve_engine,
                           uniform_throughput_fraction, zero_load_latency)
from ..core.topology import Topology
from .artifacts import (artifact_payload, markdown_table, write_json,
                        write_markdown)
from .scenarios import SCENARIOS, get_scenario

DEFAULT_OUTDIR = os.path.join("results", "experiments_torch")

ROUTING_MODES = ("minimal", "valiant", "adaptive")

# The reference's presets.  The ``*-small`` baselines are scaled-down
# instances of the Table-2 rows for fast default sweeps; the ``*-65536``
# presets are the Table-2 rows themselves.
SWEEP_TOPOLOGIES: "dict[str, Topology]" = {
    # -- MPHX (array engine) --
    # small — fast, and exactly comparable against the reference
    "mphx-2p-8x8": MPHX(n=2, p=8, dims=(8, 8)),
    # medium — 4k NICs
    "mphx-2p-16x16": MPHX(n=2, p=16, dims=(16, 16)),
    # Table 2 row: 66,564 NICs, trunked dim 2
    "mphx-4p-86x9": MPHX(n=4, p=86, dims=(86, 9), links_per_dim=(85, 85),
                         name="4-Plane 2D HyperX"),
    # Table 2 row: 65,536 NICs, single full-mesh dimension
    "mphx-8p-256": MPHX(n=8, p=256, dims=(256,), name="8-Plane 1D HyperX"),
    # -- Table-2 baselines, small presets (graph engine) --
    "ft3-small": ThreeTierFatTree(radix=8, nics=128,
                                  name="3-layer Fat-Tree (small)"),
    "mpft-2p-small": MultiPlaneFatTree(n=2, nics=32, base_radix=4,
                                       name="2-Plane 2-layer Fat-Tree "
                                            "(small)"),
    "dragonfly-small": Dragonfly(p=2, a=4, h=2, groups=9,
                                 name="Dragonfly (small)"),
    "dfplus-small": DragonflyPlus(p=2, leaves=4, spines=4, groups=8,
                                  global_per_spine=7,
                                  name="Dragonfly+ (small)"),
    # -- Table-2 baselines, paper-scale rows (graph engine) --
    "ft3-65536": ThreeTierFatTree(radix=64, nics=65_536),
    "mpft-8p-65536": MultiPlaneFatTree(n=8, nics=65_536),
    "dragonfly-65536": Dragonfly(p=16, a=32, h=16, groups=128),
    "dfplus-65536": DragonflyPlus(),
}

# the reference's default sweep: the small MPHX preset and the four
# baseline classes, so a bare ``--suite sweep`` runs both engines
DEFAULT_SWEEP_TOPOS = ["mphx-2p-8x8", "ft3-small", "mpft-2p-small",
                       "dragonfly-small", "dfplus-small"]


def run_table2_suite(outdir: str = DEFAULT_OUTDIR,
                     collective_mb: float = 256.0,
                     msg_bytes: float = 4096) -> dict:
    """Paper Table 2 (§4) joined with the flow-level latency, throughput
    and all-reduce closed forms (§6); writes ``table2.json`` /
    ``table2.md``.

    Its rows are the reference's, key for key and value for value.  It is
    host arithmetic on the topology classes, as in the reference: no
    tensor and no device is involved, so it takes no ``device`` (this is
    not a CPU fallback of a device path)."""
    rows = []
    paper = {name: (n, ns, no, usd) for name, n, ns, no, usd in PAPER_TABLE2}
    for topo in table2_topologies():
        rep = cost_report(topo)
        ar = allreduce_time(topo, collective_mb * 2**20, net=DEFAULT_NET)
        row = {
            "topology": topo.name,
            "N": topo.n_nics,
            "N_s": topo.n_switches,
            "N_o": rep.n_optics,
            "cost_per_nic_usd": round(rep.per_nic_usd, 2),
            "paper_cost_per_nic_usd": paper.get(topo.name, (0, 0, 0, None))[3],
            "diameter": topo.diameter,
            "avg_hops": round(topo.avg_hops(), 3),
            "zero_load_latency_us":
                round(zero_load_latency(topo, msg_bytes) * 1e6, 3),
            "avg_latency_us": round(avg_latency(topo, msg_bytes) * 1e6, 3),
            "uniform_throughput": round(uniform_throughput_fraction(topo), 3),
            f"allreduce_{int(collective_mb)}MB_ms": round(ar.total_s * 1e3, 3),
            "allreduce_algo": ar.algo,
        }
        if row["paper_cost_per_nic_usd"]:
            row["cost_matches_paper"] = (
                abs(rep.per_nic_usd - row["paper_cost_per_nic_usd"]) < 3.0)
        rows.append(row)
    payload = artifact_payload(
        "table2",
        {"collective_mb": collective_mb, "msg_bytes": msg_bytes,
         "cost_note": "paper §4 prices: $40k switch, 200G/$100 400G/$200 "
                      "800G/$450 1.6T/$1200 optics"},
        rows)
    write_json(os.path.join(outdir, "table2.json"), payload)
    write_markdown(
        os.path.join(outdir, "table2.md"),
        "Table 2 — topology cost & latency comparison (65K-NIC scale)",
        [("", "Reproduces paper Table 2 (§4) and joins the flow-level "
              "latency/throughput model (§6 future-work evaluation)."),
         ("Comparison", markdown_table(rows))])
    return payload


def sweep_topology(topo, scenario_names: "list[str] | None" = None,
                   modes: "list[str] | None" = None,
                   load_fractions=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
                   msg_bytes: float = 4096, engine: str = "auto",
                   simulate: bool = False, flow_time_s: float = 200e-6,
                   sim_backend: "str | None" = None,
                   device=None) -> "list[dict]":
    """Latency/throughput-vs-load rows for one topology on ``device``
    (default ``cuda``).

    Routed rows, plus one skip record (``{"skipped": True, "reason":
    ...}``) for every requested scenario that does not apply to
    ``topo``, and one for the whole topology where a forced ``engine``
    cannot route it.  One router serves every cell (the graph engine's
    switch graph and all-pairs BFS are shared).  Measured FCT columns
    (``simulate``) ride only the minimal rows, as in the reference.
    ``sim_backend`` is the solver's and the router's reduction backend
    (``cuda`` or ``torch``).
    """
    try:
        engine_name = resolve_engine(topo, engine)
    except ValueError as e:
        print(f"sweep: skipping topology {topo.name!r}: {e}",
              file=sys.stderr)
        return [{"topology": topo.name, "scenario": "*", "engine": engine,
                 "skipped": True, "reason": str(e)}]
    dev = resolve_device(device)
    router = make_router(topo, engine, device=dev)
    graph = getattr(router, "graph", None)
    rows = []
    for name in scenario_names or sorted(SCENARIOS):
        sc = get_scenario(name)
        reason = sc.skip_reason(topo)
        if reason is not None:
            print(f"sweep: skipping scenario {name!r} on {topo.name!r}: "
                  f"{reason}", file=sys.stderr)
            rows.append({"topology": topo.name, "scenario": name,
                         "kind": sc.kind, "engine": engine_name,
                         "skipped": True, "reason": reason})
            continue

        def build(t, o, sc=sc):
            return sc.build(t, o, graph=graph, device=dev)

        for mode in modes if modes is not None else list(ROUTING_MODES):
            t0 = time.perf_counter()
            sweep = load_sweep(topo, build, mode=mode,
                               load_fractions=load_fractions,
                               msg_bytes=msg_bytes, router=router,
                               simulate=simulate and mode == "minimal",
                               flow_time_s=flow_time_s,
                               sim_backend=sim_backend)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            for r in sweep:
                rows.append({"topology": topo.name, "scenario": name,
                             "kind": sc.kind, "mode": mode,
                             "engine": engine_name, **r,
                             "sweep_wall_s": round(dt, 4)})
    return rows


def run_sweep_suite(outdir: str = DEFAULT_OUTDIR,
                    topo_names: "list[str] | None" = None,
                    scenario_names: "list[str] | None" = None,
                    modes: "list[str] | None" = None,
                    load_fractions=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
                    msg_bytes: float = 4096, engine: str = "auto",
                    simulate: bool = False, flow_time_s: float = 200e-6,
                    sim_backend: "str | None" = None,
                    device=None) -> dict:
    """Sweep every (topology, scenario, mode, load) cell on ``device``
    (default ``cuda``) and write ``sweep.json`` / ``sweep.md``."""
    from .simsuite import device_params

    sim_backend = resolve_sim_backend(sim_backend)
    dev = resolve_device(device)
    names = topo_names or list(DEFAULT_SWEEP_TOPOS)
    all_rows = []
    for tn in names:
        all_rows += sweep_topology(SWEEP_TOPOLOGIES[tn], scenario_names,
                                   modes, load_fractions, msg_bytes, engine,
                                   simulate, flow_time_s, sim_backend, dev)
    routed = [r for r in all_rows if not r.get("skipped")]
    skipped = [r for r in all_rows if r.get("skipped")]
    payload = artifact_payload(
        "sweep",
        {"topologies": names,
         "scenarios": scenario_names or sorted(SCENARIOS),
         "modes": modes or list(ROUTING_MODES),
         "load_fractions": list(load_fractions),
         "msg_bytes": msg_bytes, "engine": engine, "simulate": simulate,
         "sim_backend": sim_backend, **device_params(dev),
         "n_routed_rows": len(routed), "n_skipped": len(skipped)},
        all_rows)
    write_json(os.path.join(outdir, "sweep.json"), payload)
    # markdown: one table per topology at the highest swept load
    top_load = max(load_fractions)
    sections = []
    for tn in names:
        topo = SWEEP_TOPOLOGIES[tn]
        full = [r for r in routed if r["topology"] == topo.name
                and r["offered_fraction"] == top_load]
        cols = ["scenario", "mode", "engine", "max_util",
                "throughput_fraction", "delivered_fraction", "latency_us"]
        sections.append(
            (f"{topo.name} ({topo.n_nics} NICs) @ {top_load:g}x injection",
             markdown_table(full, cols)))
    if skipped:
        sections.append(
            ("Skipped (scenario undefined for topology)",
             markdown_table(skipped, ["topology", "scenario", "reason"])))
    write_markdown(os.path.join(outdir, "sweep.md"),
                   "Latency / throughput vs offered load (PyTorch port)",
                   sections)
    return payload
