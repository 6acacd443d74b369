"""Topology presets and the ``sweep`` suite (port of
``repro/experiments/sweep.py``'s load sweeps, MPHX array engine).

:func:`run_sweep_suite` routes every (topology, scenario, mode, load)
cell with :func:`repro_torch.core.netsim.load_sweep` and writes
``sweep.json`` / ``sweep.md``.  Nothing is dropped silently: a scenario
that does not apply to a topology, a collective scenario and a topology
that needs the graph routing engine each give a skip record with its
reason (and a note on stderr).  The reference's default topologies
include four graph-engine baselines (:data:`GRAPH_PRESETS`); the port
has their names only, so each is one skip record whose reason comes from
:func:`repro_torch.core.netsim.resolve_engine`.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import torch

from .._device import resolve_device, resolve_sim_backend
from ..core.hyperx import MPHX
from ..core.netsim import load_sweep, make_router, resolve_engine
from .artifacts import (artifact_payload, markdown_table, write_json,
                        write_markdown)
from .scenarios import (COLLECTIVE_SCENARIOS, COLLECTIVE_SKIP_REASON,
                        SCENARIOS, get_scenario)

DEFAULT_OUTDIR = os.path.join("results", "experiments_torch")

ROUTING_MODES = ("minimal", "valiant", "adaptive")

SWEEP_TOPOLOGIES: "dict[str, MPHX]" = {
    # small — fast, and exactly comparable against the reference
    "mphx-2p-8x8": MPHX(n=2, p=8, dims=(8, 8)),
    # medium — 4k NICs
    "mphx-2p-16x16": MPHX(n=2, p=16, dims=(16, 16)),
    # Table 2 row: 66,564 NICs, trunked dim 2
    "mphx-4p-86x9": MPHX(n=4, p=86, dims=(86, 9), links_per_dim=(85, 85),
                         name="4-Plane 2D HyperX"),
    # Table 2 row: 65,536 NICs, single full-mesh dimension
    "mphx-8p-256": MPHX(n=8, p=256, dims=(256,), name="8-Plane 1D HyperX"),
}


@dataclass(frozen=True)
class GraphPreset:
    """A Table-2 baseline preset of the reference's sweep, by its name
    alone: it routes on the graph engine, which is not ported, so
    :func:`resolve_engine` refuses it."""

    name: str


GRAPH_PRESETS: "dict[str, GraphPreset]" = {
    "ft3-small": GraphPreset("3-layer Fat-Tree (small)"),
    "mpft-2p-small": GraphPreset("2-Plane 2-layer Fat-Tree (small)"),
    "dragonfly-small": GraphPreset("Dragonfly (small)"),
    "dfplus-small": GraphPreset("Dragonfly+ (small)"),
}

# the reference's default sweep: the small MPHX preset and the four
# baseline classes
DEFAULT_SWEEP_TOPOS = ["mphx-2p-8x8", "ft3-small", "mpft-2p-small",
                       "dragonfly-small", "dfplus-small"]


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
    ``topo``, and one for the whole topology where the engine cannot
    route it.  Measured FCT columns (``simulate``) ride only the minimal
    rows, as in the reference.  ``sim_backend`` is the solver's and the
    router's reduction backend (``cuda`` or ``torch``).
    """
    try:
        engine_name = resolve_engine(topo, engine)
    except (NotImplementedError, ValueError) as e:
        print(f"sweep: skipping topology {topo.name!r}: {e}",
              file=sys.stderr)
        return [{"topology": topo.name, "scenario": "*", "engine": engine,
                 "skipped": True, "reason": str(e)}]
    dev = resolve_device(device)
    router = make_router(topo, engine, device=dev)
    rows = []
    names = scenario_names or sorted([*SCENARIOS, *COLLECTIVE_SCENARIOS])
    for name in names:
        if name in COLLECTIVE_SCENARIOS:
            kind, reason = "collective", COLLECTIVE_SKIP_REASON
        else:
            sc = get_scenario(name)
            kind, reason = sc.kind, sc.skip_reason(topo)
        if reason is not None:
            print(f"sweep: skipping scenario {name!r} on {topo.name!r}: "
                  f"{reason}", file=sys.stderr)
            rows.append({"topology": topo.name, "scenario": name,
                         "kind": kind, "engine": engine_name,
                         "skipped": True, "reason": reason})
            continue

        def build(t, o, sc=sc):
            return sc.build(t, o, device=dev)

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
                             "kind": kind, "mode": mode,
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
    topos = {tn: SWEEP_TOPOLOGIES.get(tn) or GRAPH_PRESETS[tn]
             for tn in names}
    all_rows = []
    for tn in names:
        all_rows += sweep_topology(topos[tn], scenario_names, modes,
                                   load_fractions, msg_bytes, engine,
                                   simulate, flow_time_s, sim_backend, dev)
    routed = [r for r in all_rows if not r.get("skipped")]
    skipped = [r for r in all_rows if r.get("skipped")]
    payload = artifact_payload(
        "sweep",
        {"topologies": names,
         "scenarios": scenario_names
         or sorted([*SCENARIOS, *COLLECTIVE_SCENARIOS]),
         "modes": modes or list(ROUTING_MODES),
         "load_fractions": list(load_fractions),
         "msg_bytes": msg_bytes, "engine": engine, "simulate": simulate,
         "sim_backend": sim_backend, **device_params(dev),
         "n_routed_rows": len(routed), "n_skipped": len(skipped)},
        all_rows)
    write_json(os.path.join(outdir, "sweep.json"), payload)
    # markdown: one table per routed topology at the highest swept load
    top_load = max(load_fractions)
    sections = []
    for tn in names:
        topo = topos[tn]
        if not isinstance(topo, MPHX):
            continue
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
