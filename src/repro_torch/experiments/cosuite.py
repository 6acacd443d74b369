"""The ``cosim`` suite: measured training-step time per fabric (port of
``repro/experiments/cosuite.py``).

For each (model config, topology) cell, :func:`run_cosim_suite` derives
the step's collective phases from the model's sharding
(:func:`repro_torch.cosim.job_from_model`), places ranks on NICs and
runs the phase schedule on the flow simulator
(:func:`repro_torch.cosim.simulate_step`): *measured* communication
time, step time and tokens/sec, next to the alpha-beta closed forms for
the same phases.  MPHX cells run on both routing engines (array and
graph) and with both the linear and the mapping-guided placements;
baseline topologies route on the graph engine.  Cells whose fabric has
fewer NICs than the job has ranks become explicit skip records.

Writes schema-v7 ``cosim.json`` / ``cosim.md``
(:mod:`~repro_torch.experiments.artifacts`).
"""

from __future__ import annotations

import os
import sys
import time

from .._device import resolve_device, resolve_sim_backend, synchronize
from ..core.hyperx import MPHX
from ..core.netsim import make_router
from ..cosim import job_from_model, simulate_step
from .artifacts import (artifact_payload, markdown_table, write_json,
                        write_markdown)
from .simsuite import device_params
from .sweep import DEFAULT_OUTDIR, SWEEP_TOPOLOGIES

DEFAULT_COSIM_CONFIGS = ["kimi-k2-1t-a32b", "mixtral-8x22b"]
DEFAULT_COSIM_TOPOS = ["mphx-2p-8x8", "ft3-small", "dragonfly-small"]
DEFAULT_COSIM_RANKS = 64

# per-arch mesh preference: tp width and the widest ep worth using; dp
# fills the remaining ranks (ep shrinks to a divisor of dp when needed)
_MESH_PREF = {
    "kimi-k2-1t-a32b": {"tp": 16, "ep": 8},
    "mixtral-8x22b": {"tp": 8, "ep": 8},
}


def normalize_arch(name: str) -> str:
    """CLI convenience: ``kimi_k2_1t_a32b`` -> ``kimi-k2-1t-a32b``."""
    return name.replace("_", "-")


def default_mesh(arch_id: str, n_ranks: int, n_experts: "int | None" = None
                 ) -> dict:
    """(dp, tp, ep) split of ``n_ranks`` for one arch.

    ``tp`` shrinks to fit small rank counts; ``ep`` shrinks to the
    largest preference-bounded divisor of both ``dp`` and the expert
    count (1 for dense models).
    """
    pref = _MESH_PREF.get(arch_id, {"tp": 8, "ep": 8})
    tp = pref["tp"]
    while tp > 1 and n_ranks % tp:
        tp //= 2
    dp = max(n_ranks // tp, 1)
    ep = min(pref["ep"], dp) if n_experts else 1
    while ep > 1 and (dp % ep or n_experts % ep):
        ep -= 1
    return {"dp": dp, "tp": tp, "ep": ep}


def _cell_engines(topo) -> "list[tuple[str, str]]":
    """(engine, placement) variants to run for one topology."""
    if isinstance(topo, MPHX):
        return [("array", "linear"), ("array", "mapped"),
                ("graph", "linear")]
    return [("graph", "linear")]


def run_cosim_suite(outdir: str = DEFAULT_OUTDIR,
                    config_names: "list[str] | None" = None,
                    topo_names: "list[str] | None" = None,
                    n_ranks: int = DEFAULT_COSIM_RANKS,
                    shape: str = "train_4k",
                    device_tflops: float = 989.0,
                    method: str = "steady",
                    sim_backend: "str | None" = None,
                    device=None) -> dict:
    """Co-simulate training steps over (config, topology, engine,
    placement) cells on ``device`` (default ``cuda``) and write
    ``cosim.json`` / ``cosim.md``.  ``sim_backend`` is the solver's and
    the routers' reduction backend (``cuda``: the hand-written kernels,
    the default; ``torch``: the plain versions).  Each row's
    ``sim_wall_s`` ends with a device synchronize."""
    from ..models.registry import get_config

    sim_backend = resolve_sim_backend(sim_backend)
    dev = resolve_device(device)
    configs = [normalize_arch(c) for c in
               (config_names or DEFAULT_COSIM_CONFIGS)]
    names = topo_names or list(DEFAULT_COSIM_TOPOS)
    rows = []
    jobs = {}
    for arch in configs:
        cfg = get_config(arch)
        moe = cfg.moe
        mesh = default_mesh(arch, n_ranks,
                            moe.n_experts if moe is not None else None)
        jobs[arch] = job_from_model(cfg, shape=shape, **mesh)
    for tn in names:
        topo = SWEEP_TOPOLOGIES[tn]
        for arch, job in jobs.items():
            if job.n_ranks > topo.n_nics:
                reason = (f"job needs {job.n_ranks} ranks but {topo.name} "
                          f"has {topo.n_nics} NICs")
                print(f"cosim: skipping {arch!r} on {tn!r}: {reason}",
                      file=sys.stderr)
                rows.append({"topology": tn, "arch": arch,
                             "skipped": True, "reason": reason})
                continue
            for engine, placement in _cell_engines(topo):
                router = make_router(topo, engine=engine, device=dev)
                t0 = time.perf_counter()
                res = simulate_step(topo, job, engine=engine,
                                    backend=sim_backend, method=method,
                                    device_tflops=device_tflops,
                                    placement=placement, router=router)
                synchronize(dev)
                dt = round(time.perf_counter() - t0, 4)
                row = res.row()
                row["topology"] = tn
                rows.append({**row, "mesh": dict(job.mesh),
                             "engine": engine, "placement": placement,
                             "method": method, "sim_wall_s": dt})
    routed = [r for r in rows if not r.get("skipped")]
    payload = artifact_payload(
        "cosim",
        {"configs": configs, "topologies": names, "n_ranks": n_ranks,
         "shape": shape, "device_tflops": device_tflops,
         "method": method, "sim_backend": sim_backend,
         **device_params(dev),
         "meshes": {a: dict(j.mesh) for a, j in jobs.items()},
         "n_rows": len(routed),
         "n_skipped": sum(1 for r in rows if r.get("skipped"))},
        rows)
    write_json(os.path.join(outdir, "cosim.json"), payload)
    cols = ["topology", "arch", "engine", "placement", "n_ranks",
            "comm_ms", "compute_ms", "step_ms", "tokens_per_s",
            "analytic_comm_ms", "comm_over_analytic", "comm_fraction",
            "sim_wall_s"]
    sections = [
        ("", "Measured training-step co-simulation on the PyTorch port: "
             "per-step collective phases derived from each model's "
             "sharding, run on the flow-level fabric simulator "
             "(`repro_torch.cosim`) on "
             f"{payload['params']['device_name']}."),
        ("Measured step time & tokens/sec", markdown_table(routed, cols)),
    ]
    phase_rows = [{"topology": r["topology"], "arch": r["arch"],
                   "engine": r["engine"], "placement": r["placement"],
                   **p}
                  for r in routed for p in r.get("phases", ())]
    if phase_rows:
        sections.append(
            ("Per-phase breakdown",
             markdown_table(phase_rows,
                            ["topology", "arch", "engine", "placement",
                             "phase", "kind", "group", "calls", "steps",
                             "sim_flows_per_step", "measured_us",
                             "analytic_us", "measured_over_analytic"])))
    skipped = [r for r in rows if r.get("skipped")]
    if skipped:
        sections.append(("Skipped",
                         markdown_table(skipped,
                                        ["topology", "arch", "reason"])))
    write_markdown(os.path.join(outdir, "cosim.md"),
                   "Training-step co-simulation (PyTorch port) — measured "
                   "step time", sections)
    return payload
