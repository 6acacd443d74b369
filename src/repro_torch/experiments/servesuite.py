"""The ``serving`` suite: per-tenant SLOs per fabric (port of
``repro/experiments/servesuite.py``).

For each topology, :func:`run_serving_suite` places a named tenant mix
(serving, training and background presets from :data:`TENANT_PRESETS`)
on the fabric, runs the shared open-loop simulation and the per-tenant
isolation baselines (:func:`repro_torch.workload.run_tenant_mix`), and
emits one SLO row per (topology, tenant): p50/p99/p999 FCT, TTFT-proxy
percentiles for serving tenants, goodput and slowdown-vs-isolation.

Every random draw descends from the one ``seed`` parameter through one
:class:`numpy.random.SeedSequence` (numpy's draws on the host, no
module-level RNG state, no wall-clock field in rows or params), so the
artifact is byte-identical across runs with the same seed.  Fabrics too
small for the tenants' NIC demand, and mixes whose tenants all sit on
one switch, become explicit skip records.

Writes schema-v7 ``serving.json`` / ``serving.md``
(:mod:`~repro_torch.experiments.artifacts`).
"""

from __future__ import annotations

import dataclasses
import os
import sys

from .._device import resolve_device, resolve_sim_backend
from ..core.netsim import make_router
from ..workload import (BackgroundTenantSpec, ServingTenantSpec, SizeDist,
                        TrainingTenantSpec, run_tenant_mix, slo_rows,
                        tenant_kind)
from .artifacts import (artifact_payload, markdown_table, write_json,
                        write_markdown)
from .simsuite import device_params
from .sweep import DEFAULT_OUTDIR, SWEEP_TOPOLOGIES

# small MPHX plus two Table-2 baseline fabrics at comparable NIC counts
DEFAULT_SERVING_TOPOS = ["mphx-2p-8x8", "ft3-small", "dragonfly-small"]

# named tenant presets the CLI --tenants flag selects from
TENANT_PRESETS: dict = {
    "chat": ServingTenantSpec(
        "chat", arch="mixtral-8x22b", rate_hz=400.0, duration_s=0.25,
        arrival="poisson",
        prompt_tokens=SizeDist("lognormal", mean=800.0, sigma=1.0),
        prefill_replicas=2, decode_replicas=2, tp=4),
    "burst": ServingTenantSpec(
        "burst", arch="mixtral-8x22b", rate_hz=400.0, duration_s=0.25,
        arrival="mmpp", burstiness=6.0,
        prompt_tokens=SizeDist("pareto", alpha=1.2, lo=128.0, hi=32768.0),
        prefill_replicas=2, decode_replicas=2, tp=4,
        hotspot_fraction=0.5),
    "train": TrainingTenantSpec(
        "train", arch="mixtral-8x22b", n_ranks=16, n_steps=1),
    "web": BackgroundTenantSpec(
        "web", rate_hz=4000.0, duration_s=0.25,
        size_bytes=SizeDist("empirical", name="websearch"), n_nics=8),
}
DEFAULT_TENANTS = ["chat", "burst", "train"]


def tenant_specs(names: "list[str]", duration_ms: "float | None" = None,
                 rate_scale: float = 1.0) -> "list":
    """Resolve preset names to specs, optionally rescaling the open-loop
    window / rate (smoke runs shrink both without new presets)."""
    specs = []
    for n in names:
        if n not in TENANT_PRESETS:
            raise ValueError(f"unknown tenant preset {n!r}; "
                             f"known: {sorted(TENANT_PRESETS)}")
        spec = TENANT_PRESETS[n]
        changes: dict = {}
        if hasattr(spec, "duration_s") and duration_ms is not None:
            changes["duration_s"] = duration_ms * 1e-3
        if hasattr(spec, "rate_hz") and rate_scale != 1.0:
            changes["rate_hz"] = spec.rate_hz * rate_scale
        specs.append(dataclasses.replace(spec, **changes) if changes
                     else spec)
    return specs


def _spec_summary(spec) -> dict:
    return {"kind": tenant_kind(spec), **dataclasses.asdict(spec)}


def _skip(topo_name: str, err: Exception) -> dict:
    print(f"serving: skipping {topo_name!r}: {err}", file=sys.stderr)
    return {"topology": topo_name, "skipped": True, "reason": str(err)}


def run_serving_suite(outdir: str = DEFAULT_OUTDIR,
                      topo_names: "list[str] | None" = None,
                      tenant_names: "list[str] | None" = None,
                      seed: int = 0,
                      engine: str = "auto",
                      sim_backend: "str | None" = None,
                      duration_ms: "float | None" = None,
                      rate_scale: float = 1.0,
                      device=None) -> dict:
    """Run the tenant mix on every topology on ``device`` (default
    ``cuda``); write ``serving.{json,md}``.  ``sim_backend`` is the
    solver's and the routers' reduction backend (``cuda``: the
    hand-written kernels, the default; ``torch``: the plain versions).
    Each fabric gets its own router, so one fabric's pair cache is
    dropped before the next."""
    sim_backend = resolve_sim_backend(sim_backend)
    dev = resolve_device(device)
    names = topo_names or list(DEFAULT_SERVING_TOPOS)
    tnames = tenant_names or list(DEFAULT_TENANTS)
    specs = tenant_specs(tnames, duration_ms=duration_ms,
                         rate_scale=rate_scale)
    rows = []
    for tn in names:
        topo = SWEEP_TOPOLOGIES[tn]
        try:
            router = make_router(topo, engine=engine, device=dev)
        except (ValueError, NotImplementedError) as e:
            rows.append(_skip(tn, e))
            continue
        try:
            mix = run_tenant_mix(topo, specs, seed=seed,
                                 sim_backend=sim_backend, router=router)
        except ValueError as e:
            rows.append(_skip(tn, e))
            continue
        finally:
            del router
        for row in slo_rows(mix):
            rows.append({"topology": tn, **row})
        del mix
    done = [r for r in rows if not r.get("skipped")]
    payload = artifact_payload(
        "serving",
        {"topologies": names, "tenants": tnames, "seed": seed,
         "engine": engine, "sim_backend": sim_backend,
         **device_params(dev),
         "duration_ms": duration_ms, "rate_scale": rate_scale,
         "tenant_specs": {n: _spec_summary(s)
                          for n, s in zip(tnames, specs)},
         "n_rows": len(done),
         "n_skipped": sum(1 for r in rows if r.get("skipped"))},
        rows)
    write_json(os.path.join(outdir, "serving.json"), payload)
    cols = ["topology", "tenant", "kind", "n_flows", "n_requests",
            "fct_p50_us", "fct_p99_us", "fct_p999_us",
            "ttft_p50_us", "ttft_p99_us", "ttft_p999_us",
            "goodput_gbps", "slowdown_mean", "slowdown_p99", "n_stalled"]
    sections = [
        ("", "Per-tenant SLOs of a mixed serving + training tenant set "
             "sharing each fabric, on the PyTorch port "
             "(`repro_torch.workload`): open-loop KV-transfer / collective "
             "/ background flows with tag-attributed measured FCTs, run on "
             f"{payload['params']['device_name']}.  Slowdown is vs the "
             "same tenant alone on the fabric (same seed)."),
        ("Per-tenant SLOs", markdown_table(done, cols)),
    ]
    skipped = [r for r in rows if r.get("skipped")]
    if skipped:
        sections.append(("Skipped",
                         markdown_table(skipped, ["topology", "reason"])))
    write_markdown(os.path.join(outdir, "serving.md"),
                   "Multi-tenant serving (PyTorch port) — per-tenant SLOs "
                   "per fabric", sections)
    return payload
