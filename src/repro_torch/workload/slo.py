"""Per-tenant SLO accounting over a multi-tenant mix (port of
``repro/workload/slo.py``).

Turns a :class:`~repro_torch.workload.tenants.MixResult` into per-tenant
SLO rows: FCT percentiles (p50/p99/p999), TTFT-proxy percentiles for
serving tenants (request arrival -> prefill compute -> KV-transfer
completion, including the path alpha; intra-switch-only requests pay the
2-hop alpha), goodput, and slowdown-vs-isolation (the same tenant's
identical seed-derived trace alone on the fabric).

Attribution is tag-driven (``tag=(tenant, key)`` on every flow).  The
rows are host arithmetic on one host copy of each simulation's per-flow
arrays (numpy's percentiles and sums, the reference's bits).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .tenants import MixResult, TenantTraffic, tenant_mask

SLO_PERCENTILES = (50, 99, 99.9)


def _host(res) -> SimpleNamespace:
    """Host copies of a simulation's per-flow arrays (one copy each)."""
    return SimpleNamespace(
        tags=res.tags,
        **{k: getattr(res, k).cpu().numpy()
           for k in ("start_s", "finish_s", "fct_s", "latency_s",
                     "size_bytes")})


def _pcts(values: np.ndarray, unit: float = 1e6,
          prefix: str = "fct") -> dict:
    """p50/p99/p999 of ``values`` (seconds in, microseconds out)."""
    keys = [f"{prefix}_p{str(q).replace('.', '')}_us"
            for q in SLO_PERCENTILES]
    if values.size == 0:
        return {k: None for k in keys}
    return {k: round(float(np.percentile(values, q)) * unit, 3)
            for k, q in zip(keys, SLO_PERCENTILES)}


def serving_ttft_s(mix: MixResult, name: str, _res=None
                   ) -> "tuple[np.ndarray, np.ndarray]":
    """(R,) TTFT proxy per request of serving tenant ``name`` plus an
    (R,) validity mask (False = a KV shard flow stalled).

    TTFT proxy = (KV-transfer completion on the fabric clock, i.e. the
    last shard's ``finish + path alpha``) minus the request's arrival;
    prefill compute is inside because the KV flow starts at ``arrival +
    prompt_tokens / prefill_tokens_per_s``.  Requests whose shards all
    stayed intra-switch complete at ``kv_start + 2-hop alpha``.
    """
    t = mix.tenant(name)
    w = t.serving
    if w is None:
        raise ValueError(f"tenant {name!r} is not a serving tenant")
    res = _res if _res is not None else _host(mix.mixed)
    comp = np.full(w.n_requests, -np.inf)
    valid = np.ones(w.n_requests, dtype=bool)
    for i in np.flatnonzero(tenant_mask(res, name)):
        r = int(res.tags[i][1])
        if not np.isfinite(res.finish_s[i]):
            valid[r] = False
            continue
        comp[r] = max(comp[r], float(res.finish_s[i] + res.latency_s[i]))
    if w.local_requests.size:
        comp[w.local_requests] = (w.kv_start_s[w.local_requests]
                                  + mix.alpha_local_s)
    valid &= np.isfinite(comp)
    return comp - w.arrival_s, valid


def tenant_slo_row(mix: MixResult, t: TenantTraffic, _res=None) -> dict:
    """One tenant's flat SLO record (the serving suite's row unit)."""
    res = _res if _res is not None else _host(mix.mixed)
    m = tenant_mask(res, t.name)
    fin = np.isfinite(res.finish_s) & m
    fct = res.fct_s[fin]
    row = {
        "tenant": t.name,
        "kind": t.kind,
        "n_nics": t.n_nics,
        "n_flows": int(m.sum()),
        "n_stalled": int((m & ~np.isfinite(res.finish_s)).sum()),
        **_pcts(fct),
    }
    # goodput: full (all-planes) payload of finished flows plus
    # intra-switch bytes, over the tenant's active span
    full = res.size_bytes * mix.n_planes
    intra = float(t.meta.get("intra_bytes", 0.0))
    if t.serving is not None:
        intra = t.serving.intra_bytes
    delivered = float(full[fin].sum()) + intra
    if fin.any():
        span = float(res.finish_s[fin].max() - res.start_s[m].min())
        row["goodput_gbps"] = round(delivered * 8 / 1e9 / span, 3) \
            if span > 0 else None
    else:
        row["goodput_gbps"] = None
    iso = mix.isolated.get(t.name)
    if iso is not None:
        iso_finish = iso.finish_s.cpu().numpy()
        iso_fct = iso.fct_s.cpu().numpy()
        both = fin[m] & np.isfinite(iso_finish)
        if both.any():
            slow = res.fct_s[m][both] / iso_fct[both]
            row["slowdown_mean"] = round(float(slow.mean()), 4)
            row["slowdown_p99"] = round(float(np.percentile(slow, 99)), 4)
        else:
            row["slowdown_mean"] = row["slowdown_p99"] = None
    if t.serving is not None:
        ttft, valid = serving_ttft_s(mix, t.name, _res=res)
        row["n_requests"] = t.serving.n_requests
        row["n_requests_stalled"] = int((~valid).sum())
        row.update(_pcts(ttft[valid], prefix="ttft"))
    return row


def slo_rows(mix: MixResult) -> "list[dict]":
    """Per-tenant SLO rows for every tenant of the mix, spec order (one
    host copy of the mixed run for all of them)."""
    res = _host(mix.mixed)
    return [tenant_slo_row(mix, t, _res=res) for t in mix.traffic]
