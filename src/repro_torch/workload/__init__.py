"""Open-loop multi-tenant workloads on the port's fabric simulator (port
of ``repro.workload``).

Seeded arrival processes and heavy-tailed size samplers
(:mod:`.arrivals`), disaggregated prefill/decode serving traffic with
model-derived KV-cache byte accounting (:mod:`.serving`), mixed
serving + training + background tenants sharing one fabric with
tag-attributed measured FCTs (:mod:`.tenants`), and per-tenant SLO rows:
FCT / TTFT percentiles, goodput, slowdown-vs-isolation (:mod:`.slo`).
The draws are numpy's on the host; the simulations run on the router's
device.
"""

from .arrivals import (EMPIRICAL_CDFS, SizeDist, mean_size, mmpp_arrivals,
                       poisson_arrivals, sample_sizes)
from .serving import (ServingTenantSpec, ServingWorkload,
                      build_serving_workload, kv_bytes_per_token,
                      replica_switches)
from .slo import serving_ttft_s, slo_rows, tenant_slo_row
from .tenants import (BackgroundTenantSpec, MixResult, TenantTraffic,
                      TrainingTenantSpec, build_tenant_traffic,
                      run_tenant_mix, tenant_kind, tenant_mask, tenant_of)

__all__ = [
    "EMPIRICAL_CDFS", "SizeDist", "mean_size", "mmpp_arrivals",
    "poisson_arrivals", "sample_sizes",
    "ServingTenantSpec", "ServingWorkload", "build_serving_workload",
    "kv_bytes_per_token", "replica_switches",
    "serving_ttft_s", "slo_rows", "tenant_slo_row",
    "BackgroundTenantSpec", "MixResult", "TenantTraffic",
    "TrainingTenantSpec", "build_tenant_traffic", "run_tenant_mix",
    "tenant_kind", "tenant_mask", "tenant_of",
]
