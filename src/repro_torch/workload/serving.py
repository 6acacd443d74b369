"""Disaggregated LLM serving traffic for one tenant (port of
``repro/workload/serving.py``).

Models the fabric-visible side of prefill/decode-disaggregated serving:
each request arrives open-loop (:mod:`.arrivals`), runs prefill on a
prefill replica, then streams its KV cache to a decode replica; the
KV-cache transfer is the serving fabric flow.  Byte accounting comes
from the tenant's :class:`~repro_torch.configs.base.ModelConfig` the way
:mod:`repro_torch.cosim.traffic` sizes collectives:

``kv_bytes_per_token = 2 (K+V) * n_layers * n_kv_heads * head_dim *
dtype_bytes``

Replicas are tensor-parallel groups of ``tp`` ranks on consecutive NICs
(the linear layout of :func:`repro_torch.cosim.placement.
rank_to_switch`); a request's KV transfer is ``tp`` shard flows between
corresponding prefill / decode ranks, merged per switch pair
(same-switch shards ride the intra-switch path and cost no fabric
traffic, as in ``phase_step_flows``).  ``hotspot_fraction`` routes that
share of requests to decode replica 0: the incast toward a hot replica
that FatPaths evaluates.

Every flow carries ``tag=(tenant, request_index)``, so the simulator's
per-flow records attribute straight back to requests
(:class:`repro_torch.sim.events.FlowSpec`).  Host arithmetic on numpy
arrays: the draws are numpy's, the flows host lists.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..configs.base import ModelConfig
from ..cosim.traffic import _dtype_bytes
from ..sim.events import FlowSpec
from .arrivals import SizeDist, mmpp_arrivals, poisson_arrivals, sample_sizes

ARRIVAL_KINDS = ("poisson", "mmpp")


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes one token occupies across all layers (K and V,
    grouped-query heads, activation dtype) — the per-token payload of a
    prefill -> decode KV transfer."""
    return (2.0 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim
            * _dtype_bytes(cfg))


@dataclass(frozen=True)
class ServingTenantSpec:
    """One serving tenant: arrival process, model, replica geometry.

    ``rate_hz`` requests arrive over ``duration_s``; each samples its
    prompt length from ``prompt_tokens`` (tokens).  Prefill replicas are
    chosen round-robin (they are stateless for placement purposes);
    decode replicas uniformly except that ``hotspot_fraction`` of
    requests pin to decode replica 0.  ``prefill_tokens_per_s`` sets the
    prefill-compute delay between arrival and the KV transfer start.
    """

    name: str
    arch: str = "mixtral-8x22b"
    rate_hz: float = 400.0
    duration_s: float = 0.25
    arrival: str = "poisson"
    burstiness: float = 4.0          # mmpp only
    prompt_tokens: SizeDist = field(
        default_factory=lambda: SizeDist("lognormal", mean=800.0, sigma=1.0))
    prefill_replicas: int = 2
    decode_replicas: int = 2
    tp: int = 4                      # ranks (NICs) per replica
    hotspot_fraction: float = 0.0
    prefill_tokens_per_s: float = 60_000.0

    def __post_init__(self):
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival {self.arrival!r}; "
                             f"known: {ARRIVAL_KINDS}")
        if min(self.prefill_replicas, self.decode_replicas, self.tp) < 1:
            raise ValueError("replica counts and tp must be >= 1")

    @property
    def n_nics(self) -> int:
        return (self.prefill_replicas + self.decode_replicas) * self.tp


@dataclass
class ServingWorkload:
    """Materialized request trace + fabric flows of one serving tenant.

    Request arrays are index-aligned; ``flows[k]`` carries
    ``tag=(name, request)`` and ``caps_gbps[k]`` its injection cap
    (merged shards x one port's rate).  ``intra_bytes`` is KV payload
    that stayed inside a switch (no fabric flow; byte conservation is
    ``sum(flow bytes) + intra_bytes == kv_bytes.sum()``).
    ``local_requests`` lists requests whose shards were ALL
    intra-switch — their transfer is alpha-only.
    """

    spec: ServingTenantSpec
    arrival_s: np.ndarray        # (R,)
    prompt_tokens: np.ndarray    # (R,)
    kv_bytes: np.ndarray         # (R,)
    kv_start_s: np.ndarray       # (R,) arrival + prefill compute
    prefill_replica: np.ndarray  # (R,)
    decode_replica: np.ndarray   # (R,)
    flows: "list[FlowSpec]"
    caps_gbps: np.ndarray        # (F,) injection cap per merged flow
    intra_bytes: float
    local_requests: np.ndarray   # request ids with zero fabric flows

    @property
    def n_requests(self) -> int:
        return int(self.arrival_s.shape[0])

    def offered_bytes(self) -> float:
        return float(self.kv_bytes.sum())


def replica_switches(switch_of_nic: np.ndarray, nic_base: int,
                     n_replicas: int, tp: int) -> np.ndarray:
    """(n_replicas, tp) switch id of each replica's ranks, placed on
    consecutive NICs starting at ``nic_base``."""
    need = nic_base + n_replicas * tp
    if need > switch_of_nic.shape[0]:
        raise ValueError(f"placement needs NICs [{nic_base}, {need}) but "
                         f"fabric has {switch_of_nic.shape[0]}")
    nics = nic_base + np.arange(n_replicas * tp)
    return switch_of_nic[nics].reshape(n_replicas, tp)


def build_serving_workload(spec: ServingTenantSpec,
                           switch_of_nic: np.ndarray, nic_base: int,
                           port_gbps: float, rng: np.random.Generator,
                           kv_per_token: "float | None" = None
                           ) -> ServingWorkload:
    """Materialize one tenant's request trace and KV-transfer flows.

    ``switch_of_nic`` is the fabric's per-NIC switch map
    (:func:`repro_torch.cosim.placement.rank_to_switch`); the tenant occupies
    NICs ``[nic_base, nic_base + spec.n_nics)`` — prefill replicas
    first, then decode replicas.  ``kv_per_token`` overrides the
    registry model's byte accounting (tests).  Every draw is
    numpy's from ``rng``, in the reference's order.
    """
    if kv_per_token is None:
        from ..models.registry import get_config
        kv_per_token = kv_bytes_per_token(get_config(spec.arch))
    if spec.arrival == "mmpp":
        arrival = mmpp_arrivals(spec.rate_hz, spec.duration_s, rng,
                                burstiness=spec.burstiness)
    else:
        arrival = poisson_arrivals(spec.rate_hz, spec.duration_s, rng)
    R = arrival.shape[0]
    tokens = np.maximum(np.rint(sample_sizes(spec.prompt_tokens, R, rng)),
                        1.0)
    kv = tokens * kv_per_token
    start = arrival + tokens / spec.prefill_tokens_per_s
    pre = np.arange(R) % spec.prefill_replicas
    dec = rng.integers(0, spec.decode_replicas, size=R)
    if spec.hotspot_fraction > 0:
        hot = rng.random(R) < spec.hotspot_fraction
        dec = np.where(hot, 0, dec)
    pre_sw = replica_switches(switch_of_nic, nic_base,
                              spec.prefill_replicas, spec.tp)
    dec_sw = replica_switches(switch_of_nic,
                              nic_base + spec.prefill_replicas * spec.tp,
                              spec.decode_replicas, spec.tp)
    flows: "list[FlowSpec]" = []
    caps: "list[float]" = []
    intra = 0.0
    local: "list[int]" = []
    for r in range(R):
        shard = kv[r] / spec.tp
        pairs: "dict[tuple[int, int], tuple[float, int]]" = {}
        for i in range(spec.tp):
            s = int(pre_sw[pre[r], i])
            d = int(dec_sw[dec[r], i])
            if s == d:
                intra += shard
                continue
            b, n = pairs.get((s, d), (0.0, 0))
            pairs[(s, d)] = (b + shard, n + 1)
        if not pairs:
            local.append(r)
            continue
        for (s, d), (b, n) in sorted(pairs.items()):
            flows.append(FlowSpec(s, d, b, start_s=float(start[r]),
                                  tag=(spec.name, r)))
            caps.append(port_gbps * n)
    return ServingWorkload(
        spec=spec, arrival_s=arrival, prompt_tokens=tokens, kv_bytes=kv,
        kv_start_s=start, prefill_replica=pre, decode_replica=dec,
        flows=flows, caps_gbps=np.asarray(caps, dtype=np.float64),
        intra_bytes=intra,
        local_requests=np.asarray(local, dtype=np.int64))
