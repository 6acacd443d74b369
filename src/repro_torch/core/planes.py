"""Multi-plane traffic spraying model (paper §2, §5.2); a copy of
``repro/core/planes.py``.

A multi-port NIC splits each flow into chunks and sprays them round-robin
across its n plane ports.  Requirements the paper calls out: the NIC needs
switching functionality + out-of-order RX (chunks complete out of order
across planes).  This module models the *effective* bandwidth and completion
time of sprayed flows, including plane skew and chunking overhead, and
provides the deterministic chunk schedule that
:mod:`repro_torch.sim.spray` simulates plane by plane and
:mod:`repro_torch.experiments.scenarios` charges to the collective
scenarios.

Host arithmetic on Python numbers: nothing here touches a tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SprayConfig:
    n_planes: int = 8
    chunk_bytes: int = 1 << 17          # 128 KiB spray granularity
    per_chunk_overhead_s: float = 200e-9  # header/DMA per chunk
    reorder_window_chunks: int = 64     # RX out-of-order window

    def __post_init__(self):
        if not (1 <= self.n_planes <= 8):
            raise ValueError("paper assumes 1 <= n <= 8 planes")
        if self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")


def split_chunks(total_bytes: int, cfg: SprayConfig) -> list[int]:
    """Bytes assigned to each plane (round-robin whole chunks, remainder to
    plane 0...).  sum == total_bytes, and balance within one chunk."""
    n = cfg.n_planes
    n_chunks = math.ceil(total_bytes / cfg.chunk_bytes)
    per_plane = [0] * n
    remaining = total_bytes
    for i in range(n_chunks):
        take = min(cfg.chunk_bytes, remaining)
        per_plane[i % n] += take
        remaining -= take
    assert remaining == 0
    return per_plane


def plane_chunk_fractions(total_bytes: int, cfg: SprayConfig) -> list[float]:
    """Fraction of a sprayed flow's bytes carried by each plane.

    With perfect spray every entry is 1/n; small flows round to whole chunks,
    so early planes carry more.  The *max* entry scales per-plane offered
    load when a chunk schedule (collective) is mapped onto one plane's
    fabric — see :mod:`repro_torch.experiments.scenarios`.
    """
    per_plane = split_chunks(total_bytes, cfg)
    return [b / total_bytes for b in per_plane] if total_bytes else \
        [0.0] * cfg.n_planes


def spray_completion_time(total_bytes: int, nic_bw_gbps: float,
                          cfg: SprayConfig,
                          plane_skew: list[float] | None = None) -> float:
    """Completion = slowest plane.  ``plane_skew[i]`` >= 1.0 multiplies plane
    i's transfer time (models a congested / degraded plane — fault tolerance:
    a dead plane is skew=inf and the NIC re-sprays over n-1 planes)."""
    per_plane = split_chunks(total_bytes, cfg)
    port_Bps = nic_bw_gbps / cfg.n_planes * 1e9 / 8
    skew = plane_skew or [1.0] * cfg.n_planes
    if len(skew) != cfg.n_planes:
        raise ValueError("plane_skew length mismatch")
    times = []
    for b, s in zip(per_plane, skew):
        if math.isinf(s):
            continue  # plane down: its bytes must be resprayed (handled below)
        n_chunks = math.ceil(b / cfg.chunk_bytes) if b else 0
        times.append((b / port_Bps + n_chunks * cfg.per_chunk_overhead_s) * s)
    dead = [i for i, s in enumerate(skew) if math.isinf(s)]
    if dead:
        # re-spray dead planes' bytes across survivors (second pass)
        dead_bytes = sum(per_plane[i] for i in dead)
        alive = cfg.n_planes - len(dead)
        if alive == 0:
            raise RuntimeError("all planes down")
        extra = dead_bytes / alive / port_Bps
        times = [t + extra for t in times]
    return max(times) if times else 0.0


def effective_bandwidth_gbps(total_bytes: int, nic_bw_gbps: float,
                             cfg: SprayConfig,
                             plane_skew: list[float] | None = None) -> float:
    t = spray_completion_time(total_bytes, nic_bw_gbps, cfg, plane_skew)
    return (total_bytes * 8 / 1e9) / t if t > 0 else 0.0


def spray_efficiency(total_bytes: int, nic_bw_gbps: float,
                     cfg: SprayConfig) -> float:
    """Fraction of ideal NIC bandwidth achieved (1.0 = perfect spray)."""
    return effective_bandwidth_gbps(total_bytes, nic_bw_gbps, cfg) / nic_bw_gbps


def plane_failure_degradation(cfg: SprayConfig) -> float:
    """Bandwidth retained when one plane dies: (n-1)/n with re-spray."""
    return (cfg.n_planes - 1) / cfg.n_planes
