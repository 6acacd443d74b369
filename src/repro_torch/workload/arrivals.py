"""Seeded arrival processes and heavy-tailed size samplers (a copy of
``repro/workload/arrivals.py``).

The open-loop traffic primitives every tenant kind builds on: request
*arrival times* (Poisson, or a 2-state Markov-modulated Poisson process
for bursty tenants) and request / flow *sizes* (lognormal, bounded
Pareto, or named empirical CDFs in the FatPaths style: piecewise-linear
inverse transform over published datacenter flow-size distributions).

Everything takes an explicit :class:`numpy.random.Generator`: there is
no module-level RNG state, so one ``--seed`` threaded from the CLI makes
whole artifacts bit-reproducible, and the draws are numpy's in the
reference's order (never a torch generator), so a seed gives the
reference's traces.  All samplers are pure functions of ``(spec, rng)``.

Units: arrival times in seconds, sizes in whatever unit the caller
declares (``tokens`` for serving prompts, ``bytes`` for background
flows); :func:`mean_size` gives the analytic mean for offered-load
accounting.  Host arithmetic: nothing here touches a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# FatPaths-style named empirical flow-size CDFs (bytes, cum. prob) —
# piecewise-linear approximations of the classic datacenter traces
# (DCTCP web search, the data-mining trace, a Hadoop-style shuffle mix).
# Sampling interpolates linearly in size within each segment, so the
# analytic mean below is exact for the sampler.
EMPIRICAL_CDFS: "dict[str, list[tuple[float, float]]]" = {
    "websearch": [
        (1.0e3, 0.00), (6.0e3, 0.15), (1.3e4, 0.30), (1.9e4, 0.50),
        (3.3e4, 0.60), (5.3e4, 0.70), (1.33e5, 0.80), (6.67e5, 0.90),
        (1.33e6, 0.95), (6.67e6, 0.98), (2.0e7, 1.00),
    ],
    "datamining": [
        (1.0e2, 0.00), (3.0e2, 0.30), (1.0e3, 0.50), (2.0e3, 0.60),
        (1.0e4, 0.70), (1.0e5, 0.80), (1.0e6, 0.90), (1.0e7, 0.95),
        (1.0e8, 0.99), (1.0e9, 1.00),
    ],
    "hadoop": [
        (5.0e2, 0.00), (1.0e3, 0.20), (1.0e4, 0.40), (1.0e5, 0.60),
        (1.0e6, 0.80), (1.0e7, 0.95), (1.0e8, 1.00),
    ],
}


@dataclass(frozen=True)
class SizeDist:
    """One size distribution: ``kind`` picks the sampler.

    * ``fixed`` — point mass at ``mean``.
    * ``lognormal`` — ``sigma`` in log space, scaled so the analytic
      mean is exactly ``mean``.
    * ``pareto`` — bounded Pareto on ``[lo, hi]`` with tail index
      ``alpha`` (heavy tail, finite support).
    * ``empirical`` — a named CDF from :data:`EMPIRICAL_CDFS`
      (``name``), inverse-transform sampled.
    """

    kind: str = "fixed"
    mean: float = 1.0
    sigma: float = 1.0           # lognormal log-space sigma
    alpha: float = 1.2           # pareto tail index
    lo: float = 1.0              # pareto lower bound
    hi: float = 1e6              # pareto upper bound
    name: str = "websearch"      # empirical CDF name

    def __post_init__(self):
        known = ("fixed", "lognormal", "pareto", "empirical")
        if self.kind not in known:
            raise ValueError(f"unknown size dist {self.kind!r}; "
                             f"known: {known}")
        if self.kind == "empirical" and self.name not in EMPIRICAL_CDFS:
            raise ValueError(f"unknown empirical CDF {self.name!r}; "
                             f"known: {sorted(EMPIRICAL_CDFS)}")
        if self.kind == "pareto" and not (self.hi > self.lo > 0):
            raise ValueError("pareto needs hi > lo > 0")


def sample_sizes(dist: SizeDist, n: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """(n,) sizes drawn from ``dist`` using ``rng`` only."""
    if n <= 0:
        return np.zeros(0)
    if dist.kind == "fixed":
        return np.full(n, float(dist.mean))
    if dist.kind == "lognormal":
        # mean of lognormal(mu, sigma) is exp(mu + sigma^2/2); pick mu so
        # the analytic mean is dist.mean
        mu = np.log(dist.mean) - 0.5 * dist.sigma ** 2
        return rng.lognormal(mu, dist.sigma, size=n)
    if dist.kind == "pareto":
        # bounded Pareto inverse transform on [lo, hi]
        a, lo, hi = dist.alpha, dist.lo, dist.hi
        u = rng.random(n)
        return (lo ** -a - u * (lo ** -a - hi ** -a)) ** (-1.0 / a)
    pts = EMPIRICAL_CDFS[dist.name]
    x = np.array([p[0] for p in pts])
    c = np.array([p[1] for p in pts])
    return np.interp(rng.random(n), c, x)


def mean_size(dist: SizeDist) -> float:
    """Analytic mean of ``dist`` (exact for each sampler)."""
    if dist.kind in ("fixed", "lognormal"):
        return float(dist.mean)
    if dist.kind == "pareto":
        a, lo, hi = dist.alpha, dist.lo, dist.hi
        if a == 1.0:
            return float(lo * hi / (hi - lo) * np.log(hi / lo))
        return float((a / (a - 1.0))
                     * (lo ** -(a - 1) - hi ** -(a - 1))
                     / (lo ** -a - hi ** -a))
    pts = EMPIRICAL_CDFS[dist.name]
    x = np.array([p[0] for p in pts])
    c = np.array([p[1] for p in pts])
    # linear-in-x interpolation within a segment -> segment mean is the
    # midpoint, weighted by the segment's probability mass
    return float(np.sum(np.diff(c) * (x[:-1] + x[1:]) / 2.0))


def poisson_arrivals(rate_hz: float, duration_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Arrival times of a homogeneous Poisson process on [0, duration).

    Exponential inter-arrival sampling; the returned array is sorted and
    strictly inside the window.
    """
    if rate_hz <= 0 or duration_s <= 0:
        return np.zeros(0)
    # draw in chunks until the window is covered (expected count + slack)
    out: "list[np.ndarray]" = []
    t = 0.0
    while t < duration_s:
        n = max(int(rate_hz * (duration_s - t) * 1.5) + 16, 16)
        gaps = rng.exponential(1.0 / rate_hz, size=n)
        times = t + np.cumsum(gaps)
        out.append(times)
        t = float(times[-1])
    arr = np.concatenate(out)
    return arr[arr < duration_s]


def mmpp_arrivals(rate_hz: float, duration_s: float,
                  rng: np.random.Generator, burstiness: float = 4.0,
                  dwell_s: float = 0.01) -> np.ndarray:
    """2-state Markov-modulated Poisson process on [0, duration).

    The process alternates between a *calm* and a *burst* state with
    exponential dwell times of mean ``dwell_s``; the burst state's rate
    is ``burstiness`` times the calm state's, scaled so the long-run
    mean rate is ``rate_hz`` (equal expected dwell in both states).
    ``burstiness=1`` degenerates to plain Poisson.
    """
    if rate_hz <= 0 or duration_s <= 0:
        return np.zeros(0)
    b = max(float(burstiness), 1.0)
    # equal dwell -> mean rate = (r_lo + r_hi)/2 = rate_hz
    r_lo = 2.0 * rate_hz / (1.0 + b)
    r_hi = b * r_lo
    out: "list[np.ndarray]" = []
    t = 0.0
    state_hi = bool(rng.random() < 0.5)
    while t < duration_s:
        dwell = float(rng.exponential(dwell_s))
        end = min(t + dwell, duration_s)
        rate = r_hi if state_hi else r_lo
        seg = poisson_arrivals(rate, end - t, rng)
        out.append(t + seg)
        t = end
        state_hi = not state_hi
    arr = np.concatenate(out) if out else np.zeros(0)
    return np.sort(arr[arr < duration_s])
