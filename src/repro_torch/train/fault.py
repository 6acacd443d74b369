"""Fault tolerance: failure detection, elastic remeshing, straggler
mitigation.  A copy of ``repro/train/fault.py`` (pure Python; the port
keeps its own copy so that it imports nothing of the reference).

The paper's multi-plane design is itself a fault-tolerance story at the
*network* level ("driven by considerations such as fault tolerance, NICs ...
are equipped with multiple ports", §2): a dead plane degrades bandwidth to
(n-1)/n instead of killing the job (core/planes.plane_failure_degradation).
This module is the *job* level counterpart:

* :class:`HeartbeatMonitor` — declares ranks dead after a missed-beat
  timeout (injectable clock for tests).
* :func:`plan_remesh` — after losing hosts, pick the largest feasible
  rectangular mesh that preserves the model axis (TP degree must not change
  — param shards must stay valid), shrinking data/pod axes; the checkpoint
  is then restored with the new shardings (train/checkpoint.py).
* :class:`StragglerMonitor` — EMA/z-score step-time outlier detection, the
  signal used to evict or re-spray a slow host.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


class HeartbeatMonitor:
    def __init__(self, ranks: int, timeout_s: float = 30.0, clock=time.time):
        self.timeout = timeout_s
        self.clock = clock
        self.last = {r: clock() for r in range(ranks)}

    def beat(self, rank: int):
        self.last[rank] = self.clock()

    def dead(self) -> list[int]:
        now = self.clock()
        return [r for r, t in self.last.items() if now - t > self.timeout]

    def alive(self) -> list[int]:
        now = self.clock()
        return [r for r, t in self.last.items() if now - t <= self.timeout]


@dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    hosts_used: int
    hosts_available: int

    @property
    def usable_fraction(self) -> float:
        return self.hosts_used / max(math.prod(self.old_shape), 1)


def plan_remesh(old_shape: tuple[int, ...], axis_names: tuple[str, ...],
                available: int) -> RemeshPlan:
    """Largest feasible mesh after failures.

    Keeps the last axis ("model", TP) fixed — checkpoint param shards remain
    valid — and shrinks the leading data/pod axes.  Raises if even TP=model
    cannot be satisfied.
    """
    model = old_shape[-1]
    if available < model:
        raise RuntimeError(
            f"only {available} hosts left; cannot sustain model axis "
            f"{model} — full restart with a smaller TP degree required")
    lead = available // model
    if len(old_shape) == 2:
        new = (lead, model)
    elif len(old_shape) == 3:
        pod, data = old_shape[0], old_shape[1]
        # prefer keeping pods; shrink data; collapse pods if necessary
        best = None
        for p in range(min(pod, lead), 0, -1):
            d = lead // p
            if d == 0:
                continue
            cand = (p, d, model)
            if best is None or math.prod(cand) > math.prod(best):
                best = cand
        new = best
    else:
        raise ValueError("unsupported mesh rank")
    return RemeshPlan(old_shape, new, axis_names,
                      hosts_used=math.prod(new), hosts_available=available)


@dataclass
class StragglerMonitor:
    """EMA mean/var of step time; flags ranks whose reported step time is a
    z-score outlier (straggler mitigation hook)."""

    alpha: float = 0.1
    z_threshold: float = 3.0
    warmup: int = 5
    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step_time_s: float, rank: int = 0) -> bool:
        """Returns True if this observation is a straggler event."""
        self._n += 1
        if self._n <= self.warmup:
            # prime the EMA
            self._mean = (self._mean * (self._n - 1) + step_time_s) / self._n
            self._var = max(self._var, (step_time_s - self._mean) ** 2)
            return False
        z = (step_time_s - self._mean) / max(math.sqrt(self._var), 1e-9)
        is_straggler = z > self.z_threshold
        if is_straggler:
            self.flagged.append((self._n, rank, step_time_s, z))
        else:
            # only track healthy steps so a persistent straggler stays flagged
            d = step_time_s - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        return is_straggler

    @property
    def mean(self) -> float:
        return self._mean


def failure_mttf_steps(n_hosts: int, mtbf_hours_per_host: float = 5_000.0,
                       step_time_s: float = 10.0) -> float:
    """Expected steps between failures at scale — the design-sizing number
    behind checkpoint cadence (1000+ nodes: a failure every few hours)."""
    cluster_mtbf_s = mtbf_hours_per_host * 3600.0 / max(n_hosts, 1)
    return cluster_mtbf_s / step_time_s


def checkpoint_cadence_steps(n_hosts: int, save_cost_s: float,
                             step_time_s: float = 10.0,
                             mtbf_hours_per_host: float = 5_000.0) -> int:
    """Young/Daly optimal checkpoint interval, in steps."""
    mttf_s = mtbf_hours_per_host * 3600.0 / max(n_hosts, 1)
    interval_s = math.sqrt(2.0 * save_cost_s * mttf_s)
    return max(1, int(interval_s / step_time_s))
