"""Traffic scenario registry: ``uniform`` and ``neighbor_shift`` of
``repro/experiments/scenarios.py``, copied (the reference module imports
the JAX collectives).

A scenario's builder is ``builder(topo, offered_per_nic_gbps, device)
-> DemandArrays``; ``offered_per_nic_gbps`` is the injection rate per NIC
across all planes (the builder takes one plane's share).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.hyperx import MPHX
from ..core.routing_vec import (DemandArrays, neighbor_shift_demands,
                                uniform_demands)


@dataclass(frozen=True)
class Scenario:
    """A named traffic scenario."""

    name: str
    kind: str                 # "synthetic"
    description: str
    builder: Callable[..., DemandArrays]

    def build(self, topo: MPHX, offered_per_nic_gbps: float,
              device=None) -> DemandArrays:
        """Demand matrix for one plane of ``topo`` on ``device``."""
        return self.builder(topo, offered_per_nic_gbps, device=device)


SCENARIOS: "dict[str, Scenario]" = {s.name: s for s in (
    Scenario("uniform", "synthetic",
             "Every NIC sprays uniformly over all other switches "
             "(best case; bisection-bound).", uniform_demands),
    Scenario("neighbor_shift", "synthetic",
             "+1 shift permutation along dim 0 — the paper's §5.2 "
             "adversarial case for minimal routing.",
             neighbor_shift_demands),
)}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{', '.join(sorted(SCENARIOS))}") from None
