"""Traffic scenario registry of the sweep and sim suites: the synthetic
patterns of ``repro/experiments/scenarios.py``, copied (the reference
module imports the JAX collectives).

Every scenario carries up to two builders, ``builder(topo,
offered_per_nic_gbps, device=) -> DemandArrays`` for MPHX (coordinate
arithmetic) and ``graph_builder(topo, offered_per_nic_gbps, graph=,
device=)`` for any topology with an explicit switch graph (NIC-bearing
switches in id order: the Table-2 baselines).  ``offered_per_nic_gbps``
is the injection rate per NIC across all planes (the builder takes one
plane's share).  A scenario that does not apply to a topology
(``transpose`` needs a square coordinate grid and has no graph builder)
says why in :meth:`Scenario.skip_reason`, which the suites record.

The reference's collective scenarios (``COLLECTIVE_SCENARIOS``) scale a
pattern by the plane spray's chunk schedule, which needs
``core/planes.py`` and ``plane_chunk_count``; they are not registered
here, and the sweep records each as a skip with
``COLLECTIVE_SKIP_REASON``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.hyperx import MPHX
from ..core.routing_graph import (graph_hotspot_demands,
                                  graph_reverse_demands, graph_shift_demands,
                                  graph_uniform_demands)
from ..core.routing_vec import (DemandArrays, bit_complement_demands,
                                hotspot_demands, neighbor_shift_demands,
                                transpose_demands, uniform_demands)
from ..core.topology import Topology

COLLECTIVE_SCENARIOS = ("allgather_ring", "allreduce_ring", "alltoall")
COLLECTIVE_SKIP_REASON = (
    "collective scenarios scale a pattern by the plane spray's chunk "
    "schedule (core/planes.py, plane_chunk_count), which is not ported "
    "to repro_torch yet (ROADMAP.md, queue 1: collective_sim / spray / "
    "planes)")


@dataclass(frozen=True)
class Scenario:
    """A named traffic scenario."""

    name: str
    kind: str                 # "synthetic"
    description: str
    builder: Callable[..., DemandArrays]
    default_mode: str = "adaptive"
    # cheap MPHX precondition; None = applies to every MPHX
    requires: "Callable[[MPHX], bool] | None" = None
    requires_reason: str = ""
    # generic SwitchGraph builder; None = MPHX-only scenario
    graph_builder: "Callable[..., DemandArrays] | None" = None

    def skip_reason(self, topo: Topology) -> "str | None":
        """Why this scenario does not apply to ``topo`` (None = it does),
        the reference's text."""
        if isinstance(topo, MPHX):
            if self.requires is not None and not self.requires(topo):
                return self.requires_reason or "precondition not met"
            return None
        if self.graph_builder is None:
            return ("MPHX-coordinate pattern with no generic graph "
                    "analogue")
        if type(topo).build_graph is Topology.build_graph:
            return f"{topo.name} has no explicit switch graph"
        return None

    def applicable(self, topo: Topology) -> bool:
        return self.skip_reason(topo) is None

    def build(self, topo: Topology, offered_per_nic_gbps: float,
              graph=None, device=None) -> DemandArrays:
        """Demand matrix for one plane of ``topo`` on ``device``: the
        coordinate builder on MPHX, the graph builder otherwise (pass a
        prebuilt ``graph`` to skip rebuilding the switch graph)."""
        if isinstance(topo, MPHX):
            return self.builder(topo, offered_per_nic_gbps, device=device)
        if self.graph_builder is None:
            raise ValueError(f"scenario {self.name!r} is MPHX-only: "
                             f"{self.skip_reason(topo)}")
        return self.graph_builder(topo, offered_per_nic_gbps, graph=graph,
                                  device=device)


SCENARIOS: "dict[str, Scenario]" = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {scenario.name}")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    if name in COLLECTIVE_SCENARIOS:
        raise NotImplementedError(f"scenario {name!r}: "
                                  f"{COLLECTIVE_SKIP_REASON}")
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{', '.join(sorted(SCENARIOS))}") from None


def available_scenarios(topo=None) -> "list[str]":
    names = sorted(SCENARIOS)
    if topo is None:
        return names
    return [n for n in names if SCENARIOS[n].applicable(topo)]


register(Scenario(
    "uniform", "synthetic",
    "Every NIC sprays uniformly over all other NIC-bearing switches "
    "(best case; bisection-bound).",
    uniform_demands, default_mode="minimal",
    graph_builder=graph_uniform_demands))

register(Scenario(
    "neighbor_shift", "synthetic",
    "+1 shift permutation — the paper's §5.2 adversarial case: one thin "
    "direct path per pair, minimal routing collapses, non-minimal "
    "recovers.  MPHX: +1 along dim 0; generic: +1 in NIC-switch id order.",
    neighbor_shift_demands, graph_builder=graph_shift_demands))

register(Scenario(
    "bit_complement", "synthetic",
    "Complement permutation (every demand crosses the whole fabric; "
    "classic worst case for dimension-ordered routing).  MPHX: coordinate "
    "complement; generic: reverse pairing in NIC-switch id order.",
    bit_complement_demands, graph_builder=graph_reverse_demands))

register(Scenario(
    "transpose", "synthetic",
    "Swap the first two coordinates (requires dims[0] == dims[1]); "
    "adversarial for dimension-ordered minimal routing.",
    transpose_demands,
    requires=lambda t: t.D >= 2 and t.dims[0] == t.dims[1],
    requires_reason="transpose needs a square coordinate grid "
                    "(dims[0] == dims[1])"))

register(Scenario(
    "hotspot", "synthetic",
    "50% of every switch's load targets one hot switch, rest uniform "
    "(incast around the hot spot).",
    hotspot_demands, graph_builder=graph_hotspot_demands))
