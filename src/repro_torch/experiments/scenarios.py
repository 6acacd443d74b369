"""Traffic scenario registry of the sweep and sim suites (port of
``repro/experiments/scenarios.py``): the synthetic patterns, and the
collective chunk schedules whose per-plane load derives from the paper's
NIC spraying model (:mod:`repro_torch.core.planes`) and the chunk
decomposition (:func:`repro_torch.core.collectives.plane_chunk_count`).

Every scenario carries up to two builders, ``builder(topo,
offered_per_nic_gbps, device=) -> DemandArrays`` for MPHX (coordinate
arithmetic) and ``graph_builder(topo, offered_per_nic_gbps, graph=,
device=)`` for any topology with an explicit switch graph (NIC-bearing
switches in id order: the Table-2 baselines).  ``offered_per_nic_gbps``
is the injection rate per NIC across all planes (the builder takes one
plane's share).  A scenario that does not apply to a topology
(``transpose`` needs a square coordinate grid and has no graph builder)
says why in :meth:`Scenario.skip_reason`, which the suites record.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.collectives import plane_chunk_count
from ..core.hyperx import MPHX
from ..core.planes import SprayConfig, plane_chunk_fractions
from ..core.routing_graph import (graph_hotspot_demands,
                                  graph_reverse_demands, graph_ring_demands,
                                  graph_shift_demands, graph_uniform_demands)
from ..core.routing_vec import (DemandArrays, bit_complement_demands,
                                hotspot_demands, neighbor_shift_demands,
                                ring_demands, transpose_demands,
                                uniform_demands)
from ..core.topology import Topology


@dataclass(frozen=True)
class Scenario:
    """A named traffic scenario."""

    name: str
    kind: str                 # "synthetic" | "collective"
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


# ---------------------------------------------------------------------------
# Collective chunk schedules (plane spraying from planes.py / collectives.py)
# ---------------------------------------------------------------------------


def _spray_imbalance(n_planes: int, payload_bytes: int) -> float:
    """Hottest plane's share of a sprayed collective, relative to perfect
    1/n spray.  Whole-chunk rounding makes early planes carry more for
    small payloads; the sweep charges the plane fabric at that factor."""
    cfg = SprayConfig(n_planes=n_planes)
    fracs = plane_chunk_fractions(payload_bytes, cfg)
    return max(fracs) * n_planes


def _ring_size(topo: Topology, graph=None) -> int:
    """Ring participants: switches per plane (MPHX) or NIC-bearing
    switches (generic graphs)."""
    if isinstance(topo, MPHX):
        return topo.switches_per_plane
    if graph is None:
        graph = topo.build_graph()
    return len(graph.nic_nodes)


def _collective_builder(pattern, graph_pattern=None,
                        payload_bytes: int = 1 << 20,
                        ring_chunked: bool = False):
    """Scale a pattern by the hottest plane's share of the chunk schedule.

    ``ring_chunked``: a ring all-reduce moves ``payload/m`` per step
    (m ring participants), so spray imbalance is computed on the per-step
    chunk — small chunks spray poorly.  An all-gather ring moves the full
    payload every step.
    """

    def build(topo: Topology, offered_per_nic_gbps: float, graph=None,
              device=None) -> DemandArrays:
        if isinstance(topo, MPHX):
            d = pattern(topo, offered_per_nic_gbps, device=device)
        else:
            d = graph_pattern(topo, offered_per_nic_gbps, graph=graph,
                              device=device)
        step_bytes = payload_bytes
        if ring_chunked:
            step_bytes = max(payload_bytes // _ring_size(topo, graph), 1)
        # when the step payload does not chunk evenly over the planes the
        # decomposition runs ONE ordered collective, so a single plane
        # carries each step in turn -> full n penalty
        n = topo.n_planes
        if plane_chunk_count(step_bytes, n) == 1:
            scale = float(n)
        else:
            scale = _spray_imbalance(n, step_bytes)
        return DemandArrays(d.src, d.dst, d.gbps * scale)

    return build


def _register_collective(name, description, pattern, graph_pattern,
                         **kw):
    both = _collective_builder(pattern, graph_pattern, **kw)
    register(Scenario(name, "collective", description, both,
                      default_mode="minimal", graph_builder=both))


_register_collective(
    "allreduce_ring",
    "Steady-state link pattern of a ring all-reduce over switch-ordered "
    "ranks; per-step chunk is payload/m, so the spray schedule is charged "
    "on small chunks.",
    ring_demands, graph_ring_demands, ring_chunked=True)

_register_collective(
    "allgather_ring",
    "Ring all-gather steady-state pattern (same ring links as all-reduce "
    "but the full payload moves every step, so spraying is near-perfect).",
    ring_demands, graph_ring_demands)

_register_collective(
    "alltoall",
    "All-to-all chunk exchange — uniform all-pairs at full injection, "
    "spray-chunked across planes (bisection-bound).",
    uniform_demands, graph_uniform_demands)
