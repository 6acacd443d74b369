"""Fat-Tree topologies used as baselines in Table 2 (port of
``repro/core/fattree.py``).

* :class:`ThreeTierFatTree` — classic k-ary 3-tier Clos with non-breakout
  switches (Table 2 row 1).
* :class:`MultiPlaneFatTree` — n-plane 2-layer (leaf/spine) Fat-Tree in the
  style of DeepSeek's ideal multi-plane network / Alibaba HPN / Rail-only:
  every physical switch is broken out to n*k thin ports and belongs to one
  plane; every NIC has one port in every plane (Table 2 row 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .topology import (
    DEFAULT_SWITCH,
    LinkClass,
    SwitchGraph,
    SwitchModel,
    Topology,
)


@dataclass
class ThreeTierFatTree(Topology):
    """k-ary 3-tier fat-tree, full bisection.

    With radix k: edge/agg switches have k/2 down + k/2 up ports; the network
    hosts N = k^3/4 NICs at full scale.  For N below full scale the pod count
    shrinks proportionally (N must divide evenly into pods).
    """

    radix: int = 64
    nics: int = 65_536
    nic_bw_gbps: float = 1600.0
    switch: SwitchModel = field(default_factory=lambda: DEFAULT_SWITCH)
    access_copper: bool = False
    name: str = "3-layer Fat-Tree"

    def __post_init__(self):
        k = self.radix
        if self.nics > k**3 // 4:
            raise ValueError(f"{self.nics} NICs exceeds k^3/4 = {k**3//4}")
        if self.nics % (k // 2) or (2 * self.nics // k) % (k // 2):
            raise ValueError("NIC count must fill edge switches evenly")

    @property
    def n_planes(self) -> int:
        return 1

    @property
    def port_gbps(self) -> float:
        return self.nic_bw_gbps

    @property
    def n_nics(self) -> int:
        return self.nics

    @property
    def n_edge(self) -> int:
        return 2 * self.nics // self.radix

    @property
    def n_agg(self) -> int:
        return self.n_edge

    @property
    def n_core(self) -> int:
        return self.nics // self.radix

    @property
    def n_switches(self) -> int:
        return self.n_edge + self.n_agg + self.n_core

    @property
    def n_pods(self) -> int:
        return self.n_edge // (self.radix // 2)

    def link_classes(self) -> list[LinkClass]:
        n = self.nics
        return [
            LinkClass(self.port_gbps, n, tier="access",
                      optical=not self.access_copper),
            LinkClass(self.port_gbps, n, tier="edge-agg"),
            LinkClass(self.port_gbps, n, tier="agg-core"),
        ]

    @property
    def diameter(self) -> int:
        return 6  # NIC-edge-agg-core-agg-edge-NIC

    def avg_hops(self) -> float:
        n = self.nics
        per_edge = self.radix // 2
        per_pod = per_edge * (self.radix // 2)
        p_same_edge = (per_edge - 1) / (n - 1)
        p_same_pod = (per_pod - per_edge) / (n - 1)
        p_diff_pod = 1 - p_same_edge - p_same_pod
        return 2 * p_same_edge + 4 * p_same_pod + 6 * p_diff_pod

    def bisection_links(self) -> int:
        return self.nics // 2

    def feasibility(self, switch: SwitchModel | None = None):
        sw = switch or self.switch
        return [(self.radix <= sw.radix_at(self.port_gbps),
                 f"radix {self.radix} > {sw.radix_at(self.port_gbps)}")]

    def build_graph(self) -> SwitchGraph:
        """Explicit 3-tier Clos graph: edge 0..E-1, agg E..E+A-1, core rest.

        Pod-major numbering: pod ``q`` owns edge/agg switches
        ``q*(k/2) + i``.  Agg slot ``j`` of every pod connects to core group
        ``j`` (``n_core/(k/2)`` cores per group), with multiplicity spread
        so each agg uses exactly its k/2 up ports.  NICs hang off edge
        switches only (k/2 per edge).
        """
        k = self.radix
        E, A, C = self.n_edge, self.n_agg, self.n_core
        half = k // 2
        if C % half:
            raise ValueError(
                f"graph builder needs cores ({C}) divisible by k/2 ({half})")
        g = SwitchGraph(E + A + C, half, self.port_gbps, name=self.name,
                        nic_nodes=range(E))
        cores_per_slot = C // half
        mult_up = half / cores_per_slot  # agg up ports per core in its group
        for pod in range(self.n_pods):
            for i in range(half):          # edge i of this pod
                edge = pod * half + i
                for j in range(half):      # agg j of this pod
                    agg = E + pod * half + j
                    g.add_edge(edge, agg, 1.0, tier="edge-agg")
            for j in range(half):
                agg = E + pod * half + j
                for c in range(cores_per_slot):
                    core = E + A + j * cores_per_slot + c
                    g.add_edge(agg, core, mult_up, tier="agg-core")
        return g


@dataclass
class MultiPlaneFatTree(Topology):
    """n-plane 2-layer (leaf/spine) fat-tree with port breakout (Table 2 row 2).

    Each physical switch is broken out to ``radix = n*k`` ports of B/n Gbps and
    assigned to exactly one plane.  Per plane: leaves take radix/2 NIC ports
    down and radix/2 up; spines provide full bisection.
    """

    n: int = 8
    nics: int = 65_536
    nic_bw_gbps: float = 1600.0
    base_radix: int = 64                 # k, at full NIC speed B
    switch: SwitchModel = field(default_factory=lambda: DEFAULT_SWITCH)
    access_copper: bool = False
    name: str = ""

    def __post_init__(self):
        if not self.name:
            self.name = f"{self.n}-Plane 2-layer Fat-Tree"
        r = self.radix
        if self.nics % (r // 2):
            raise ValueError("NICs must fill leaves evenly")
        if self.nics > r * r // 2:
            raise ValueError(
                f"{self.nics} NICs exceeds 2-layer max {r*r//2} at radix {r}")

    @property
    def radix(self) -> int:
        return self.n * self.base_radix

    @property
    def n_planes(self) -> int:
        return self.n

    @property
    def n_nics(self) -> int:
        return self.nics

    @property
    def leaves_per_plane(self) -> int:
        return self.nics // (self.radix // 2)

    @property
    def spines_per_plane(self) -> int:
        # full bisection: leaf up-links = nics per plane, spread over spines
        return self.nics // self.radix

    @property
    def n_switches(self) -> int:
        return self.n * (self.leaves_per_plane + self.spines_per_plane)

    def link_classes(self) -> list[LinkClass]:
        per_plane_access = self.nics           # one port per NIC per plane
        per_plane_up = self.nics               # full bisection leaf-spine
        return [
            LinkClass(self.port_gbps, self.n * per_plane_access, tier="access",
                      optical=not self.access_copper),
            LinkClass(self.port_gbps, self.n * per_plane_up, tier="leaf-spine"),
        ]

    @property
    def diameter(self) -> int:
        return 4  # NIC-leaf-spine-leaf-NIC

    def avg_hops(self) -> float:
        per_leaf = self.radix // 2
        p_same_leaf = (per_leaf - 1) / (self.nics - 1)
        return 2 * p_same_leaf + 4 * (1 - p_same_leaf)

    def bisection_links(self) -> int:
        return self.n * self.nics // 2

    def feasibility(self, switch: SwitchModel | None = None):
        sw = switch or self.switch
        return [(self.radix <= sw.radix_at(self.port_gbps),
                 f"breakout radix {self.radix} > "
                 f"{sw.radix_at(self.port_gbps)} at {self.port_gbps} Gbps")]

    def build_graph(self) -> SwitchGraph:
        """One plane's leaf/spine graph (leaves 0..L-1 bear the NICs)."""
        L, S = self.leaves_per_plane, self.spines_per_plane
        g = SwitchGraph(L + S, self.radix // 2, self.port_gbps, name=self.name,
                        nic_nodes=range(L))
        up_per_leaf = self.radix // 2
        mult = up_per_leaf / S
        for leaf in range(L):
            for spine in range(S):
                g.add_edge(leaf, L + spine, mult, tier="leaf-spine")
        return g
