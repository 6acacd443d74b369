"""Dragonfly and Dragonfly+ baselines (Table 2 rows 3-4) and the §5.1
flattening argument (port of ``repro/core/dragonfly.py``): with enough
port breakout a (multi-plane) Dragonfly degenerates into a 2D HyperX, and
Dragonfly+ into 2-layer-FT x HyperX and eventually a multi-plane
Fat-Tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .hyperx import MPHX
from .topology import (
    DEFAULT_SWITCH,
    LinkClass,
    SwitchGraph,
    SwitchModel,
    Topology,
)


@dataclass
class Dragonfly(Topology):
    """Dragonfly(p, a, h) [Kim et al. ISCA'08].

    p NICs per router, a routers per group (intra-group full mesh),
    h global links per router.  Balanced: a = 2p = 2h.  Full scale:
    g_max = a*h + 1 groups.  Below full scale the a*h global ports per
    group are trunked evenly over the g-1 other groups.
    """

    p: int = 16
    a: int = 32
    h: int = 16
    groups: int = 128
    nic_bw_gbps: float = 1600.0
    switch: SwitchModel = field(default_factory=lambda: DEFAULT_SWITCH)
    access_copper: bool = False
    name: str = "Dragonfly"

    def __post_init__(self):
        if self.groups > self.a * self.h + 1:
            raise ValueError("groups exceed a*h+1")
        if (self.groups * self.a * self.h) % 2:
            raise ValueError("odd global endpoint count")

    @property
    def radix_used(self) -> int:
        return self.p + (self.a - 1) + self.h

    @property
    def n_nics(self) -> int:
        return self.p * self.a * self.groups

    @property
    def n_switches(self) -> int:
        return self.a * self.groups

    def link_classes(self) -> list[LinkClass]:
        local = self.groups * self.a * (self.a - 1) // 2
        global_ = self.groups * self.a * self.h // 2
        return [
            LinkClass(self.port_gbps, self.n_nics, tier="access",
                      optical=not self.access_copper),
            LinkClass(self.port_gbps, local, tier="local"),
            LinkClass(self.port_gbps, global_, tier="global"),
        ]

    @property
    def diameter(self) -> int:
        return 5  # NIC-l-g-l-NIC

    def avg_hops(self) -> float:
        n = self.n_nics
        p_same_sw = (self.p - 1) / (n - 1)
        p_same_grp = (self.p * self.a - self.p) / (n - 1)
        p_diff = 1 - p_same_sw - p_same_grp
        # diff-group: 1 global hop; src/dst local hop unless the gateway
        # router is the endpoint's router.
        gateways_per_dst_group = min(self.a, self.a * self.h / (self.groups - 1))
        p_local = 1 - gateways_per_dst_group / self.a
        diff_hops = 2 + 1 + 2 * p_local  # 2 access + global + expected locals
        return 2 * p_same_sw + 3 * p_same_grp + diff_hops * p_diff

    def bisection_links(self) -> int:
        # cut splits groups in half: crossing global links
        half = self.groups // 2
        total_global = self.groups * self.a * self.h // 2
        # uniform trunking: fraction of global links crossing
        pairs_cross = half * (self.groups - half)
        pairs_all = self.groups * (self.groups - 1) // 2
        return int(round(total_global * pairs_cross / pairs_all))

    def feasibility(self, switch: SwitchModel | None = None):
        sw = switch or self.switch
        return [(self.radix_used <= sw.radix_at(self.port_gbps),
                 f"radix {self.radix_used} > {sw.radix_at(self.port_gbps)}")]

    # ------------------------------------------------------ §5.1 flattening

    def breakout(self, factor: int) -> "Dragonfly | MPHX":
        """Break each switch port into ``factor`` finer ports (paper §5.1).

        Doubling the radix doubles h, quadruples NICs/group, quarters the
        group count.  Once a single router's global ports cover all other
        groups, the network *is* a 2D HyperX: dims = (a', groups'), trunked.
        """
        if factor < 1 or factor & (factor - 1):
            raise ValueError("factor must be a power of two")
        p2, a2, h2 = self.p * factor, self.a * factor, self.h * factor
        nics = self.n_nics  # keep system scale fixed
        g2 = max(2, nics // (p2 * a2))
        if h2 >= g2 - 1:
            # flattened: every router reaches every other group directly ->
            # 2D HyperX with dims (a2, g2); global links trunked evenly.
            per_router_global = h2
            return MPHX(
                n=factor, p=p2, dims=(a2, g2),
                nic_bw_gbps=self.nic_bw_gbps,
                links_per_dim=(a2 - 1, per_router_global),
                name=f"Dragonfly->2D HyperX (x{factor} breakout)",
            )
        return Dragonfly(p=p2, a=a2, h=h2, groups=g2,
                         nic_bw_gbps=self.nic_bw_gbps,
                         name=f"Dragonfly (x{factor} breakout)")

    def build_graph(self) -> SwitchGraph:
        g = SwitchGraph(self.n_switches, self.p, self.port_gbps, name=self.name)
        a, G, h = self.a, self.groups, self.h
        sid = lambda grp, r: grp * a + r
        for grp in range(G):
            for r in range(a):
                for r2 in range(r + 1, a):
                    g.add_edge(sid(grp, r), sid(grp, r2), 1.0, tier="local")
        # trunk a*h global ports per group evenly across other groups;
        # attach trunked links round-robin over routers.
        per_pair = a * h / (G - 1)
        for grp in range(G):
            for grp2 in range(grp + 1, G):
                # spread multiplicity over router pairs deterministically
                r1 = grp2 % a
                r2 = grp % a
                g.add_edge(sid(grp, r1), sid(grp2, r2), per_pair, tier="global")
        return g


@dataclass
class DragonflyPlus(Topology):
    """Dragonfly+ [Shpiner et al. HiPINEB'17]: groups are leaf/spine Clos;
    spines carry global links (Table 2 row 4: 32 leaves + 32 spines/group,
    radix-64 switches, 64 groups)."""

    p: int = 32                  # NICs per leaf
    leaves: int = 32             # per group
    spines: int = 32             # per group
    groups: int = 64
    global_per_spine: int = 32
    nic_bw_gbps: float = 1600.0
    switch: SwitchModel = field(default_factory=lambda: DEFAULT_SWITCH)
    access_copper: bool = False
    name: str = "Dragonfly+"

    @property
    def n_nics(self) -> int:
        return self.p * self.leaves * self.groups

    @property
    def n_switches(self) -> int:
        return (self.leaves + self.spines) * self.groups

    def link_classes(self) -> list[LinkClass]:
        leaf_spine = self.groups * self.leaves * self.spines
        global_ = self.groups * self.spines * self.global_per_spine // 2
        return [
            LinkClass(self.port_gbps, self.n_nics, tier="access",
                      optical=not self.access_copper),
            LinkClass(self.port_gbps, leaf_spine, tier="leaf-spine"),
            LinkClass(self.port_gbps, global_, tier="global"),
        ]

    @property
    def diameter(self) -> int:
        return 6  # NIC-leaf-spine-(global)-spine-leaf-NIC

    def avg_hops(self) -> float:
        n = self.n_nics
        p_same_leaf = (self.p - 1) / (n - 1)
        per_group = self.p * self.leaves
        p_same_group = (per_group - self.p) / (n - 1)
        p_diff = 1 - p_same_leaf - p_same_group
        return 2 * p_same_leaf + 4 * p_same_group + 6 * p_diff

    def bisection_links(self) -> int:
        half = self.groups // 2
        total_global = self.groups * self.spines * self.global_per_spine // 2
        pairs_cross = half * (self.groups - half)
        pairs_all = self.groups * (self.groups - 1) // 2
        return int(round(total_global * pairs_cross / pairs_all))

    def feasibility(self, switch: SwitchModel | None = None):
        sw = switch or self.switch
        leaf_radix = self.p + self.spines
        spine_radix = self.leaves + self.global_per_spine
        r = sw.radix_at(self.port_gbps)
        return [
            (leaf_radix <= r, f"leaf radix {leaf_radix} > {r}"),
            (spine_radix <= r, f"spine radix {spine_radix} > {r}"),
        ]

    def build_graph(self) -> SwitchGraph:
        """Group-major graph: group ``grp`` owns leaves ``grp*(l+s)..+l-1``
        then spines; leaf-spine is a full bipartite Clos inside each group,
        and the ``spines*global_per_spine`` global ports per group are
        trunked evenly over the other groups (round-robin over spines, like
        :meth:`Dragonfly.build_graph`).  NICs hang off leaves only."""
        l, s, G = self.leaves, self.spines, self.groups
        per_grp = l + s
        g = SwitchGraph(
            per_grp * G, self.p, self.port_gbps, name=self.name,
            nic_nodes=[grp * per_grp + i for grp in range(G)
                       for i in range(l)])
        leaf = lambda grp, i: grp * per_grp + i
        spine = lambda grp, j: grp * per_grp + l + j
        for grp in range(G):
            for i in range(l):
                for j in range(s):
                    g.add_edge(leaf(grp, i), spine(grp, j), 1.0,
                               tier="leaf-spine")
        per_pair = s * self.global_per_spine / (G - 1)
        for grp in range(G):
            for grp2 in range(grp + 1, G):
                g.add_edge(spine(grp, grp2 % s), spine(grp2, grp % s),
                           per_pair, tier="global")
        return g


def frontier_flattening_example() -> dict:
    """Paper §5.1 worked example, Frontier: radix 64, 16 global ports a
    switch, 512 NICs a group, 80 groups.  x2 breakout -> 2,048 NICs a
    group, 20 groups, 32 global ports a switch >= 19 -> flattens to a 2D
    HyperX."""
    frontier = Dragonfly(p=16, a=32, h=16, groups=80, nic_bw_gbps=200.0,
                         name="Frontier (Slingshot Dragonfly)")
    flat = frontier.breakout(2)
    return {
        "before": {
            "radix": frontier.radix_used + 0,
            "nics_per_group": frontier.p * frontier.a,
            "groups": frontier.groups,
            "global_ports_per_switch": frontier.h,
            "nics": frontier.n_nics,
        },
        "after": {
            "flattened_to": type(flat).__name__,
            "name": flat.name,
            "nics_per_group": 2048,
            "groups": 20,
            "global_ports_per_switch": 32,
            "nics": flat.n_nics,
        },
    }
