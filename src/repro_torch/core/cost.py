"""Cost model (paper §4, Table 2); a copy of ``repro/core/cost.py``.

Assumptions from the paper:
  * 102.4 Tbps switch, bare-metal $40,000.
  * Optical transceivers: 200G $100 / 400G $200 / 800G $450 / 1.6T $1,200.
  * Every link is optical unless ``access_copper`` is set on the topology
    (copper NIC-access links widen MPHX's advantage, since MPHX has no
    access layer beyond the NIC-switch hop).

Host arithmetic on the topology classes: nothing here touches a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .dragonfly import Dragonfly, DragonflyPlus
from .fattree import MultiPlaneFatTree, ThreeTierFatTree
from .topology import Topology


@dataclass(frozen=True)
class CostModel:
    switch_usd: float = 40_000.0
    optics_usd: dict = field(default_factory=lambda: {
        200: 100.0, 400: 200.0, 800: 450.0, 1600: 1200.0,
    })

    def optic_price(self, speed_gbps: float) -> float:
        key = int(round(speed_gbps))
        if key not in self.optics_usd:
            raise KeyError(f"no transceiver price for {speed_gbps} Gbps")
        return self.optics_usd[key]


DEFAULT_COST = CostModel()


@dataclass(frozen=True)
class CostReport:
    name: str
    switch_config: str
    n_nics: int
    n_switches: int
    n_optics: int
    optics_speed_gbps: float
    switches_usd: float
    optics_usd: float

    @property
    def total_usd(self) -> float:
        return self.switches_usd + self.optics_usd

    @property
    def per_nic_usd(self) -> float:
        return self.total_usd / self.n_nics

    def row(self) -> dict:
        return {
            "topology": self.name,
            "switch_config": self.switch_config,
            "N": self.n_nics,
            "N_s": self.n_switches,
            "N_o": self.n_optics,
            "optics_gbps": int(self.optics_speed_gbps),
            "cost_per_nic_usd": round(self.per_nic_usd),
        }


def cost_report(topo: Topology, cost: CostModel = DEFAULT_COST) -> CostReport:
    optics_usd = 0.0
    n_optics = 0
    speeds = set()
    for lc in topo.link_classes():
        if not lc.optical:
            continue
        optics_usd += lc.transceivers * cost.optic_price(lc.speed_gbps)
        n_optics += lc.transceivers
        speeds.add(lc.speed_gbps)
    speed = max(speeds) if speeds else 0.0
    radix = int(round(topo.switch.total_bw_gbps / topo.port_gbps)) \
        if hasattr(topo, "switch") else 0
    cfg = f"{radix}x{_fmt_speed(topo.port_gbps)}" if radix else ""
    return CostReport(
        name=topo.name,
        switch_config=cfg,
        n_nics=topo.n_nics,
        n_switches=topo.n_switches,
        n_optics=n_optics,
        optics_speed_gbps=speed,
        switches_usd=topo.n_switches * cost.switch_usd,
        optics_usd=optics_usd,
    )


def _fmt_speed(gbps: float) -> str:
    return f"{gbps/1000:g}T" if gbps >= 1000 else f"{int(gbps)}G"


# ----------------------------------------------------------------------------
# Table 2: all eight topologies at ~65K NICs
# ----------------------------------------------------------------------------


def table2_topologies() -> list[Topology]:
    from .hyperx import table2_mphx_rows

    return [
        ThreeTierFatTree(radix=64, nics=65_536),
        MultiPlaneFatTree(n=8, nics=65_536),
        Dragonfly(p=16, a=32, h=16, groups=128),
        DragonflyPlus(),
        *table2_mphx_rows(),
    ]


def table2(cost: CostModel = DEFAULT_COST,
           access_copper: bool = False) -> list[CostReport]:
    """Paper Table 2 (optionally with copper access links, §4)."""
    topos = table2_topologies()
    if access_copper:
        for t in topos:
            t.access_copper = True
    return [cost_report(t, cost) for t in topos]


# The paper's published values.  Its 3-layer-FT N_o "393,126" is a
# transposition of 393,216 = 6 * 65,536 (three optical link tiers, two
# transceivers each); the published cost a NIC ($10,323) was computed
# from the transposed count, so that row is held to +-3$ a NIC and the
# others exactly.
PAPER_TABLE2 = [
    # name,                        N,      N_s,   N_o,       cost/NIC
    ("3-layer Fat-Tree",           65_536, 5_120, 393_216,   10_325),
    ("8-Plane 2-layer Fat-Tree",   65_536, 3_072, 2_097_152, 5_075),
    ("Dragonfly",                  65_536, 4_096, 323_584,   8_425),
    ("Dragonfly+",                 65_536, 4_096, 327_680,   8_500),
    ("1-Plane 3D HyperX",          65_536, 4_096, 315_392,   8_275),
    ("2-Plane 2D HyperX",          68_921, 3_362, 544_644,   5_507),
    ("4-Plane 2D HyperX",          66_564, 3_096, 1_058_832, 5_042),
    ("8-Plane 1D HyperX",          65_536, 2_048, 1_570_816, 3_647),
]
