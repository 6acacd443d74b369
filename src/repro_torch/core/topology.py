"""Base abstractions for network topologies (paper §3, Table 1).

Copy of ``repro/core/topology.py``'s link inventory, switch model,
abstract :class:`Topology` (with ``build_graph``'s default, the
bisection bandwidth and the ``summary`` row) and the
explicit switch-level multigraph :class:`SwitchGraph` that the graph
routing engine routes over.  Bandwidths are Gbps; a "hop" is one
traversed link, counting the NIC-switch access links (NIC -> sw -> sw ->
NIC is 3 hops).
"""

from __future__ import annotations

import abc
import math
import random
from dataclasses import dataclass
from typing import Iterable, Sequence


@dataclass(frozen=True)
class LinkClass:
    """A set of identical links (``count`` links of ``speed_gbps``; an
    optical link uses two transceivers, a copper one none)."""

    speed_gbps: float
    count: int
    tier: str = ""
    optical: bool = True

    @property
    def transceivers(self) -> int:
        return 2 * self.count if self.optical else 0

    @property
    def bandwidth_tbps(self) -> float:
        return self.speed_gbps * self.count / 1000.0


def total_optics(links: Iterable[LinkClass]) -> int:
    return sum(l.transceivers for l in links)


@dataclass(frozen=True)
class SwitchModel:
    """A physical switch unit with breakout support (paper §2): 102.4
    Tbps, configurable as 64x1.6T, 128x800G, 256x400G or 512x200G."""

    total_bw_gbps: float = 102_400.0
    max_breakout_ports: int = 512

    def radix_at(self, port_gbps: float) -> int:
        """Number of ports when broken out to ``port_gbps`` per port."""
        r = int(self.total_bw_gbps // port_gbps)
        if r > self.max_breakout_ports:
            raise ValueError(
                f"breakout to {port_gbps} Gbps needs radix {r} > "
                f"max {self.max_breakout_ports}")
        return r


DEFAULT_SWITCH = SwitchModel()


class Topology(abc.ABC):
    """Abstract network topology (paper Table 1 symbols)."""

    name: str = "topology"
    nic_bw_gbps: float = 1600.0  # B

    @property
    @abc.abstractmethod
    def n_nics(self) -> int:
        """N — number of NICs."""

    @property
    @abc.abstractmethod
    def n_switches(self) -> int:
        """N_s — number of physical switch units."""

    @abc.abstractmethod
    def link_classes(self) -> list[LinkClass]:
        """All links in the network, grouped by (speed, tier)."""

    @property
    def n_optics(self) -> int:
        """N_o — total optical transceivers."""
        return total_optics(self.link_classes())

    @property
    @abc.abstractmethod
    def diameter(self) -> int:
        """d — worst-case NIC-to-NIC hop count (links traversed)."""

    @property
    def n_planes(self) -> int:
        return 1

    @property
    def port_gbps(self) -> float:
        """Per-port bandwidth of switch ports (= NIC-port bandwidth B/n)."""
        return self.nic_bw_gbps / self.n_planes

    @abc.abstractmethod
    def avg_hops(self) -> float:
        """Expected minimal NIC-to-NIC hops over uniform random pairs."""

    @abc.abstractmethod
    def bisection_links(self) -> int:
        """#links crossing the worst even bisection (all planes summed)."""

    def bisection_bw_tbps(self) -> float:
        return self.bisection_links() * self.port_gbps / 1000.0

    def bisection_per_nic_gbps(self) -> float:
        """Bisection bandwidth per NIC of one side (injection-normalized:
        each link counted once)."""
        return self.bisection_links() * self.port_gbps / (self.n_nics / 2)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "planes": self.n_planes,
            "N": self.n_nics,
            "N_s": self.n_switches,
            "N_o": self.n_optics,
            "diameter": self.diameter,
            "avg_hops": round(self.avg_hops(), 3),
            "port_gbps": self.port_gbps,
            "bisection_tbps": round(self.bisection_bw_tbps(), 1),
        }

    def validate(self, switch: SwitchModel = DEFAULT_SWITCH) -> None:
        """Raise if the topology is infeasible with the given switch unit."""
        for check, msg in self.feasibility(switch):
            if not check:
                raise ValueError(f"{self.name}: infeasible — {msg}")

    def feasibility(self, switch: SwitchModel) -> list[tuple[bool, str]]:
        return []

    def build_graph(self) -> "SwitchGraph":
        raise NotImplementedError(f"{self.name} has no explicit graph builder")


class SwitchGraph:
    """Switch-level multigraph of ONE network plane.

    Nodes are integers 0..S-1.  Edges carry a multiplicity (parallel
    physical links: Table 2's MPHX(4,86,86,9) trunks 85 links over 8
    neighbours in dim 2) and a tier label.  ``nics_per_switch`` NIC ports
    hang off every *NIC-bearing* node: every node by default (HyperX,
    Dragonfly), or only ``nic_nodes`` where the upper tiers are
    transit-only (fat-tree spines and cores, Dragonfly+ spines).
    """

    def __init__(self, n_switches: int, nics_per_switch: int,
                 link_gbps: float, name: str = "plane",
                 nic_nodes: "Sequence[int] | None" = None):
        self.name = name
        self.n_switches = n_switches
        self.nics_per_switch = nics_per_switch
        self.link_gbps = link_gbps
        self.nic_nodes: list[int] = (list(range(n_switches))
                                     if nic_nodes is None else list(nic_nodes))
        # adjacency: adj[node][neighbor] = multiplicity (float ok)
        self.adj: list[dict[int, float]] = [dict() for _ in range(n_switches)]
        self.tier: dict[tuple[int, int], str] = {}

    def add_edge(self, u: int, v: int, multiplicity: float = 1.0,
                 tier: str = "") -> None:
        if u == v:
            raise ValueError("self-loop")
        self.adj[u][v] = self.adj[u].get(v, 0.0) + multiplicity
        self.adj[v][u] = self.adj[v].get(u, 0.0) + multiplicity
        self.tier[(min(u, v), max(u, v))] = tier

    @property
    def n_edges(self) -> int:
        return sum(len(a) for a in self.adj) // 2

    def total_links(self) -> float:
        return sum(sum(a.values()) for a in self.adj) / 2.0

    def nic_counts(self) -> list[int]:
        """Per-node NIC port counts (0 for transit-only switches)."""
        out = [0] * self.n_switches
        for u in self.nic_nodes:
            out[u] = self.nics_per_switch
        return out

    @property
    def total_nics(self) -> int:
        return self.nics_per_switch * len(self.nic_nodes)

    def directed_edge_arrays(self):
        """All directed edges as parallel lists ``(u, v, multiplicity)``,
        in adjacency order."""
        us, vs, mult = [], [], []
        for u, nbrs in enumerate(self.adj):
            for v, m in nbrs.items():
                us.append(u)
                vs.append(v)
                mult.append(m)
        return us, vs, mult

    def bfs_dist(self, src: int) -> list[int]:
        dist = [-1] * self.n_switches
        dist[src] = 0
        frontier = [src]
        while frontier:
            nxt = []
            for u in frontier:
                for v in self.adj[u]:
                    if dist[v] < 0:
                        dist[v] = dist[u] + 1
                        nxt.append(v)
            frontier = nxt
        return dist

    def switch_diameter(self, sample: "int | None" = None) -> int:
        """Worst-case switch-to-switch distance (exact, or over a sample
        of ``sample`` sources drawn with ``random.Random(0)``)."""
        nodes = range(self.n_switches)
        if sample is not None and self.n_switches > sample:
            nodes = random.Random(0).sample(range(self.n_switches), sample)
        best = 0
        for s in nodes:
            m = max(self.bfs_dist(s))
            if m < 0:
                raise ValueError("graph is disconnected")
            best = max(best, m)
        return best

    def avg_switch_hops(self, sample: "int | None" = None) -> float:
        nodes = list(range(self.n_switches))
        if sample is not None and self.n_switches > sample:
            nodes = random.Random(0).sample(nodes, sample)
        tot, cnt = 0, 0
        for s in nodes:
            tot += sum(self.bfs_dist(s))
            cnt += self.n_switches - 1
        return tot / max(cnt, 1)


def product(xs: Sequence[int]) -> int:
    return math.prod(xs)


def check_even_split(n: int, what: str) -> None:
    if n % 2:
        raise ValueError(f"{what} must be even for bisection, got {n}")
