"""Base abstractions for network topologies (paper §3, Table 1).

Copy of the parts of ``repro/core/topology.py`` that :class:`MPHX`
needs: the link inventory, the switch model and the abstract
:class:`Topology`.  Bandwidths are Gbps; a "hop" is one traversed link,
counting the NIC-switch access links (NIC -> sw -> sw -> NIC is 3 hops).
"""

from __future__ import annotations

import abc
import math
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

    def validate(self, switch: SwitchModel = DEFAULT_SWITCH) -> None:
        """Raise if the topology is infeasible with the given switch unit."""
        for check, msg in self.feasibility(switch):
            if not check:
                raise ValueError(f"{self.name}: infeasible — {msg}")

    def feasibility(self, switch: SwitchModel) -> list[tuple[bool, str]]:
        return []


def product(xs: Sequence[int]) -> int:
    return math.prod(xs)
