"""Multi-Plane HyperX (MPHX) topology — the paper's contribution (§3).

Copy of ``repro/core/hyperx.py``: :class:`MPHX` with Eq. 2
(:meth:`MPHX.max_scale`, :meth:`MPHX.balanced`) and its explicit switch
graph (:meth:`MPHX.build_graph`, which the graph routing engine routes
for the graph-vs-array cross-check), :func:`flattened_butterfly` and
Table 2's four MPHX rows (:func:`table2_mphx_rows`).

``MPHX(n, p, D_1, ..., D_D)``: ``n`` planes (NIC ports of B/n each),
``p`` NIC ports per switch per plane, ``D_i`` fully meshed switches
along dimension ``i``.  Eq. 1: ``N = p * prod(D_i)``.  Table 2's
MPHX(4,86,86,9) trunks dimension 2 (85 links over 8 neighbours) through
``links_per_dim``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .topology import (DEFAULT_SWITCH, LinkClass, SwitchGraph,
                       SwitchModel, Topology, product)


@dataclass
class MPHX(Topology):
    """Multi-Plane HyperX network MPHX(n, p, D_1..D_D)."""

    n: int                               # planes (NIC ports)
    p: int                               # NIC ports per switch per plane
    dims: tuple[int, ...]                # D_1..D_D
    nic_bw_gbps: float = 1600.0          # B
    switch: SwitchModel = field(default_factory=lambda: DEFAULT_SWITCH)
    links_per_dim: tuple[int, ...] | None = None  # trunking override
    access_copper: bool = False          # copper NIC-access links (§4)
    name: str = ""

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        if self.links_per_dim is None:
            self.links_per_dim = tuple(d - 1 for d in self.dims)
        else:
            self.links_per_dim = tuple(self.links_per_dim)
        if len(self.links_per_dim) != len(self.dims):
            raise ValueError("links_per_dim must match dims")
        for d, l in zip(self.dims, self.links_per_dim):
            if d > 1 and l < d - 1:
                raise ValueError(
                    f"dimension with {d} switches needs >= {d-1} links, got {l}")
        if not self.name:
            self.name = f"MPHX({self.n},{self.p},{','.join(map(str, self.dims))})"

    @property
    def D(self) -> int:
        return len(self.dims)

    @property
    def n_planes(self) -> int:
        return self.n

    @property
    def switches_per_plane(self) -> int:
        return product(self.dims)

    @property
    def n_nics(self) -> int:
        return self.p * self.switches_per_plane    # Eq. 1

    @property
    def n_switches(self) -> int:
        return self.n * self.switches_per_plane

    @property
    def radix_used(self) -> int:
        return self.p + sum(self.links_per_dim)

    def link_classes(self) -> list[LinkClass]:
        out = [LinkClass(self.port_gbps, self.n * self.n_nics, tier="access",
                         optical=not self.access_copper)]
        for i, (d, l) in enumerate(zip(self.dims, self.links_per_dim)):
            if d <= 1:
                continue
            # every switch contributes l in-dim links; each link joins 2
            count = self.n * self.switches_per_plane * l // 2
            if (self.switches_per_plane * l) % 2:
                raise ValueError(f"odd link endpoint count in dim {i}")
            out.append(LinkClass(self.port_gbps, count, tier=f"dim{i}"))
        return out

    @property
    def diameter(self) -> int:
        # one switch-switch hop per dimension with >1 switch, plus 2 access
        return 2 + sum(1 for d in self.dims if d > 1)

    def avg_hops(self) -> float:
        # P(coordinate differs in dim i) = (D_i - 1)/D_i for uniform pairs
        return 2.0 + sum((d - 1) / d for d in self.dims if d > 1)

    def bisection_links(self) -> int:
        """Worst (minimum) dimension-aligned even bisection, all planes."""
        best = None
        for d, l in zip(self.dims, self.links_per_dim):
            if d <= 1:
                continue
            h = d // 2
            per_pair = l / (d - 1)  # trunked multiplicity per neighbour pair
            crossing = (self.switches_per_plane // d) * h * (d - h) * per_pair
            total = self.n * crossing
            if best is None or total < best:
                best = total
        return 0 if best is None else int(round(best))

    def feasibility(self, switch: SwitchModel | None = None):
        sw = switch or self.switch
        radix = sw.radix_at(self.port_gbps)
        return [
            (1 <= self.n <= 8,
             f"n={self.n} planes out of range [1,8] (paper assumes n<=8)"),
            (self.radix_used <= radix,
             f"radix used {self.radix_used} > breakout radix {radix} "
             f"at {self.port_gbps} Gbps"),
        ]

    @staticmethod
    def max_scale(n: int, k: int, D: int) -> int:
        """Eq. 2: NICs of the balanced maximum-scale MPHX."""
        side = n * k // (D + 1)
        return side ** (D + 1)

    @staticmethod
    def balanced(n: int, k: int, D: int,
                 nic_bw_gbps: float = 1600.0) -> "MPHX":
        """The balanced maximum-scale network behind Eq. 2."""
        side = n * k // (D + 1)
        return MPHX(n=n, p=side, dims=(side,) * D, nic_bw_gbps=nic_bw_gbps)

    def coord_to_id(self, coord: tuple[int, ...]) -> int:
        idx = 0
        for c, d in zip(coord, self.dims):
            idx = idx * d + c
        return idx

    def id_to_coord(self, idx: int) -> tuple[int, ...]:
        coord = []
        for d in reversed(self.dims):
            coord.append(idx % d)
            idx //= d
        return tuple(reversed(coord))

    def build_graph(self) -> SwitchGraph:
        """One plane's switch graph (all n planes are identical copies);
        a dimension's ``links_per_dim`` spread evenly over its
        ``D_i - 1`` neighbours."""
        g = SwitchGraph(self.switches_per_plane, self.p, self.port_gbps,
                        name=self.name)
        for idx in range(self.switches_per_plane):
            coord = self.id_to_coord(idx)
            for i, (d, l) in enumerate(zip(self.dims, self.links_per_dim)):
                if d <= 1:
                    continue
                mult = l / (d - 1)
                for c in range(coord[i] + 1, d):
                    other = list(coord)
                    other[i] = c
                    g.add_edge(idx, self.coord_to_id(tuple(other)), mult,
                               tier=f"dim{i}")
        return g


def flattened_butterfly(p: int, side: int, D: int, **kw) -> MPHX:
    """Flattened Butterfly = HyperX restricted to equal dims [Kim ISCA'07]."""
    return MPHX(n=1, p=p, dims=(side,) * D, **kw)


def table2_mphx_rows() -> list[MPHX]:
    """The four MPHX configurations of Table 2 (B=1.6T NIC, 102.4T
    switch)."""
    return [
        MPHX(n=1, p=16, dims=(16, 16, 16), name="1-Plane 3D HyperX"),
        MPHX(n=2, p=41, dims=(41, 41), name="2-Plane 2D HyperX"),
        # dim 2 keeps 85 links like dim 1 -> trunked over its 8 neighbours
        MPHX(n=4, p=86, dims=(86, 9), links_per_dim=(85, 85),
             name="4-Plane 2D HyperX"),
        MPHX(n=8, p=256, dims=(256,), name="8-Plane 1D HyperX"),
    ]
