"""Topology presets of the sweep and sim suites: the four MPHX presets
of ``repro/experiments/sweep.py::SWEEP_TOPOLOGIES`` (the graph-engine
baselines are not ported yet)."""

from __future__ import annotations

import os

from ..core.hyperx import MPHX

DEFAULT_OUTDIR = os.path.join("results", "experiments_torch")

SWEEP_TOPOLOGIES: "dict[str, MPHX]" = {
    # small — fast, and exactly comparable against the reference
    "mphx-2p-8x8": MPHX(n=2, p=8, dims=(8, 8)),
    # medium — 4k NICs
    "mphx-2p-16x16": MPHX(n=2, p=16, dims=(16, 16)),
    # Table 2 row: 66,564 NICs, trunked dim 2
    "mphx-4p-86x9": MPHX(n=4, p=86, dims=(86, 9), links_per_dim=(85, 85),
                         name="4-Plane 2D HyperX"),
    # Table 2 row: 65,536 NICs, single full-mesh dimension
    "mphx-8p-256": MPHX(n=8, p=256, dims=(256,), name="8-Plane 1D HyperX"),
}
