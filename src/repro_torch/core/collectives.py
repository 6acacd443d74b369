"""Multi-plane collectives (port of ``repro/core/collectives.py``).

So far only the chunk count of a sprayed collective,
:func:`plane_chunk_count`, which the collective scenarios use to size
their chunk schedules.  The reference's mesh collectives
(``multiplane_psum`` and the rest, on JAX's ``shard_map``) are not
ported yet; their counterpart will run on ``torch.distributed``.
"""

from __future__ import annotations


def plane_chunk_count(size: int, n_planes: int) -> int:
    """Number of per-plane chunks a sprayed collective splits into: the
    largest ``n <= n_planes`` dividing ``size`` evenly, or 1 (no split).
    Used by :mod:`repro_torch.experiments.scenarios` to size collective
    chunk schedules."""
    n = min(n_planes, size)
    if size % n:
        return 1
    return n
