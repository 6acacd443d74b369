"""Plain PyTorch versions of the COO segment reductions.

The CPU path of :mod:`.ops` and the yardstick the CUDA kernels are held
against on the card.  Entries whose id lies outside ``[0, num_segments)``
are dropped, as the Pallas kernel drops its padding: they are sent to
one spare bin past the end, which is cut off.
"""

from __future__ import annotations

import torch


def _spare_bin_ids(segment_ids: torch.Tensor, num_segments: int):
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    return torch.where(keep, segment_ids, num_segments)


def segment_sum_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(NNZ,) values scatter-added into (num_segments,) bins."""
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, _spare_bin_ids(segment_ids, num_segments), values)
    return out[:num_segments]


def segment_min_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(NNZ,) values segment-min'd into (num_segments,) bins; empty
    segments hold +inf."""
    out = torch.full((num_segments + 1,), torch.inf, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, _spare_bin_ids(segment_ids, num_segments),
                        values, "amin")
    return out[:num_segments]
