"""The RG-LRU linear recurrence of every recurrent block's prefill.

Port of ``repro/kernels/rg_lru`` (Pallas) to CUDA C++ for ``sm_90a``:
``csrc/lru_scan.cu`` (the kernel, built by
:mod:`repro_torch.kernels._build`), ``ops.py`` (the checked wrapper and
its launch count) and ``ref.py`` (the plain PyTorch version).  The gates
that feed it (the reference's ``rg_lru_pallas``) live with the model, in
:func:`repro_torch.models.rglru.rg_lru_scan`.
"""

from .ops import LAUNCHES, lru_scan, reset_launch_counts
from .ref import lru_scan_ref

__all__ = ["LAUNCHES", "lru_scan", "lru_scan_ref", "reset_launch_counts"]
