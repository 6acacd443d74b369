"""repro_torch — the MPHX flow simulator, the dense and MoE decoder LMs and
the RG-LRU hybrid LM on PyTorch and CUDA.

A port of the JAX package ``repro`` (the reference, which stays as it
is) to PyTorch on an NVIDIA Hopper GPU.  Module names mirror the
reference so each counterpart is easy to find
(``repro_torch/core/hyperx.py`` ↔ ``repro/core/hyperx.py``).

The package imports ``torch`` and ``numpy`` only.  Every entry point
takes ``device=None``, which means ``"cuda"``; with no GPU present it
raises and asks for ``device="cpu"`` instead of quietly running on the
CPU (:mod:`repro_torch._device`).
"""

from ._device import (KERNEL_BACKENDS, SIM_BACKENDS, resolve_device,
                      resolve_kernel_backend, resolve_sim_backend)

__all__ = ["KERNEL_BACKENDS", "SIM_BACKENDS", "resolve_device",
           "resolve_kernel_backend", "resolve_sim_backend"]
