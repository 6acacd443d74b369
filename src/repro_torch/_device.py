"""Device and solver-backend resolution: the port's one device contract.

* ``device=None`` means ``"cuda"``.  When no GPU is present that raises
  a ``RuntimeError`` asking for ``device="cpu"`` / ``--device cpu``; the
  port never carries on, on the CPU, unasked.
* Backends, of the flow solver and of the model's kernels alike:
  ``cuda`` runs the hand-written kernels of :mod:`repro_torch.kernels`
  (their wrappers take the plain PyTorch version only for tensors that
  lie on the CPU); ``torch`` runs the plain PyTorch versions on any
  device.  There is no ``auto``.
"""

from __future__ import annotations

import torch

SIM_BACKENDS = KERNEL_BACKENDS = ("cuda", "torch")


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.  A bare
    ``cuda`` names the current card by its index, so the device compares
    equal to that of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --device cpu) to run the port on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for off
    the card), so that a wall clock read next includes it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resolve_backend(backend: "str | None", what: str) -> str:
    backend = "cuda" if backend is None else backend
    if backend not in SIM_BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}; "
                         f"expected one of {SIM_BACKENDS}")
    return backend


def resolve_sim_backend(backend: "str | None" = None) -> str:
    """Normalize a fair-share solver backend name (``None`` = ``cuda``)."""
    return _resolve_backend(backend, "fairshare")


def resolve_kernel_backend(backend: "str | None" = None) -> str:
    """Normalize a model kernel backend name (``None`` = ``cuda``)."""
    return _resolve_backend(backend, "kernel")
