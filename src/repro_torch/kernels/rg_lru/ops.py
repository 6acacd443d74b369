"""Checked wrapper of the CUDA RG-LRU scan, its plan, and its launch count.

``lru_scan(a, b, h0=None)`` keeps the meaning of the Pallas kernel it
replaces (``repro/kernels/rg_lru/kernel.py::lru_scan``): the linear
recurrence ``y[:, t] = a[:, t] * y[:, t-1] + b[:, t]`` over (B, S, W)
float32 from ``h0`` (B, W) (zeros when None), returning ``y`` and the
final state ``h_last = y[:, -1]`` (its own contiguous (B, W) tensor).
The kernel does each step as the plain version does (a rounded multiply,
then a rounded add, in time order), so it equals :func:`.ref.lru_scan_ref`
bit for bit.

The checks run the same way on every device.  Then, for tensors on the
CPU the wrapper returns the plain PyTorch version (:mod:`.ref`); for
CUDA tensors it launches the kernel or raises: there is no fallback.
``LAUNCHES`` counts kernel launches: one is added where the kernel is
launched, and nowhere else.

The kernel's block and ring are constants (``THREADS``, ``STAGES``,
``STEPS``, as ``csrc/lru_scan.cu`` fixes them); the plan (``plan``)
picks only the width of its moves, from W and the inputs' alignment.
The launch path is RMSNorm's (``rmsnorm/ops.py``): the tensors'
attributes are read once, the stream comes from
``torch._C._cuda_getCurrentRawStream``, there is no
``torch.cuda.device`` context (the C entry point makes the device
current only when it is not), and the plan and the device travel in one
cached word (``LAUNCH_WORD``), B, S and W as pointer-sized integers.
Its host time a call, split into its parts and beside the first
wrapper's, is in ``PERF.md`` (section 6, the scan's redesign), from
``tools/lru_scan_times.py``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import CudaLibrary, LaunchWord
from .._grad import refuse_graph_inputs
from .ref import lru_scan_ref

LAUNCHES = {"lru_scan": 0}

LIBRARY = CudaLibrary(
    "lru_scan", Path(__file__).resolve().parent / "csrc" / "lru_scan.cu",
    # five pointers, then B, S, W and the launch word as integers in
    # pointer-sized arguments (which ctypes converts faster than
    # c_int64), then the stream
    {"lru_scan_forward": [ctypes.c_void_p] * 10})
# the entry point's word (csrc/lru_scan.cu decodes it): the plan's floats
# a lane in each copy and store, and the CUDA device
LAUNCH_WORD = LaunchWord(vec=3, device=8)
# the kernel's instances: floats a lane in each copy and store
VECS = (1, 4)

# csrc/lru_scan.cu's kThreads, kStages and kSteps: threads a block (a warp
# to each 32 columns) and a ring of STAGES slots of STEPS time steps of a
# warp's a and b rows in shared memory; the best of
# tools/lru_scan_times.py's sweep at recurrentgemma-2b's prefill on the
# H100
THREADS, STAGES, STEPS = 32, 4, 16
# a block's shared memory: each warp's ring of a and b rows and its stage
# of y rows, float32
SHARED_BYTES = THREADS // 32 * (2 * STAGES + 1) * STEPS * 128


def grid(batch: int, width: int) -> "tuple[int, int]":
    """The launch grid: column blocks over W, then B."""
    return -(-width // THREADS), batch


def aligned_inputs(a_ptr: int, b_ptr: int) -> bool:
    """Whether a and b both start on 16 bytes (the caching allocator
    aligns every block to 512, so y does; a view with an offset may
    not)."""
    return not (a_ptr | b_ptr) & 15


def plan(width: int, aligned: bool) -> int:
    """The plan for a scan over W = ``width`` columns whose a and b start
    on 16 bytes or not (``aligned``, from ``aligned_inputs``): floats a
    lane in each copy and store, 4 (16 bytes) where a and b are aligned
    and W is a multiple of 4, else 1."""
    return 4 if aligned and not width & 3 else 1


def call_plan(a: torch.Tensor, b: torch.Tensor) -> int:
    """The plan that ``lru_scan(a, b, h0)`` launches."""
    return plan(a.shape[2], aligned_inputs(a.data_ptr(), b.data_ptr()))


@functools.lru_cache(maxsize=None)
def launch_word(vec: int, device: int) -> int:
    """The entry point's ``LAUNCH_WORD`` for ``vec`` floats a lane on CUDA
    device ``device``."""
    return LAUNCH_WORD.pack(vec=vec, device=device)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_inputs(a: torch.Tensor, b: torch.Tensor,
                 h0: "torch.Tensor | None"
                 ) -> "tuple[torch.device, int, int, int]":
    """The wrapper's checks, the same on every device.  Reads each of a's
    attributes once; returns (device, B, S, W)."""
    shape, dev = a.shape, a.device
    if len(shape) != 3 or b.shape != shape:
        raise ValueError(f"lru_scan: a and b must be one (B, S, W) shape, "
                         f"got {tuple(shape)} and {tuple(b.shape)}")
    B, S, W = shape
    if h0 is not None and h0.shape != (B, W):
        raise ValueError(f"lru_scan: h0 must be (B, W) = {(B, W)}, got "
                         f"{tuple(h0.shape)}")
    tensors = (a, b) if h0 is None else (a, b, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("lru_scan: a, b and h0 must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != dev for t in tensors):
        raise ValueError("lru_scan: inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lru_scan: a, b and h0 must be contiguous")
    return dev, B, S, W


def lru_scan(a: torch.Tensor, b: torch.Tensor,
             h0: "torch.Tensor | None" = None
             ) -> "tuple[torch.Tensor, torch.Tensor]":
    """a, b: (B, S, W) float32, h0: (B, W) float32 or None, all
    contiguous -> (y (B,S,W), h_last (B,W))."""
    dev, B, S, W = check_inputs(a, b, h0)
    refuse_graph_inputs("lru_scan", a, b, h0)
    if not a.is_cuda:   # not dev.type, which builds a string each call
        if dev.type == "cpu":
            return lru_scan_ref(a, b, h0)
        raise ValueError(f"lru_scan: no kernel for device {dev}")
    y = torch.empty_like(a)
    if S == 0 or B == 0 or W == 0:
        h_last = h0.clone() if h0 is not None else a.new_zeros((B, W))
        return y, h_last
    h_last = a.new_empty((B, W))
    ap, bp, idx = a.data_ptr(), b.data_ptr(), dev.index
    rc = LIBRARY.function("lru_scan_forward")(
        ap, bp, None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), B, S, W,
        launch_word(plan(W, aligned_inputs(ap, bp)), idx),
        torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        LIBRARY.fail("lru_scan", rc)
    LAUNCHES["lru_scan"] += 1
    return y, h_last
