"""Checked wrapper of the CUDA RMSNorm, its plan, and its launch count.

``rmsnorm(x, scale, eps)`` keeps the meaning of the Pallas kernel it
replaces (``repro/kernels/rmsnorm/kernel.py``): per row of ``x`` (N, D),
``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, returned in x's dtype.

The checks run the same way on every device.  Then, for a tensor on the
CPU the wrapper returns the plain PyTorch version (:mod:`.ref`); for a
CUDA tensor it launches the kernel or raises: there is no fallback.
``LAUNCHES`` counts kernel launches: one is added where the kernel is
launched, and nowhere else.

The launch path is thin, since at decode the host's work is most of a
call's time.  Host us a call on the H100's host (an NVIDIA H100 80GB
HBM3 at 700 W), each part timed alone by ``tools/rmsnorm_times.py`` at
the serve paths' six shapes, decide each step: the tensors' attributes
are read once (the checks take 1.0-2.3 us);
the output comes from ``torch.empty_like`` (2.4-5.8 us, against 3.8-8.5
for ``torch.empty`` with a dtype and a device); the stream from
``torch._C._cuda_getCurrentRawStream`` (0.09-0.19 us, against 2.9-6.7
for ``torch.cuda.current_stream(dev).cuda_stream``, which builds a
``torch.cuda.Stream``; both give the stream that a CUDA graph capture or
a ``torch.cuda.stream`` block made current); there is no
``torch.cuda.device`` context (2.1-5.0 us): the C entry point makes the
device current only when it is not; and the dtype, the route, the
vectors a thread, the device and D travel in one cached word
(``LAUNCH_WORD``), the row count, row stride and word as pointer-sized
integers: ctypes alone takes 0.9-2.0 us so, against 1.6-4.6 for twelve
plain ``c_int`` / ``c_int64`` arguments, which lost to ``F.rms_norm`` at
yi-9b decode in two runs out of two where the word won at all six
shapes.  The whole wrapper takes 11.3-18.9 us, ``F.rms_norm`` 12.6-22.2
in the same runs.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import CudaLibrary, LaunchWord
from .._grad import refuse_graph_inputs
from .ref import rmsnorm_backward_ref, rmsnorm_ref

# the forward's launches and the backward's (csrc/rmsnorm_backward.cu; its
# two passes, rows then dscale, are one launch)
LAUNCHES = {"rmsnorm": 0, "rmsnorm_backward": 0}

LIBRARY = CudaLibrary(
    "rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",
    # the row count, the row stride and the launch word are integers in
    # pointer-sized arguments, which ctypes converts faster than c_int64
    {"rmsnorm_forward": [ctypes.c_void_p] * 5 + [ctypes.c_float]
     + [ctypes.c_void_p] * 2})
# the entry point's word (csrc/rmsnorm.cu decodes it): the dtype's code,
# the route's, the plan's vecs, the CUDA device and D
LAUNCH_WORD = LaunchWord(dtype=1, route=2, vecs=4, device=8, d=31)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# the kernel's routes (csrc/rmsnorm.cu)
ROUTE_CODES = {"register": 0, "loop": 1, "narrow": 2}
# rows shorter than this take the narrow route (one warp a row)
NARROW_BELOW = 1024
# the register route: 16-byte vectors a thread (the kernel's instances),
# and the block sizes tried in turn (the kernel's launch bound is the last)
REGISTER_VECS = (1, 2, 4, 8)
REGISTER_THREADS = (256, 512)
# the loop and narrow routes' block (csrc/rmsnorm.cu's kBlock)
LOOP_THREADS = 256


class Plan(NamedTuple):
    """How the kernel runs a row of D values.  ``route``: "register" (one
    pass, the row in registers), "loop" or "narrow" (the two-pass loop, a
    block or a warp a row); ``threads``: a block's threads; ``vecs``: the
    16-byte vectors each thread holds on the register route, 0 on the
    other two (which load 16-byte vectors where the rows allow)."""
    route: str
    threads: int
    vecs: int


@functools.lru_cache(maxsize=None)
def plan(d: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The route and block for rows of ``d`` values of ``dtype``;
    ``aligned``: x's and scale's pointers, D and the row stride all fall
    on 16 bytes.  The register route splits the row's vectors evenly over
    whole warps, with the fewest vectors a thread that keep the block
    within 256 threads, else within 512; a row that no such split fits
    takes the loop route."""
    if d < NARROW_BELOW:
        return Plan("narrow", LOOP_THREADS, 0)
    if aligned:
        n_vec = d * _ELEMENT_BYTES[dtype] // 16
        for cap in REGISTER_THREADS:
            for vecs in REGISTER_VECS:
                threads = n_vec // vecs
                if n_vec % vecs == 0 and threads % 32 == 0 \
                        and threads <= cap:
                    return Plan("register", threads, vecs)
    return Plan("loop", LOOP_THREADS, 0)


def aligned_rows(x_ptr: int, scale_ptr: int, d: int, ld: int,
                 dtype: torch.dtype) -> bool:
    """Whether x's and scale's pointers, D and the row stride ``ld``
    (elements) all fall on 16 bytes.  The output, from
    ``torch.empty_like``, always does: the caching allocator aligns
    every block to 512 bytes (and the entry point refuses a register
    plan on an unaligned one)."""
    elt = _ELEMENT_BYTES[dtype]
    return not (x_ptr | scale_ptr | d * elt | ld * elt) & 15


def call_plan(x: torch.Tensor, scale: torch.Tensor) -> Plan:
    """The plan that ``rmsnorm(x, scale)`` launches."""
    _, dtype, _, d, ld = check_inputs(x, scale)
    return plan(d, dtype, aligned_rows(x.data_ptr(), scale.data_ptr(), d,
                                       ld, dtype))


@functools.lru_cache(maxsize=None)
def launch_word(d: int, dtype: torch.dtype, aligned: bool,
                device: int) -> int:
    """The entry point's ``LAUNCH_WORD`` for rows of ``d`` values of
    ``dtype`` on CUDA device ``device``."""
    p = plan(d, dtype, aligned)
    return LAUNCH_WORD.pack(dtype=_DTYPE_CODES[dtype],
                            route=ROUTE_CODES[p.route], vecs=p.vecs,
                            device=device, d=d)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_inputs(x: torch.Tensor, scale: torch.Tensor
                 ) -> "tuple[torch.device, torch.dtype, int, int, int]":
    """The wrapper's checks, the same on every device.  Reads each of x's
    attributes once; returns (device, dtype, N, D, row stride)."""
    shape, dtype, dev = x.shape, x.dtype, x.device
    if len(shape) != 2 or scale.shape != (shape[1],):
        raise ValueError(f"rmsnorm: x must be (N, D) and scale (D,), got "
                         f"{tuple(shape)} and {tuple(scale.shape)}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: x must be float32 or bfloat16, got "
                        f"{dtype}")
    if scale.dtype != dtype:
        raise TypeError(f"rmsnorm: scale must have x's dtype {dtype}, got "
                        f"{scale.dtype}")
    if scale.device != dev:
        raise ValueError("rmsnorm: x and scale lie on different devices")
    n, d = shape
    stride = x.stride()
    ld = stride[0] if n > 1 else d
    if (stride[1] != 1 and d > 1) or ld < d or not scale.is_contiguous():
        raise ValueError("rmsnorm: x's rows must be contiguous and not "
                         f"overlap (strides {stride}), scale contiguous")
    return dev, dtype, n, d, ld


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (N, D) bf16 or float32, rows contiguous (a row stride is
    allowed); scale: (D,) of x's dtype, contiguous.  Returns a contiguous
    (N, D)."""
    dev, dtype, n, d, ld = check_inputs(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        refuse_graph_inputs("rmsnorm", x, scale)
    if not x.is_cuda:   # not dev.type, which builds a string each call
        if dev.type == "cpu":
            return rmsnorm_ref(x, scale, eps)
        raise ValueError(f"rmsnorm: no kernel for device {dev}")
    # contiguous: an x that passes the checks is either dense with rows
    # of D (so empty_like keeps its contiguous strides) or not dense (so
    # empty_like lays the output out contiguously)
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    xp, sp = x.data_ptr(), scale.data_ptr()
    idx = dev.index
    rc = LIBRARY.function("rmsnorm_forward")(
        xp, sp, out.data_ptr(), n, ld, eps,
        launch_word(d, dtype, aligned_rows(xp, sp, d, ld, dtype), idx),
        torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        LIBRARY.fail("rmsnorm", rc)
    LAUNCHES["rmsnorm"] += 1
    return out


# ----------------------------------------------------------------- backward

BACKWARD_LIBRARY = CudaLibrary(
    "rmsnorm_backward",
    Path(__file__).resolve().parent / "csrc" / "rmsnorm_backward.cu",
    {"rmsnorm_backward": [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5
     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})
# blocks the backward spreads the rows over: four a streaming
# multiprocessor of the H100's 132, a constant so that a shape's grouping
# (and so dscale's bits) is the same on every card
BACKWARD_BLOCKS = 4 * 132


def backward_rows_per_block(n: int, d: int) -> int:
    """Rows each block of the backward kernel owns: about N /
    BACKWARD_BLOCKS, a multiple of the rows a block has in flight (8 for
    D < NARROW_BELOW, one a warp; 1 else)."""
    rows = 8 if d < NARROW_BELOW else 1
    slots = -(-n // rows)
    return rows * max(1, -(-slots // BACKWARD_BLOCKS))


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6
                     ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The gradient of :func:`rmsnorm`: x (N, D) (a row stride allowed),
    scale (D,), dy (N, D) the output's gradient -> (dx (N, D) contiguous
    in x's dtype, dscale (D,)).  On the CPU the plain version
    (:func:`~.ref.rmsnorm_backward_ref`); on the card the kernel of
    ``csrc/rmsnorm_backward.cu``, or it raises."""
    dev, dtype, n, d, ld = check_inputs(x, scale)
    if dy.shape != x.shape or dy.dtype != dtype or dy.device != dev:
        raise ValueError(f"rmsnorm_backward: dy must match x {tuple(x.shape)}"
                         f" {dtype}, got {tuple(dy.shape)} {dy.dtype}")
    refuse_graph_inputs("rmsnorm_backward", x, scale, dy)
    if dev.type == "cpu":
        return rmsnorm_backward_ref(x, scale, dy, eps)
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_backward: no kernel for device {dev}")
    if (dy.stride(-1) != 1 and d > 1) or (n > 1 and dy.stride(0) < d):
        dy = dy.contiguous()     # autograd may hand over an expanded one
    ld_dy = dy.stride(0) if n > 1 else d
    dx = torch.empty((n, d), dtype=dtype, device=dev)
    dscale = torch.empty_like(scale)
    if n == 0 or d == 0:
        return dx, dscale.zero_()
    rpb = backward_rows_per_block(n, d)
    partial = torch.empty((-(-n // rpb), d), dtype=torch.float32,
                          device=dev)
    idx = dev.index
    rc = BACKWARD_LIBRARY.function("rmsnorm_backward")(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(), n, d, ld, ld_dy, rpb, eps,
        _DTYPE_CODES[dtype], idx, torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        BACKWARD_LIBRARY.fail("rmsnorm_backward", rc)
    LAUNCHES["rmsnorm_backward"] += 1
    return dx, dscale


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` with its gradient from :func:`rmsnorm_backward`:
    the forward kernel and the backward kernel on the card, their plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm_differentiable(x: torch.Tensor, scale: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` where autograd may follow it: through
    :class:`RMSNorm` when grad mode is on and an input requires grad,
    else the wrapper itself (no autograd node on the serve path)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return rmsnorm(x, scale, eps)
