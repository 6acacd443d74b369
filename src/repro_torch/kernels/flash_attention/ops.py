"""Checked wrappers of the CUDA flash attention, and its launch count.

``flash_attention(q, k, v, q_pos, kv_pos, causal=, window=)`` is the
model's attention (:mod:`.ref`): q (B, Sq, K, G, Dh), k and v
(B, Skv, K, Dh) with any strides whose last dimension is contiguous (a
ring cache's (B, cap, K, Dh) slice is read in place), q_pos (Sq,) and
kv_pos (Skv,) int32 shared across the batch, ``kv_pos < 0`` marking an
empty cache slot.  ``flash_attention_kernel_layout(q, k, v)`` takes the
Pallas kernel's layout and meaning instead (q (B, H, Sq, Dh), k and v
(B, K, Skv, Dh), queries right-aligned to the kv tail), as views of the
same call.

For tensors on the CPU the wrappers return the plain PyTorch version.
For CUDA tensors they launch a kernel or raise; there is no fallback.
Three routes serve a CUDA call, chosen by :func:`_route` from the dtype
and Sq alone: the split-KV decode kernel (``"decode"``) for every call
with one query position, in bfloat16 and float32; the tensor-core kernel
(``"tc"``) for bfloat16 with more than one (prefill, window waves); the
CUDA-core kernel (``"simt"``) for float32 with more than one.

``flash_attention_with_lse`` is the same call that also returns each
row's natural-log LSE, (B, K, Sq, G) float32 (the log-sum-exp of the
row's scaled, attended scores; ``ref.NEG_INF`` for a row that attends
nothing), which the ``tc`` and ``simt`` routes write beside the output
(the output keeps its bits), and ``None`` on the decode route, which
writes none; :func:`~.ref.attention_lse_ref` is its plain twin.  The
autograd function saves it for the backward.

The backward has two routes, chosen by :func:`_backward_route` from the
dtype alone: ``"tc"`` (tensor cores) for bfloat16, ``"simt"`` (CUDA
cores, fp32) for float32.  Given the forward's LSE, neither recomputes
it; without it the ``simt`` route's pre-pass does, and the ``tc`` route
takes it from a launch of the forward's ``tc`` kernel.

``LAUNCHES["flash_attention"]`` counts the calls of every forward route,
``LAUNCHES["flash_attention_tc"]`` and
``LAUNCHES["flash_attention_decode"]`` those of their routes,
``LAUNCHES["flash_attention_backward"]`` the backward's calls and
``LAUNCHES["flash_attention_backward_tc"]`` those of its ``tc`` route; one
is added where a kernel is launched, and nowhere else (the decode route's
two passes, split and combine, are one launch, and so are the backward's
passes: D (and the LSE where the ``simt`` route computes it), dK/dV and
dQ).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from .._build import CudaLibrary
from .._grad import refuse_graph_inputs
from .ref import attention_backward_ref, attention_lse_ref, attention_ref

LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_decode": 0, "flash_attention_backward": 0,
            "flash_attention_backward_tc": 0}
HEAD_DIMS = (16, 32, 64, 128, 256)
# the decode route's split count: enough (batch, kv head, split) blocks for
# two on each of the H100's 132 SMs, and no more splits than the kernel's
# 32-key tiles
DECODE_TARGET_BLOCKS = 2 * 132
DECODE_TILE_KEYS = 32

# q, k, v, out, q_pos, kv_pos, dims, scale, dtype code, then the LSE
# buffer (simt and tc) or the workspace and the split count (decode), then
# the stream
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
         ctypes.c_float, ctypes.c_int]
# the C entry point of each route
ENTRY_POINTS = {"simt": "flash_attention_forward",
                "tc": "flash_attention_forward_tc",
                "decode": "flash_attention_forward_decode"}
LIBRARY = CudaLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {ENTRY_POINTS["simt"]: _ARGS + [ctypes.c_void_p, ctypes.c_void_p],
     ENTRY_POINTS["tc"]: _ARGS + [ctypes.c_void_p, ctypes.c_void_p],
     ENTRY_POINTS["decode"]: _ARGS + [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _route(dtype: torch.dtype, sq: int) -> str:
    """The kernel of a CUDA call: ``"decode"`` (split KV, CUDA cores) for
    Sq = 1 in either dtype, ``"tc"`` (tensor cores) for bfloat16 with
    Sq > 1, ``"simt"`` (CUDA cores, fp32) for float32 with Sq > 1."""
    if sq == 1:
        return "decode"
    return "tc" if dtype == torch.bfloat16 else "simt"


def _backward_route(dtype: torch.dtype) -> str:
    """The backward kernel of a CUDA call: ``"tc"`` (tensor cores) for
    bfloat16, ``"simt"`` (CUDA cores, fp32) for float32."""
    return "tc" if dtype == torch.bfloat16 else "simt"


def decode_splits(batch: int, kv_heads: int, skv: int) -> int:
    """Splits of the cache on the decode route, split s holding the
    ceil(Skv / splits) slots of :func:`~.ref.split_range`: enough that no
    split spans more than t of the kernel's 32-key tiles, t the most (at
    least 1) that still gives DECODE_TARGET_BLOCKS (batch, kv head,
    split) blocks.  So the blocks reach the target wherever the cache has
    tiles enough, and there are never more splits than tiles."""
    want = -(-DECODE_TARGET_BLOCKS // (batch * kv_heads))
    tiles = -(-skv // DECODE_TILE_KEYS)
    per_split = max(1, tiles // want) * DECODE_TILE_KEYS
    return -(-skv // per_split)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v, q_pos, kv_pos, window) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, Sq, K, G, Dh) and "
                         "k, v (B, Skv, K, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, K, _, Dh = q.shape
    if k.shape[0] != B or k.shape[2] != K or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if q_pos.shape != (Sq,) or kv_pos.shape != (k.shape[1],):
        raise ValueError(f"flash_attention: q_pos must be ({Sq},) and kv_pos "
                         f"({k.shape[1]},), got {tuple(q_pos.shape)} and "
                         f"{tuple(kv_pos.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype, "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("flash_attention: positions must be int32")
    if any(t.device != q.device for t in (k, v, q_pos, kv_pos)):
        raise ValueError("flash_attention: inputs lie on different devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")


def _head_stride(q: torch.Tensor, name: str = "q") -> int:
    """The element stride of the flattened query head k*G+g of a
    (B, S, K, G, Dh) tensor, which lies at k*stride(2) + g*stride(3)."""
    K, G = q.shape[2], q.shape[3]
    if K > 1 and G > 1 and q.stride(2) != G * q.stride(3):
        raise ValueError(f"flash_attention: {name}'s (K, G) axes must step "
                         "as one head axis")
    return q.stride(3) if G > 1 else q.stride(2)


def _loadable(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte loads can read ``t``: a contiguous
    last axis, the other strides multiples of 16 bytes, a 16-byte
    aligned start."""
    vec = 16 // t.element_size()
    strides = [s for s, n in zip(t.stride()[:-1], t.shape) if n > 1]
    return t.stride(-1) == 1 and not any(s % vec for s in strides) \
        and not t.data_ptr() % 16


def _check_strides(kernel: str, name: str, t: torch.Tensor) -> None:
    if not _loadable(t):
        raise ValueError(f"{kernel}: {name} must have a contiguous last "
                         "axis, strides that are multiples of "
                         f"{16 // t.element_size()} and a 16-byte aligned "
                         f"start, got strides {t.stride()}")


def _launch_forward(route: str, q, k, v, q_pos, kv_pos, causal, window,
                    out: torch.Tensor,
                    lse: Optional[torch.Tensor] = None) -> None:
    """Launch ``route``'s forward kernel on checked CUDA inputs into
    ``out``, and each row's LSE into ``lse`` where given (``simt`` and
    ``tc`` only), and count the launch."""
    B, Sq, K, G, Dh = q.shape
    dims = (ctypes.c_int64 * 20)(
        B, Sq, k.shape[1], K, G, Dh,
        q.stride(0), q.stride(1), _head_stride(q),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(3),
        int(causal), 0 if window is None else int(window))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(), dims, 1.0 / math.sqrt(Dh),
            _DTYPE_CODES[q.dtype]]
    with torch.cuda.device(q.device):
        if route == "decode":
            # each split's (m, l, o) of each query head, merged by the
            # kernel's second pass
            splits = decode_splits(B, K, k.shape[1])
            ws = torch.empty(B * K * G * splits * (Dh + 2),
                             dtype=torch.float32, device=q.device)
            args += [ws.data_ptr(), splits]
        else:
            args.append(None if lse is None else lse.data_ptr())
        LIBRARY.call("flash_attention", ENTRY_POINTS[route], *args,
                     torch.cuda.current_stream().cuda_stream)
    LAUNCHES["flash_attention"] += 1
    if route != "simt":
        LAUNCHES[f"flash_attention_{route}"] += 1


def _checked_cuda(kernel: str, q, k, v, q_pos, kv_pos) -> None:
    """The checks of a CUDA call beyond :func:`_check`: the device, the
    head dim, contiguous positions and loadable strides."""
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
    _head_stride(q)
    for name, t in (("q_pos", q_pos), ("kv_pos", kv_pos)):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strides(kernel, name, t)


def _lse_buffer(q: torch.Tensor) -> torch.Tensor:
    B, Sq, K, G, _ = q.shape
    return torch.empty(B, K, Sq, G, dtype=torch.float32, device=q.device)


def _attention(q, k, v, q_pos, kv_pos, causal, window, with_lse: bool
               ) -> "tuple[torch.Tensor, Optional[torch.Tensor]]":
    """The checked call of both forward wrappers: the output and, where
    ``with_lse`` and the route writes one, each row's LSE."""
    _check(q, k, v, q_pos, kv_pos, window)
    refuse_graph_inputs("flash_attention", q, k, v)
    route = _route(q.dtype, q.shape[1])
    with_lse = with_lse and route != "decode"
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                            window=window)
        lse = attention_lse_ref(q, k, q_pos, kv_pos, causal=causal,
                                window=window) if with_lse else None
        return out, lse
    _checked_cuda("flash_attention", q, k, v, q_pos, kv_pos)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = _lse_buffer(q) if with_lse else None
    if out.numel():
        _launch_forward(route, q, k, v, q_pos, kv_pos, causal, window, out,
                        lse)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The model's attention -> (B, Sq, K, G, Dh) in q's dtype."""
    return _attention(q, k, v, q_pos, kv_pos, causal, window, False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_pos: torch.Tensor,
                             kv_pos: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None
                             ) -> "tuple[torch.Tensor, Optional[torch.Tensor]]":
    """:func:`flash_attention` and each row's LSE, (B, K, Sq, G) float32,
    or ``None`` where the call's route writes none (decode, Sq = 1).  On
    the CPU the plain versions (:func:`~.ref.attention_lse_ref`)."""
    return _attention(q, k, v, q_pos, kv_pos, causal, window, True)


def right_aligned_positions(sq: int, skv: int, device
                            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The Pallas kernel's positions: kv 0..Skv-1, queries on the tail."""
    kv_pos = torch.arange(skv, dtype=torch.int32, device=device)
    q_pos = torch.arange(skv - sq, skv, dtype=torch.int32, device=device)
    return q_pos, kv_pos


def flash_attention_kernel_layout(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  window: Optional[int] = None
                                  ) -> torch.Tensor:
    """q (B, H, Sq, Dh); k, v (B, K, Skv, Dh) -> (B, H, Sq, Dh), queries
    right-aligned to the kv tail (``repro.kernels.flash_attention``)."""
    B, H, Sq, Dh = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError("H must be a multiple of K")
    q_pos, kv_pos = right_aligned_positions(Sq, Skv, q.device)
    qm = q.permute(0, 2, 1, 3).unflatten(2, (K, H // K))
    out = flash_attention(qm, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                          q_pos, kv_pos, causal=causal, window=window)
    return out.flatten(2, 3).permute(0, 2, 1, 3)


# ----------------------------------------------------------------- backward

# q, k, v, o, dO, dq, dk, dv, q_pos, kv_pos, dims, scale, dtype code, the
# LSE (or null), the workspace, the stream
_BACKWARD_ARGS = [ctypes.c_void_p] * 10 + [
    ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# the C entry point of each backward route
BACKWARD_ENTRY_POINTS = {"simt": "flash_attention_backward",
                         "tc": "flash_attention_backward_tc"}
BACKWARD_LIBRARY = CudaLibrary(
    "flash_attention_backward",
    Path(__file__).resolve().parent / "csrc" / "flash_attention_backward.cu",
    {entry: _BACKWARD_ARGS for entry in BACKWARD_ENTRY_POINTS.values()})


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, q_pos: torch.Tensor,
                             kv_pos: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             lse: Optional[torch.Tensor] = None
                             ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The gradient of :func:`flash_attention`: ``o`` its output and
    ``do`` the output's gradient, both (B, Sq, K, G, Dh) -> (dq
    (B, Sq, K, G, Dh), dk and dv (B, Skv, K, Dh)), contiguous, in q's
    dtype.  ``lse``: the forward's (:func:`flash_attention_with_lse`),
    (B, K, Sq, G) float32, or None.  On the CPU the plain version
    (:func:`~.ref.attention_backward_ref`); on the card the passes of
    ``csrc/flash_attention_backward.cu`` on :func:`_backward_route`'s
    route, or it raises.  Without ``lse`` the ``tc`` route takes it from
    the forward's ``tc`` kernel first (a forward launch, counted as one)."""
    _check(q, k, v, q_pos, kv_pos, window)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or o.device != q.device \
            or do.device != q.device:
        raise ValueError("flash_attention_backward: o and do must match q "
                         f"{tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)} {do.dtype}")
    B, Sq, K, G, Dh = q.shape
    if lse is not None and (lse.shape != (B, K, Sq, G)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError("flash_attention_backward: lse must be contiguous "
                         f"float32 {(B, K, Sq, G)} on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    refuse_graph_inputs("flash_attention_backward", q, k, v, o, do)
    if q.device.type == "cpu":
        return attention_backward_ref(q, k, v, o, do, q_pos, kv_pos,
                                      causal=causal, window=window, lse=lse)
    _checked_cuda("flash_attention_backward", q, k, v, q_pos, kv_pos)
    if not _loadable(do):
        do = do.contiguous()     # autograd may hand over any layout
    heads = {}
    for name, t in (("q", q), ("o", o), ("do", do)):
        heads[name] = _head_stride(t, name)
    for name, t in (("o", o), ("do", do)):
        _check_strides("flash_attention_backward", name, t)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    route = _backward_route(q.dtype)
    if route == "tc" and lse is None:
        lse = _lse_buffer(q)
        scratch = torch.empty_like(q, memory_format=torch.contiguous_format)
        _launch_forward("tc", q, k, v, q_pos, kv_pos, causal, window,
                        scratch, lse)
    dims = (ctypes.c_int64 * 23)(
        B, Sq, k.shape[1], K, G, Dh,
        q.stride(0), q.stride(1), heads["q"],
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), heads["o"],
        do.stride(0), do.stride(1), heads["do"],
        int(causal), 0 if window is None else int(window))
    # each row's D = sum dO . O, then (where none is given) its LSE
    ws = torch.empty((1 if lse is not None else 2) * B * K * Sq * G,
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        BACKWARD_LIBRARY.call(
            "flash_attention_backward", BACKWARD_ENTRY_POINTS[route],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(), dims, 1.0 / math.sqrt(Dh),
            _DTYPE_CODES[q.dtype], None if lse is None else lse.data_ptr(),
            ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
    LAUNCHES["flash_attention_backward"] += 1
    if route == "tc":
        LAUNCHES["flash_attention_backward_tc"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its gradient from
    :func:`flash_attention_backward`: the forward kernels (every route as
    it is, the LSE saved where the route writes one) and the backward
    kernel on the card, their plain versions on the CPU.  The positions
    and masks get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window):
        o, lse = flash_attention_with_lse(q, k, v, q_pos, kv_pos,
                                          causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, q_pos, kv_pos, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, q_pos, kv_pos, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, do, q_pos, kv_pos, causal=ctx.causal,
            window=ctx.window, lse=lse)
        return dq, dk, dv, None, None, None, None


def flash_attention_differentiable(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, q_pos: torch.Tensor,
                                   kv_pos: torch.Tensor, *,
                                   causal: bool = True,
                                   window: Optional[int] = None
                                   ) -> torch.Tensor:
    """:func:`flash_attention` where autograd may follow it: through
    :class:`FlashAttention` when grad mode is on and q, k or v requires
    grad, else the wrapper itself (no autograd node on the serve path)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window)
    return flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                           window=window)
