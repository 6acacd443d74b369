"""Checked wrappers of the CUDA grouped matmuls, and their launch counts.

``grouped_matmul(x, w)`` keeps the meaning of the Pallas kernel it
replaces (``repro/kernels/grouped_matmul/kernel.py::grouped_matmul``):
x (E, M, K) times w (E, K, N) per expert, fp32 accumulation, the result in
x's dtype.  ``ragged_grouped_matmul(x, w, group_sizes, block_m)`` keeps
that of ``ragged_grouped_matmul``: rows sorted by group, blocks of
``block_m`` rows owned by the group of their first row, foreign rows 0
(:func:`.ref.ragged_grouped_matmul_masked_ref`).  ``expert_ffn_matmul``
and ``megablocks_matmul`` are the reference's names for the two
(``repro/kernels/grouped_matmul/ops.py``).

For tensors on the CPU the wrappers return the plain PyTorch versions.
For CUDA tensors they launch a kernel or raise; there is no fallback.
Three routes serve a CUDA call, chosen by :func:`_route` from the dtype
and the rows of a tile (M, or ``min(block_m, T)`` for the ragged
variant) alone, both variants alike: ``"wgmma"`` (TMA-fed ``wgmma``,
warp-specialised) for bfloat16 with more than 64 rows, every prefill and
window wave; ``"mma"`` (``mma.sync``) for bfloat16 with at most 64, every
decode step; ``"f32"`` (CUDA cores) for float32.  The bfloat16 routes
take K and N that are multiples of 8 and 16-byte aligned operands (every
MoE width is); float32 takes any shape.

The ``mma`` route splits K where its grid would leave the card's slots
(blocks an SM times SMs) under-filled: :func:`splits_for` picks the
split count S once per call from the grid's blocks, the K tiles and the
slots, and S is 1 wherever the grid already fills the card (every shape
but mixtral's decode down, which takes 2 on the H100).  At S > 1 the
wrapper allocates an fp32 workspace (S, out's shape) for the call, and
the C entry point launches the split kernel and then the kernel that
adds the S partial sums in split order and rounds once, on the caller's
stream.  The other routes always run S = 1.

The launch path is thin, as RMSNorm's and the segment kernels': the
stream comes from ``torch._C._cuda_getCurrentRawStream``, there is no
``torch.cuda.device`` context (the C entry point makes the device
current only when it is not), and the entry point is the bound ctypes
function.  A call can be captured in a CUDA graph.

``LAUNCHES`` counts kernel launches: ``"grouped_matmul"`` and
``"ragged_grouped_matmul"`` every call of their variant on any route,
``"grouped_matmul_wgmma"`` the calls of either variant on the ``wgmma``
route, ``"grouped_matmul_splitk"`` those on the ``mma`` route with S > 1
(a split and its reduction); one is added where a kernel is launched,
and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import CudaLibrary
from .._grad import refuse_graph_inputs
from .ref import K_TILE, grouped_matmul_ref, ragged_grouped_matmul_masked_ref

LAUNCHES = {"grouped_matmul": 0, "ragged_grouped_matmul": 0,
            "grouped_matmul_wgmma": 0, "grouped_matmul_splitk": 0}
# the rows of a tile above which a bfloat16 call takes the wgmma route
MMA_MAX_ROWS = 64
# the mma kernel's output tile, rows and columns (csrc, ``Decode``)
MMA_TILE = (16, 128)
# the K splits the mma route takes, and the least share of its waves'
# slots a split grid must fill
SPLITS = (1, 2, 4, 8)
FILL = 0.9
# the entry point's code of each route
ROUTE_CODES = {"f32": 0, "mma": 1, "wgmma": 2}

LIBRARY = CudaLibrary(
    "grouped_matmul",
    Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu",
    {"grouped_matmul_forward": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p],
     "grouped_matmul_occupancy": [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]})

_DTYPES = (torch.float32, torch.bfloat16)


def _route(dtype: torch.dtype, tile_rows: int) -> str:
    """The kernel of a CUDA call: ``"f32"`` for float32, ``"wgmma"`` for
    bfloat16 with more than MMA_MAX_ROWS rows a tile, ``"mma"`` for
    bfloat16 with at most that many."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"grouped matmul: no route for {dtype}")
    return "wgmma" if tile_rows > MMA_MAX_ROWS else "mma"


def call_route(x: torch.Tensor, block_m: "int | None" = None) -> str:
    """The route of a CUDA call on ``x``: ``grouped_matmul``'s x
    (E, M, K) has M rows a tile, ``ragged_grouped_matmul``'s x (T, K)
    with ``block_m`` has ``min(block_m, T)``."""
    rows = x.shape[1] if block_m is None else min(block_m, x.shape[0])
    return _route(x.dtype, rows)


def occupancy(route: str) -> int:
    """Blocks of ``route``'s kernel that fit on one SM of the current
    card, from CUDA's occupancy calculator."""
    blocks = ctypes.c_int(0)
    LIBRARY.call("grouped_matmul", "grouped_matmul_occupancy",
                 ROUTE_CODES[route], ctypes.byref(blocks))
    return blocks.value


@functools.lru_cache(maxsize=None)
def slots(index: int) -> int:
    """Resident blocks of the mma kernel on CUDA device ``index``: its
    blocks an SM times the SMs, read once per device."""
    with torch.cuda.device(index):
        return occupancy("mma") * torch.cuda.get_device_properties(
            index).multi_processor_count


def splits_for(units: int, ktiles: int, slots: int) -> int:
    """K splits of an mma call whose grid has ``units`` blocks (row
    tiles x column tiles x experts) over ``ktiles`` K tiles, on a card
    with ``slots`` resident blocks: the least S in SPLITS that divides
    ``ktiles`` and whose ``units * S`` blocks fill at least FILL of the
    slots of their waves; 1 where none does."""
    for s in SPLITS:
        blocks = units * s
        if ktiles % s == 0 and blocks >= FILL * -(-blocks // slots) * slots:
            return s
    return 1


def _dims(x, w, block_m: "int | None") -> tuple:
    """The entry point's dims but the splits: ragged, E, rows, K, N,
    block_m (the ownership block cut to T; 0 for the grouped
    variant)."""
    if block_m is None:
        E, M, K = x.shape
        return (0, E, M, K, w.shape[2], 0)
    T, K = x.shape
    return (1, w.shape[0], T, K, w.shape[2], min(block_m, T))


def mma_units(dims) -> int:
    """Blocks of the mma kernel's grid for ``dims`` (:func:`_dims`), K
    unsplit: row tiles x column tiles x experts, as ``grid_for`` counts
    them (the ragged variant's row tiles cover each ownership block)."""
    ragged, E, rows, _, N, block_m = dims
    bm, bn = MMA_TILE
    cols = -(-N // bn)
    if ragged:
        return -(-rows // block_m) * -(-block_m // bm) * cols
    return -(-rows // bm) * cols * E


def _planned_splits(dims, route: str, index: int) -> int:
    """:func:`splits_for`'s S on the mma route, 1 off it."""
    if route != "mma":
        return 1
    return splits_for(mma_units(dims), -(-dims[3] // K_TILE), slots(index))


def call_splits(x: torch.Tensor, w: torch.Tensor,
                block_m: "int | None" = None) -> int:
    """The K splits of a CUDA call on ``x`` and ``w`` (``block_m`` for
    the ragged variant)."""
    return _planned_splits(_dims(x, w, block_m), call_route(x, block_m),
                           x.device.index)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, x, w, x_dim: int) -> None:
    if x.dim() != x_dim or w.dim() != 3 or x.shape[-1] != w.shape[1] or (
            x_dim == 3 and x.shape[0] != w.shape[0]):
        want = "(E, M, K)" if x_dim == 3 else "(T, K)"
        raise ValueError(f"{name}: x must be {want} and w (E, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must share one dtype, float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"{name}: x and w lie on different devices")


def _launch(name: str, x, w, out, group_sizes, dims, route: str,
            splits: "int | None" = None) -> None:
    """Launch ``route``'s kernel for ``dims`` (:func:`_dims`) into
    ``out``.  ``splits`` None takes :func:`splits_for`'s on the mma
    route and 1 on the others; a forced count (the tests') must be in
    SPLITS, divide ceil(K / K_TILE), and be 1 off the mma route."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous, got strides "
                         f"{x.stride()} and {w.stride()}")
    K, N = dims[3], dims[4]
    if x.dtype == torch.bfloat16 and (
            K % 8 or N % 8 or x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"{name}: the bfloat16 kernel needs K and N "
                         f"multiples of 8 and x and w 16-byte aligned, got "
                         f"K={K}, N={N}")
    idx = dev.index
    ktiles = -(-K // K_TILE)
    if splits is None:
        splits = _planned_splits(dims, route, idx)
    elif splits not in SPLITS or ktiles % splits or (
            splits > 1 and route != "mma"):
        raise ValueError(f"{name}: {splits} K splits on the {route} route "
                         f"with {ktiles} K tiles; the mma route takes one "
                         f"of {SPLITS} that divides them, the others 1")
    # the split's partial sums, for this call only: freed on return, after
    # the launches that use it were queued on this stream
    ws = None if splits == 1 else torch.empty(
        (splits, *out.shape), dtype=torch.float32, device=dev)
    rc = LIBRARY.function("grouped_matmul_forward")(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if group_sizes is None else group_sizes.data_ptr(),
        None if ws is None else ws.data_ptr(),
        (ctypes.c_int64 * 7)(*dims, splits), ROUTE_CODES[route], idx,
        torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        LIBRARY.fail(name, rc)
    LAUNCHES[name] += 1
    if route == "wgmma":
        LAUNCHES["grouped_matmul_wgmma"] += 1
    elif splits > 1:
        LAUNCHES["grouped_matmul_splitk"] += 1


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, M, K), w (E, K, N), contiguous -> (E, M, N) in x's dtype."""
    _check("grouped_matmul", x, w, 3)
    refuse_graph_inputs("grouped_matmul", x, w)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    out = x.new_empty((x.shape[0], x.shape[1], w.shape[2]))
    if out.numel() == 0:
        return out
    _launch("grouped_matmul", x, w, out, None, _dims(x, w, None),
            call_route(x))
    return out


def ragged_grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                          group_sizes: torch.Tensor,
                          block_m: int = 128) -> torch.Tensor:
    """x (T, K) rows sorted by group, w (E, K, N), group_sizes (E,)
    integer on x's device -> (T, N) in x's dtype.  ``block_m`` is the
    ownership granularity (the Pallas kernel's block rows)."""
    _check("ragged_grouped_matmul", x, w, 2)
    E = w.shape[0]
    if group_sizes.shape != (E,) or group_sizes.dtype.is_floating_point:
        raise ValueError(f"ragged_grouped_matmul: group_sizes must be ({E},) "
                         f"integers, got {tuple(group_sizes.shape)} "
                         f"{group_sizes.dtype}")
    if group_sizes.device != x.device:
        raise ValueError("ragged_grouped_matmul: group_sizes lies on another "
                         "device than x")
    if block_m < 1:
        raise ValueError(f"ragged_grouped_matmul: block_m must be >= 1, got "
                         f"{block_m}")
    refuse_graph_inputs("ragged_grouped_matmul", x, w)
    if x.device.type == "cpu":
        return ragged_grouped_matmul_masked_ref(x, w, group_sizes, block_m)
    out = x.new_empty((x.shape[0], w.shape[2]))
    if out.numel() == 0:
        return out
    sizes = group_sizes.to(torch.int32).contiguous()
    _launch("ragged_grouped_matmul", x, w, out, sizes,
            _dims(x, w, block_m), call_route(x, block_m))
    return out


def expert_ffn_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f): the products of
    ``repro_torch.models.moe._expert_ffn``."""
    return grouped_matmul(x, w)


def megablocks_matmul(x: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """Ragged (T, K) x per-group (E, K, N) -> (T, N), ownership blocks of
    128 rows."""
    return ragged_grouped_matmul(x, w, group_sizes)
