"""The grouped matmuls' route table and launch counts, on the CPU.

A CUDA call takes one of three kernels, chosen by ``ops._route`` from the
dtype and the rows of a tile alone (M for ``grouped_matmul``,
``min(block_m, T)`` for ``ragged_grouped_matmul``): the TMA-fed
``wgmma`` kernel for bfloat16 with more than 64 rows, the ``mma.sync``
kernel for bfloat16 with at most 64, the CUDA-core kernel for float32.
The kernels run only on a GPU (``tests/test_torch_gpu.py``); here the
route's table is held, the wrappers' refusals of bad inputs, that the
CPU path (the plain versions, held against the JAX package in
``tests/test_torch_grouped_matmul.py``) launches nothing, the ``mma``
route's split plan (``ops.splits_for``), and the split's plain version
(``grouped_matmul_split_ref``) against the JAX package's grouped matmul.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels.grouped_matmul.ops import (  # noqa: E402
    SPLITS, _route, call_route, mma_units, splits_for)

ZERO = {"grouped_matmul": 0, "ragged_grouped_matmul": 0,
        "grouped_matmul_wgmma": 0, "grouped_matmul_splitk": 0}


@pytest.mark.parametrize("dtype,rows,route", [
    (torch.bfloat16, 1, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 65, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 1300, "wgmma"),
    (torch.float32, 1, "f32"), (torch.float32, 64, "f32"),
    (torch.float32, 65, "f32"), (torch.float32, 128, "f32"),
    (torch.float32, 1300, "f32")])
def test_route_table(dtype, rows, route):
    assert _route(dtype, rows) == route
    # grouped_matmul: M rows a tile
    assert call_route(torch.zeros(2, rows, 8, dtype=dtype)) == route


@pytest.mark.parametrize("T,block_m,route", [
    (8192, 128, "wgmma"), (8192, 16, "mma"), (8192, 64, "mma"),
    (8192, 65, "wgmma"), (420, 96, "wgmma"), (520, 192, "wgmma"),
    # the ownership block is cut to T: a short ragged call is a decode
    (50, 128, "mma"), (64, 192, "mma"), (65, 128, "wgmma")])
def test_ragged_route_follows_the_ownership_block(T, block_m, route):
    x = torch.zeros(T, 8, dtype=torch.bfloat16)
    assert call_route(x, block_m) == route
    assert call_route(x.float(), block_m) == "f32"


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no route"):
        _route(torch.float16, 128)


def inputs(shape_x, shape_w, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal(shape_x),
                            dtype=torch.float32).to(dtype),
            torch.as_tensor(rng.standard_normal(shape_w),
                            dtype=torch.float32).to(dtype))


BAD_CALLS = {
    "x-not-3d": lambda: gm.grouped_matmul(torch.zeros(4, 8),
                                          torch.zeros(1, 8, 8)),
    "k-mismatch": lambda: gm.grouped_matmul(torch.zeros(2, 130, 8),
                                            torch.zeros(2, 16, 8)),
    "experts-mismatch": lambda: gm.grouped_matmul(torch.zeros(2, 130, 8),
                                                  torch.zeros(3, 8, 8)),
    "float16": lambda: gm.grouped_matmul(
        torch.zeros(2, 130, 8, dtype=torch.float16),
        torch.zeros(2, 8, 8, dtype=torch.float16)),
    "mixed-dtypes": lambda: gm.grouped_matmul(
        torch.zeros(2, 130, 8, dtype=torch.bfloat16), torch.zeros(2, 8, 8)),
    "ragged-sizes-shape": lambda: gm.ragged_grouped_matmul(
        torch.zeros(200, 8), torch.zeros(2, 8, 8), torch.tensor([200])),
    "ragged-sizes-float": lambda: gm.ragged_grouped_matmul(
        torch.zeros(200, 8), torch.zeros(2, 8, 8),
        torch.tensor([100.0, 100.0])),
    "ragged-block-0": lambda: gm.ragged_grouped_matmul(
        torch.zeros(200, 8), torch.zeros(2, 8, 8), torch.tensor([100, 100]),
        block_m=0),
    # a device with no kernel, on a shape that would take the wgmma route:
    # refused in the wrapper, never handed to the plain version
    "meta-device": lambda: gm.grouped_matmul(
        torch.zeros(2, 130, 8, dtype=torch.bfloat16, device="meta"),
        torch.zeros(2, 8, 8, dtype=torch.bfloat16, device="meta")),
    "meta-device-ragged": lambda: gm.ragged_grouped_matmul(
        torch.zeros(200, 8, dtype=torch.bfloat16, device="meta"),
        torch.zeros(2, 8, 8, dtype=torch.bfloat16, device="meta"),
        torch.tensor([100, 100], device="meta")),
}


@pytest.mark.parametrize("name", sorted(BAD_CALLS))
def test_wrappers_refuse_bad_inputs_before_any_launch(name):
    gm.reset_launch_counts()
    with pytest.raises((TypeError, ValueError)):
        BAD_CALLS[name]()
    assert gm.LAUNCHES == ZERO


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_launches_nothing(dtype):
    """Shapes that take each route on the card (M 130 and 2; block_m 128
    and 16) give the plain versions' results on the CPU and leave every
    count at 0."""
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    gm.reset_launch_counts()
    for M in (130, 2):
        x, w = inputs((2, M, 24), (2, 24, 40), dtype, M)
        np.testing.assert_allclose(
            gm.grouped_matmul(x, w).float().numpy(),
            gm.grouped_matmul_ref(x, w).float().numpy(), atol=tol, rtol=tol)
    sizes = torch.tensor([90, 0, 70])
    x, w = inputs((160, 24), (3, 24, 40), dtype, 3)
    for block_m in (128, 16):
        np.testing.assert_allclose(
            gm.ragged_grouped_matmul(x, w, sizes, block_m).float().numpy(),
            gm.ragged_grouped_matmul_masked_ref(x, w, sizes, block_m)
            .float().numpy(), atol=tol, rtol=tol)
    assert gm.LAUNCHES == ZERO


# (units, K tiles, slots, S): mixtral's decode down and gate/up on the
# H100's 264 slots (2 blocks an SM of the mma kernel, 132 SMs); K tiles
# that no S > 1 divides (255), or that rule out the S a grid would need
# (6: S = 4; 2: S = 4); grids that already fill their waves; grids that
# need 4 and 8; the prefill gate/up's grid of 16-row tiles
SPLIT_CASES = {"decode-down": (384, 256, 264, 2),
               "decode-gate-up": (1024, 96, 264, 1),
               "k-tiles-odd": (384, 255, 264, 1),
               "k-tiles-6": (100, 6, 264, 1),
               "k-tiles-2": (60, 2, 264, 1),
               "full-wave": (264, 256, 264, 1),
               "two-full-waves": (528, 256, 264, 1),
               "needs-4": (60, 64, 264, 4),
               "needs-8": (33, 16, 264, 8),
               "prefill-tile-count": (80 * 128 * 8, 96, 264, 1)}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_splits_for_table(name):
    units, ktiles, slots, want = SPLIT_CASES[name]
    assert splits_for(units, ktiles, slots) == want


def test_splits_for_divides_k_tiles_and_fills_or_gives_1():
    """Over a grid of shapes: S is in SPLITS and divides the K tiles; an
    S > 1 fills at least 90 % of its waves' slots, and no smaller S that
    divides the K tiles does."""
    def fill(units, k, slots):
        b = units * k
        return b / (-(-b // slots) * slots)

    for units in range(1, 700, 7):
        for ktiles in (1, 2, 3, 6, 12, 96, 255, 256):
            for slots in (66, 132, 264):
                s = splits_for(units, ktiles, slots)
                assert s in SPLITS and ktiles % s == 0
                if s > 1:
                    assert fill(units, s, slots) >= 0.9
                assert all(fill(units, k, slots) < 0.9 for k in SPLITS
                           if k < s and ktiles % k == 0)


@pytest.mark.parametrize("dims,units", [
    # mixtral decode down / gate/up: 1 row tile, 48 / 128 column tiles, 8
    # experts
    ((0, 8, 2, 16384, 6144, 0), 384), ((0, 8, 2, 6144, 16384, 0), 1024),
    ((0, 3, 33, 64, 129, 0), 3 * 2 * 3),
    # ragged: ownership blocks of 16 rows (one row tile each) over 150
    # rows; blocks of 40 rows cut into 3 row tiles, over 100 rows
    ((1, 5, 150, 72, 128, 16), 10), ((1, 4, 100, 64, 256, 40), 3 * 3 * 2)])
def test_mma_units_count_the_kernel_grid(dims, units):
    assert mma_units(dims) == units


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_jax(dtype, splits):
    """The split's plain version against the JAX package's grouped
    matmul (its Pallas kernel in interpret mode and its oracle) at
    ``tests/test_torch_grouped_matmul.py``'s tolerances (2e-5 float32,
    5e-2 bfloat16), at a decode shape whose 16 K tiles every S divides
    and one whose K (250) ends in a short tile; at S = 1 it is
    ``grouped_matmul_ref`` bit for bit.  An S that does not divide the K
    tiles (5 at K = 320) is refused."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import grouped_matmul as RG
    tdt, jdt, tol = {"float32": (torch.float32, jnp.float32, 2e-5),
                     "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}[dtype]
    for E, M, K, N in ((8, 2, 1024, 48), (2, 3, 250, 40)):
        rng = np.random.default_rng(E * K + splits)
        x = rng.standard_normal((E, M, K)).astype(np.float32)
        w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
        xt, wt = torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt)
        got = gm.grouped_matmul_split_ref(xt, wt, splits)
        assert got.dtype == tdt and got.shape == (E, M, N)
        xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
        for want in (RG.grouped_matmul(xj, wj, block_m=16, block_n=16,
                                       block_k=16),
                     RG.grouped_matmul_ref(xj, wj)):
            np.testing.assert_allclose(
                got.float().numpy(),
                np.asarray(jnp.asarray(want, jnp.float32)), atol=tol,
                rtol=tol)
        if splits == 1:
            assert torch.equal(got, gm.grouped_matmul_ref(xt, wt))
    if splits > 1:
        with pytest.raises(ValueError, match="do not divide"):
            gm.grouped_matmul_split_ref(torch.zeros(1, 2, 320, dtype=tdt),
                                        torch.zeros(1, 320, 8, dtype=tdt),
                                        splits)
