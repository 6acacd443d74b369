"""The port's grouped matmuls against the JAX package's.

The plain PyTorch versions (and the wrappers, which take them for CPU
tensors) are held against ``repro.kernels.grouped_matmul``: its Pallas
kernels in interpret mode and its oracles, on the same inputs (numpy,
from a seed), with ``tests/test_kernels.py``'s cases and tolerances (2e-5
for float32, 5e-2 for bfloat16).  The ragged matmul is compared on every
row, the rows the Pallas kernel masks to 0 included.  The CUDA kernels
themselves run only on a GPU (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import grouped_matmul as RG  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def as_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def inputs(x_shape, w_shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(x_shape).astype(np.float32),
            rng.standard_normal(w_shape).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("E,M,K,N,bm", [
    (1, 32, 32, 32, 16),
    (4, 50, 40, 30, 16),      # non-multiples everywhere
    (8, 128, 64, 96, 64),
    (8, 2, 64, 48, 16),       # decode: 2 rows per expert
])
def test_grouped_matmul_matches_pallas(dtype, E, M, K, N, bm):
    tdt, jdt, tol = DTYPES[dtype]
    x, w = inputs((E, M, K), (E, K, N), E * M)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    xt, wt = torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt)
    pallas = as_np(RG.grouped_matmul(xj, wj, block_m=bm, block_n=16,
                                     block_k=16))
    oracle = as_np(RG.grouped_matmul_ref(xj, wj))
    gm.reset_launch_counts()
    for got in (gm.grouped_matmul(xt, wt), gm.grouped_matmul_ref(xt, wt),
                gm.expert_ffn_matmul(xt, wt)):
        assert got.dtype == tdt and got.shape == (E, M, N)
        np.testing.assert_allclose(as_np(got), pallas, atol=tol, rtol=tol)
        np.testing.assert_allclose(as_np(got), oracle, atol=tol, rtol=tol)
    assert gm.LAUNCHES["grouped_matmul"] == 0   # the CPU path launches none


RAGGED = {
    "even": ([64, 64, 64, 64], 32),
    "empty-group": ([128, 0, 64, 64], 32),
    "one-group": ([256, 0, 0, 0], 32),
    "boundaries": ([32, 96, 64, 64], 32),
    # blocks that straddle group boundaries, and a short last block
    "straddling": ([30, 50, 0, 48], 32),
    "short-last-block": ([7, 40, 21, 2], 32),
}


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_grouped_matmul_matches_pallas(name):
    """Every row, masked ones included, against the Pallas kernel; the
    rows whose block their own group owns against the exact oracle."""
    sizes, bm = RAGGED[name]
    T = sum(sizes)
    x, w = inputs((T, 32), (4, 32, 16), T)
    gs = np.asarray(sizes, np.int32)
    pallas = as_np(RG.ragged_grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(gs), block_m=bm,
                                            block_k=16))
    oracle = as_np(RG.ragged_grouped_matmul_ref(jnp.asarray(x),
                                                jnp.asarray(w),
                                                jnp.asarray(gs)))
    xt, wt, gst = torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(gs)
    gm.reset_launch_counts()
    got = gm.ragged_grouped_matmul(xt, wt, gst, block_m=bm)
    np.testing.assert_allclose(as_np(got), pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        as_np(gm.ragged_grouped_matmul_masked_ref(xt, wt, gst, bm)), pallas,
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        as_np(gm.ragged_grouped_matmul_ref(xt, wt, gst)), oracle, atol=2e-5,
        rtol=2e-5)
    _, inside = gm.block_owners(gst, T, bm)
    assert (pallas[~inside.numpy()] == 0).all()
    np.testing.assert_allclose(pallas[inside.numpy()],
                               oracle[inside.numpy()], atol=2e-5, rtol=2e-5)
    assert gm.LAUNCHES["ragged_grouped_matmul"] == 0


def test_ragged_block_aligned_is_exact():
    """Groups padded to the block: the masked version is the oracle.
    ``megablocks_matmul`` (blocks of 128 rows) masks them as the
    reference's does."""
    gs = np.asarray([64, 128, 0, 64], np.int32)
    x, w = inputs((256, 48), (4, 48, 24), 6)
    xj, wj, gsj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)
    pallas = as_np(RG.ragged_grouped_matmul(xj, wj, gsj, block_m=64,
                                            block_k=16))
    xt, wt, gst = torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(gs)
    for got in (gm.ragged_grouped_matmul(xt, wt, gst, block_m=64),
                gm.ragged_grouped_matmul_ref(xt, wt, gst)):
        np.testing.assert_allclose(as_np(got), pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(as_np(gm.megablocks_matmul(xt, wt, gst)),
                               as_np(RG.megablocks_matmul(xj, wj, gsj)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_bf16_and_float32_match_pallas(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    gs = np.asarray([40, 0, 70, 18], np.int32)
    x, w = inputs((128, 64), (4, 64, 32), 9)
    pallas = as_np(RG.ragged_grouped_matmul(jnp.asarray(x, jdt),
                                            jnp.asarray(w, jdt),
                                            jnp.asarray(gs), block_m=32,
                                            block_k=32))
    got = gm.ragged_grouped_matmul(torch.as_tensor(x).to(tdt),
                                   torch.as_tensor(w).to(tdt),
                                   torch.as_tensor(gs), block_m=32)
    assert got.dtype == tdt
    np.testing.assert_allclose(as_np(got), pallas, atol=tol, rtol=tol)


def test_block_owners_follow_the_pallas_table():
    """Owner of a block = #{ends <= its first row}, clipped to E - 1."""
    gs = torch.tensor([0, 5, 0, 3])
    owner, inside = gm.block_owners(gs, 8, 4)
    assert owner.tolist() == [1] * 4 + [1] * 4
    assert inside.tolist() == [True] * 5 + [False] * 3
    owner, inside = gm.block_owners(torch.tensor([2, 2]), 6, 4)
    assert owner.tolist() == [0] * 4 + [1] * 2     # past the sizes: E - 1
    assert inside.tolist() == [True, True, False, False, False, False]


def test_wrappers_check_their_inputs():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="must be"):
        gm.grouped_matmul(x, torch.zeros(2, 5, 6))
    with pytest.raises(ValueError, match="must be"):
        gm.grouped_matmul(x, torch.zeros(3, 4, 6))
    with pytest.raises(TypeError, match="dtype"):
        gm.grouped_matmul(x, torch.zeros(2, 4, 6, dtype=torch.float64))
    with pytest.raises(TypeError, match="dtype"):
        gm.grouped_matmul(x.bfloat16(), torch.zeros(2, 4, 6))
    w = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="group_sizes"):
        gm.ragged_grouped_matmul(torch.zeros(5, 4), w, torch.tensor([5]))
    with pytest.raises(ValueError, match="group_sizes"):
        gm.ragged_grouped_matmul(torch.zeros(5, 4), w,
                                 torch.tensor([2.0, 3.0]))
    with pytest.raises(ValueError, match="block_m"):
        gm.ragged_grouped_matmul(torch.zeros(5, 4), w, torch.tensor([2, 3]),
                                 block_m=0)
