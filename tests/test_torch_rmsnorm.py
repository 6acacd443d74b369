"""The port's RMSNorm against the JAX package's.

The plain PyTorch version (and the wrapper, which takes it for CPU
tensors) is held against ``repro.kernels.rmsnorm``'s ``rmsnorm_ref``, its
Pallas kernel in interpret mode, and ``repro.models.layers.rmsnorm``, on
the same inputs (numpy, from a seed).  Tolerances are those of
``tests/test_kernels.py``: 2e-5 for float32, 5e-2 for bfloat16.  The
CUDA kernel itself runs only on a GPU (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref  # noqa
from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels.rmsnorm import (LAUNCHES, reset_launch_counts,  # noqa
                                         rmsnorm, rmsnorm_ref)
from repro_torch.models import layers as L  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
# (N, D): ragged N, short and long rows, the serve path's widths
SHAPES = [(1, 16), (7, 64), (100, 256), (33, 1000), (4, 4096), (9, 8192)]


def inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal(d).astype(np.float32))


def as_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_and_wrapper_match_reference(dtype, n, d):
    tdt, jdt, tol = DTYPES[dtype]
    x, s = inputs(n, d, SHAPES.index((n, d)))
    xt, st = torch.as_tensor(x).to(tdt), torch.as_tensor(s).to(tdt)
    xj, sj = jnp.asarray(x, jdt), jnp.asarray(s, jdt)
    want = as_np(jax_rmsnorm_ref(xj, sj, 1e-6))
    reset_launch_counts()
    for got in (rmsnorm_ref(xt, st, 1e-6), rmsnorm(xt, st, 1e-6)):
        assert got.dtype == tdt and got.shape == (n, d)
        np.testing.assert_allclose(as_np(got), want, atol=tol, rtol=tol)
    assert LAUNCHES["rmsnorm"] == 0       # the CPU path launches nothing
    if n * d <= 100 * 256:
        pallas = pallas_rmsnorm(xj, sj, eps=1e-6, block_n=8)
        np.testing.assert_allclose(as_np(rmsnorm(xt, st, 1e-6)),
                                   as_np(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_layer_matches_reference_layer(dtype, backend):
    """layers.rmsnorm over (B, S, d) and over q's (B, S, K, G, Dh), with a
    bf16 scale on bf16 activations as the model holds them, and eps 1e-5."""
    tdt, jdt, tol = DTYPES[dtype]
    for shape in ((2, 10, 64), (2, 5, 2, 4, 16)):
        rng = np.random.default_rng(len(shape))
        x = rng.standard_normal(shape).astype(np.float32)
        s = rng.standard_normal(shape[-1]).astype(np.float32)
        want = RL.rmsnorm({"scale": jnp.asarray(s, jdt)},
                          jnp.asarray(x, jdt), 1e-5)
        got = L.rmsnorm({"scale": torch.as_tensor(s).to(tdt)},
                        torch.as_tensor(x).to(tdt), 1e-5, backend=backend)
        assert got.shape == shape and got.dtype == tdt
        np.testing.assert_allclose(as_np(got), as_np(want), atol=tol,
                                   rtol=tol)


def test_wrapper_checks_its_inputs():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(x, torch.ones(7))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsnorm(x.double(), torch.ones(8))
    with pytest.raises(TypeError, match="x's dtype"):
        rmsnorm(x.bfloat16(), torch.ones(8))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rmsnorm(x.to("meta"), torch.ones(8, device="meta"))
