"""The grouped matmuls' route table and launch counts, on the CPU.

A CUDA call takes one of three kernels, chosen by ``ops._route`` from the
dtype and the rows of a tile alone (M for ``grouped_matmul``,
``min(block_m, T)`` for ``ragged_grouped_matmul``): the TMA-fed
``wgmma`` kernel for bfloat16 with more than 64 rows, the ``mma.sync``
kernel for bfloat16 with at most 64, the CUDA-core kernel for float32.
The kernels run only on a GPU (``tests/test_torch_gpu.py``); here the
route's table is held, the wrappers' refusals of bad inputs, and that
the CPU path (the plain versions, held against the JAX package in
``tests/test_torch_grouped_matmul.py``) launches nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels.grouped_matmul.ops import (  # noqa: E402
    _route, call_route)

ZERO = {"grouped_matmul": 0, "ragged_grouped_matmul": 0,
        "grouped_matmul_wgmma": 0}


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
