"""The RG-LRU scan's plan, launch word and checks on the CPU, and its CPU
path against the JAX package at ragged shapes.

The CUDA kernel's block and ring are constants of ``csrc/lru_scan.cu``
that ``ops`` mirrors; ``ops.plan`` decides the width of its moves from W
and the inputs' alignment, and ``ops.LAUNCH_WORD`` carries it to the C
entry point (which decodes the same bits), so all three are held here
where there is no card.  The wrapper's checks run the same way on every
device,
so a CPU tensor raises what a CUDA tensor would.  The CPU path is the
plain version; it is held against the JAX package's ``lru_scan_ref`` and
its Pallas kernel (interpret mode) at 1e-5 (``tests/test_kernels.py``'s
tolerance) on the ragged shapes that ``tests/test_torch_gpu.py`` runs on
the card, cut to a small size.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rg_lru import lru_scan as pallas_lru_scan  # noqa: E402
from repro.kernels.rg_lru import lru_scan_ref as jax_lru_scan_ref  # noqa
from repro_torch.kernels.rg_lru import (LAUNCHES, lru_scan,  # noqa: E402
                                        reset_launch_counts)
from repro_torch.kernels.rg_lru import ops  # noqa: E402

# B, S, W: tests/test_kernels.py's sweep, the ragged widths and lengths of
# tests/test_torch_gpu.py, recurrentgemma-2b's prefill and its window wave
PLAN_SHAPES = {"1x16x32": (1, 16, 32), "2x75x96": (2, 75, 96),
               "3x128x64": (3, 128, 64), "1x200x48": (1, 200, 48),
               "W1": (2, 64, 1), "W33": (2, 64, 33), "W2576": (2, 64, 2576),
               "S1": (2, 1, 96), "S31": (2, 31, 96), "S33": (2, 33, 96),
               "S1025": (2, 1025, 96), "prefill": (4, 1024, 2560),
               "window": (1, 2304, 2560), "B65535": (65535, 8, 32)}


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_covers_the_shape(name, aligned):
    """The grid covers W with whole blocks (the last one holding W's
    ragged end) and B, the ring fits a block's shared memory without an
    opt-in, and moves are 16 bytes exactly where W is a multiple of 4 and
    a and b start on 16 bytes."""
    B, S, W = PLAN_SHAPES[name]
    vec = ops.plan(W, aligned)
    assert vec in ops.VECS
    assert vec == (4 if aligned and W % 4 == 0 else 1)
    gw, gb = ops.grid(B, W)
    assert gb == B <= 65535
    assert (gw - 1) * ops.THREADS < W <= gw * ops.THREADS
    assert ops.SHARED_BYTES == ops.THREADS // 32 * (2 * ops.STAGES + 1) \
        * ops.STEPS * 32 * 4
    assert ops.SHARED_BYTES <= 48 * 1024
    # whole warps, and whole 4-row groups for the 16-byte moves
    assert ops.THREADS % 32 == 0 and ops.STEPS % 4 == 0


def test_prefill_plan_fills_every_sm():
    """recurrentgemma-2b's prefill (4, 1024, 2560), from the allocator's
    aligned blocks: 16-byte moves, 320 one-warp blocks, 2-3 on each of
    the H100's 132 SMs, under 48 KB of shared memory each."""
    a = torch.empty(4, 1024, 2560)
    assert ops.call_plan(a, torch.empty_like(a)) == ops.plan(2560, True) == 4
    gw, gb = ops.grid(4, 2560)
    assert gw * gb == 320 and ops.THREADS == 32
    assert ops.SHARED_BYTES <= 48 * 1024   # no opt-in above 48 KB


@pytest.mark.parametrize("a_off,b_off,want", [
    (0, 0, True), (4, 0, False), (0, 8, False), (16, 32, True)])
def test_aligned_inputs(a_off, b_off, want):
    assert ops.aligned_inputs(4096 + a_off, 8192 + b_off) is want


@pytest.mark.parametrize("device", [0, 1, 3, 7, 255])
@pytest.mark.parametrize("vec", ops.VECS)
def test_launch_word_round_trip(vec, device):
    """Every plan packs into the word that the C entry point decodes (vec
    in bits 0-2, device 3-10) and unpacks to itself; a device past 255
    does not fit."""
    word = ops.launch_word(vec, device)
    assert word == vec | device << 3
    assert ops.LAUNCH_WORD.unpack(word) == {"vec": vec, "device": device}
    with pytest.raises(ValueError, match="does not fit"):
        ops.launch_word(vec, device + 256)


SOURCE = (Path(ops.__file__).parent / "csrc" / "lru_scan.cu").read_text()


@pytest.mark.parametrize("name,value", [
    ("kThreads", ops.THREADS), ("kStages", ops.STAGES),
    ("kSteps", ops.STEPS)])
def test_ops_mirrors_the_kernel_constants(name, value):
    """``ops``'s block and ring are the constants the kernel is compiled
    with, so the grid and shared memory it reports are the launch's."""
    assert re.findall(rf"constexpr int {name} = (\d+);", SOURCE) \
        == [str(value)]


def test_entry_point_decodes_the_word_as_ops_packs_it():
    """The C entry point reads vec and the device from the bits where
    ``ops.LAUNCH_WORD`` puts them."""
    (vec_shift, vec_bits), (dev_shift, dev_bits) = \
        ops.LAUNCH_WORD.fields["vec"], ops.LAUNCH_WORD.fields["device"]
    assert vec_shift == 0 and dev_shift == vec_bits
    assert f"word & {(1 << vec_bits) - 1})" in SOURCE
    assert f"(word >> {dev_shift}) & {(1 << dev_bits) - 1})" in SOURCE


def _bad_calls():
    a = torch.rand(2, 5, 8)
    strided = torch.rand(2, 5, 16)[:, :, :8]
    return {
        "strided a": ((strided, a, None), ValueError, "contiguous"),
        "strided b": ((a, strided, None), ValueError, "contiguous"),
        "strided h0": ((a, a, torch.rand(2, 16)[:, :8]), ValueError,
                       "contiguous"),
        "float64": ((a.double(), a.double(), None), TypeError, "float32"),
        "bf16 h0": ((a, a, torch.zeros(2, 8, dtype=torch.bfloat16)),
                    TypeError, "float32"),
        "shapes": ((a, a[:, :4].contiguous(), None), ValueError,
                   r"\(B, S, W\)"),
        "rank": ((a[0], a[0], None), ValueError, r"\(B, S, W\)"),
        "h0 shape": ((a, a, torch.zeros(2, 5)), ValueError, r"\(B, W\)"),
    }


@pytest.mark.parametrize("name", sorted(_bad_calls()))
def test_checks_raise_on_the_cpu_as_on_the_card(name):
    """The checks run before the wrapper looks at the device, so a CPU
    tensor raises what a CUDA tensor would, and nothing is launched."""
    args, exc, match = _bad_calls()[name]
    reset_launch_counts()
    with pytest.raises(exc, match=match):
        lru_scan(*args)
    with pytest.raises(exc, match=match):
        ops.check_inputs(*args)
    assert LAUNCHES == {"lru_scan": 0}


# B, S, W, Pallas chunk, Pallas block_w: the ragged widths and lengths of
# tests/test_torch_gpu.py at a small size, with Pallas blocks that do not
# divide them
RAGGED = [(1, 7, 1, 4, 8), (2, 5, 33, 4, 16), (2, 1, 40, 8, 16),
          (1, 31, 20, 8, 16), (2, 33, 12, 16, 8), (1, 1025, 4, 128, 8),
          (1, 3, 2576, 2, 512)]


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zero-state"])
@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_cpu_path_matches_reference_at_ragged_shapes(case, with_h0):
    B, S, W, chunk, bw = case
    rng = np.random.default_rng(B * 10_000 + S * 100 + W)
    a = rng.uniform(0.4, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = {"lru_scan_ref": jax_lru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                             jh0),
            "Pallas lru_scan": pallas_lru_scan(jnp.asarray(a),
                                               jnp.asarray(b), jh0,
                                               chunk=chunk, block_w=bw)}
    reset_launch_counts()
    y, h = lru_scan(torch.as_tensor(a), torch.as_tensor(b),
                    None if h0 is None else torch.as_tensor(h0))
    assert LAUNCHES == {"lru_scan": 0}
    assert y.shape == (B, S, W) and h.shape == (B, W)
    for what, (wy, wh) in want.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5,
                                   rtol=1e-5, err_msg=f"y vs {what}")
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=1e-5,
                                   rtol=1e-5, err_msg=f"h_last vs {what}")
    np.testing.assert_array_equal(h.numpy(), y[:, -1].numpy())
