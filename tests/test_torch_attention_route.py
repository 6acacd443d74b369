"""The attention wrapper's route and the mask probe's oracle, on the CPU.

A CUDA call takes one of three kernels, chosen by ``ops._route`` from the
dtype and Sq alone: the split-KV decode kernel for Sq = 1 in either
dtype, the tensor-core kernel for bfloat16 with Sq > 1, the CUDA-core
kernel for float32 with Sq > 1.  The kernels run only on a GPU
(``tests/test_torch_gpu.py``); here the route's table is held, and
``mask_probe``'s float64 answer, which the GPU tests and ``chip_smoke.py``
hold the tensor-core kernel to, is held against the port's
``attention_ref`` and the JAX package's attention (the kernel oracle
``repro.kernels.flash_attention.ref`` for right-aligned positions,
``repro.models.layers.attention_ref`` for ring caches) on the same numpy
inputs, in float32 at 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_kernel_ref)
from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    LAUNCHES, attention_mask, attention_ref, flash_attention, mask_probe,
    reset_launch_counts)
from repro_torch.kernels.flash_attention.ops import _route  # noqa: E402

# the probe's tolerance on the card: one bf16 rounding of each value
PROBE_REL_TOL = 2.0 ** -8


@pytest.mark.parametrize("dtype,sq,route", [
    (torch.bfloat16, 2, "tc"), (torch.bfloat16, 1024, "tc"),
    (torch.bfloat16, 4160, "tc"), (torch.bfloat16, 1, "decode"),
    (torch.float32, 1, "decode"), (torch.float32, 2, "simt"),
    (torch.float32, 1024, "simt")])
def test_route_table(dtype, sq, route):
    assert _route(dtype, sq) == route


def ring_positions(cap, written):
    kv_pos = np.full(cap, -1, np.int32)
    for p in range(written):
        kv_pos[p % cap] = p
    return kv_pos


# name: (B, K, G, Dh, q positions, kv positions, window); kv positions
# None = arange(Skv) with the queries right-aligned to its tail
PROBE_CASES = {
    "gqa-causal": (2, 2, 4, 16, np.arange(40), None, None),
    "gqa-cross-ragged": (1, 2, 3, 32, np.arange(44, 77), None, None),
    "mqa-window": (2, 1, 6, 16, np.arange(70), None, 8),
    "window-dh256-g10": (1, 1, 10, 256, np.arange(20), None, 8),
    "ring-empty-slots": (2, 2, 2, 16, np.arange(10), ring_positions(24, 10),
                         None),
    "ring-wrapped-window": (1, 2, 3, 64, np.arange(20, 25),
                            ring_positions(8, 25), 8),
    "ring-decode-wrapped": (2, 1, 4, 32, np.array([30]),
                            ring_positions(16, 31), None),
}


def probe_case(name):
    B, K, G, Dh, qp, kp, window = PROBE_CASES[name]
    qp = qp.astype(np.int32)
    kp = (np.arange(int(qp[-1]) + 1) if kp is None else kp).astype(np.int32)
    q, k, v, want = mask_probe(B, K, G, Dh, torch.as_tensor(qp),
                               torch.as_tensor(kp), causal=True,
                               window=window, dtype=torch.float32)
    return (B, K, G, Dh, qp, kp, window,
            q.numpy(), k.numpy(), v.numpy(), want.numpy())


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_probe_oracle_matches_both_references(name):
    B, K, G, Dh, qp, kp, window, q, k, v, want = probe_case(name)
    Sq, Skv = len(qp), len(kp)
    assert want.dtype == np.float64 and want.shape == (Sq, Dh)
    full = np.broadcast_to(want[None, :, None, None, :], (B, Sq, K, G, Dh))
    got = attention_ref(*(torch.as_tensor(a) for a in (q, k, v, qp, kp)),
                        causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), full, atol=2e-5, rtol=2e-5)
    jref = RL.attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)),
        jnp.broadcast_to(qp, (B, Sq)), jnp.broadcast_to(kp, (B, Skv)),
        causal=True, window=window,
        kv_valid=jnp.broadcast_to(kp >= 0, (B, Skv)))
    np.testing.assert_allclose(np.asarray(jref), full, atol=2e-5, rtol=2e-5)
    if np.array_equal(kp, np.arange(Skv)) and qp[-1] == Skv - 1:
        # the kernel oracle's layout: (B, H, S, Dh), right-aligned queries
        kq = q.reshape(B, Sq, K * G, Dh).transpose(0, 2, 1, 3)
        kk, kv = (a.transpose(0, 2, 1, 3) for a in (k, v))
        jk = jax_kernel_ref(*(jnp.asarray(a) for a in (kq, kk, kv)),
                            causal=True, window=window)
        np.testing.assert_allclose(
            np.asarray(jk), full.reshape(B, Sq, K * G, Dh)
            .transpose(0, 2, 1, 3), atol=2e-5, rtol=2e-5)


def probe_answer(mask, kp, Dh):
    """The oracle's formula for a given (Sq, Skv) mask, in float64."""
    hit = (kp >= 0)[:, None] & ((kp % Dh)[:, None] == np.arange(Dh))
    return (mask @ hit) / np.maximum(mask.sum(axis=1, keepdims=True), 1)


# name: (q positions, kv positions, window, Dh), at serve-like lengths
DROP_CASES = {
    "causal-300-dh128": (np.arange(300), np.arange(300), None, 128),
    "window-1100-dh128": (np.arange(1100), np.arange(1100), 256, 128),
    "ring-empty-dh64": (np.arange(200), ring_positions(260, 200), None, 64),
}


@pytest.mark.parametrize("name", sorted(DROP_CASES))
def test_probe_sees_a_dropped_tile_and_a_leaked_key(name):
    """Dropping any attended 64-slot tile of keys, or attending one key
    the mask excludes, moves some value of the probe's answer by more
    than the tolerance the tensor-core kernel is held to."""
    qp, kp, window, Dh = DROP_CASES[name]
    qp, kp = qp.astype(np.int32), kp.astype(np.int32)
    *_, want = mask_probe(1, 1, 1, Dh, torch.as_tensor(qp),
                          torch.as_tensor(kp), causal=True, window=window,
                          dtype=torch.float32)
    want = want.numpy()
    mask = attention_mask(torch.as_tensor(qp), torch.as_tensor(kp), True,
                          window).numpy().astype(np.float64)
    assert np.allclose(probe_answer(mask, kp, Dh), want, rtol=0, atol=0)

    def moved(m):
        ans = probe_answer(m, kp, Dh)
        return bool((np.abs(ans - want) > PROBE_REL_TOL * want).any())

    tiles = [slice(t, t + 64) for t in range(0, len(kp), 64)]
    for tile in tiles:
        if mask[:, tile].any():
            dropped = mask.copy()
            dropped[:, tile] = 0
            assert moved(dropped), tile
    excluded = np.argwhere(mask == 0)
    for r, c in excluded[[0, len(excluded) // 2, -1]]:
        leaked = mask.copy()
        leaked[r, c] = 1
        assert moved(leaked), (r, c)


def test_cpu_bf16_prefill_launches_nothing():
    """On CPU tensors the wrapper takes the plain version on either
    route, and no launch is counted."""
    q = torch.zeros(1, 8, 2, 2, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)
    reset_launch_counts()
    out = flash_attention(q, k, k, pos, pos)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0,
                        "flash_attention_decode": 0,
                        "flash_attention_backward": 0,
                        "flash_attention_backward_tc": 0}


@pytest.mark.parametrize("dtype,sq", [(torch.bfloat16, 4),
                                      (torch.bfloat16, 1),
                                      (torch.float32, 4),
                                      (torch.float32, 1)])
def test_wrapper_on_meta_raises_on_either_route(dtype, sq):
    q = torch.zeros(1, sq, 1, 2, 16, dtype=dtype, device="meta")
    k = torch.zeros(1, 6, 1, 16, dtype=dtype, device="meta")
    qp = torch.zeros(sq, dtype=torch.int32, device="meta")
    kp = torch.zeros(6, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(q, k, k, qp, kp)
