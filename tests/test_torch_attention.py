"""The port's attention against the JAX package's.

The plain PyTorch version (and the flash wrapper, which takes it for CPU
tensors) is held against ``repro.kernels.flash_attention``'s
``attention_ref`` and its Pallas kernel in interpret mode (the kernel
layout, queries right-aligned to the kv tail), and against
``repro.models.layers.attention_ref`` (the model layout, with positions
and ``kv_valid``).  Covered: MHA, GQA, MQA, decode (Sq = 1), ragged
lengths, sliding windows, a bidirectional case, a ring cache with
empty and wrapped slots, and recurrentgemma-2b's head dim 256.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 for float32,
5e-2 for bfloat16.  The
CUDA kernel runs only on a GPU (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    attention_ref as jax_kernel_ref, flash_attention as pallas_flash)
from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    LAUNCHES, attention_mask, attention_ref, flash_attention,
    flash_attention_kernel_layout, reset_launch_counts)
from repro_torch.models import layers as L  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
# kernel layout: B, H, K, Sq, Skv, Dh (tests/test_kernels.py's sweep)
KERNEL_CASES = [(1, 4, 4, 64, 64, 64), (2, 4, 2, 100, 100, 32),
                (1, 8, 1, 128, 128, 64), (2, 4, 2, 1, 96, 64),
                (1, 2, 2, 33, 77, 128), (1, 10, 1, 40, 40, 256)]


def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def as_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_kernel_layout_matches_pallas_and_its_oracle(dtype, case):
    tdt, jdt, tol = DTYPES[dtype]
    B, H, K, Sq, Skv, Dh = case
    rng = np.random.default_rng(KERNEL_CASES.index(case))
    q, k, v = (normal(rng, (B, H, Sq, Dh)), normal(rng, (B, K, Skv, Dh)),
               normal(rng, (B, K, Skv, Dh)))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    reset_launch_counts()
    got = flash_attention_kernel_layout(tq, tk, tv, causal=True)
    assert got.shape == (B, H, Sq, Dh) and got.dtype == tdt
    assert LAUNCHES["flash_attention"] == 0
    for want in (jax_kernel_ref(jq, jk, jv, causal=True),
                 pallas_flash(jq, jk, jv, causal=True, block_q=32,
                              block_k=32)):
        np.testing.assert_allclose(as_np(got), as_np(want), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("window", [1, 8, 64, None])
def test_kernel_layout_windows(window):
    rng = np.random.default_rng(1)
    q, k, v = (normal(rng, (2, 4, 80, 32)), normal(rng, (2, 2, 80, 32)),
               normal(rng, (2, 2, 80, 32)))
    got = flash_attention_kernel_layout(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=True, window=window)
    want = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                        window=window, block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_kernel_layout_bidirectional():
    rng = np.random.default_rng(2)
    q, k, v = (normal(rng, (1, 2, 48, 64)), normal(rng, (1, 2, 80, 64)),
               normal(rng, (1, 2, 80, 64)))
    got = flash_attention_kernel_layout(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=False)
    want = jax_kernel_ref(*(jnp.asarray(a) for a in (q, k, v)),
                          causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def ring_positions(cap, written):
    """kv_pos of a ring cache of ``cap`` slots after positions
    0..written-1 were written: -1 where empty, wrapped past ``cap``."""
    kv_pos = np.full(cap, -1, np.int32)
    for p in range(written):
        kv_pos[p % cap] = p
    return kv_pos


# name: (B, Sq, K, G, Skv, Dh, q positions, kv positions, causal, window)
MODEL_CASES = {
    "prefill-gqa": (2, 24, 2, 2, 24, 32, np.arange(24), np.arange(24),
                    True, None),
    "prefill-mqa-window": (1, 40, 1, 4, 40, 16, np.arange(40),
                           np.arange(40), True, 8),
    "decode-ring-empty-slots": (2, 1, 2, 4, 16, 16, np.array([9]),
                                ring_positions(16, 10), True, None),
    "decode-ring-wrapped": (2, 1, 2, 4, 8, 64, np.array([20]),
                            ring_positions(8, 21), True, 8),
    "decode-mha": (3, 1, 4, 1, 33, 128, np.array([30]),
                   ring_positions(33, 31), True, None),
    # recurrentgemma-2b's local attention: head dim 256, one KV head of
    # 10 queries, the window binding in prefill and a wrapped ring
    "prefill-dh256-window": (1, 20, 1, 10, 20, 256, np.arange(20),
                             np.arange(20), True, 8),
    "decode-dh256-ring-wrapped": (2, 1, 1, 10, 8, 256, np.array([20]),
                                  ring_positions(8, 21), True, 8),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_model_layout_matches_reference_layer(dtype, name, backend):
    tdt, jdt, tol = DTYPES[dtype]
    B, Sq, K, G, Skv, Dh, qp, kp, causal, window = MODEL_CASES[name]
    rng = np.random.default_rng(sorted(MODEL_CASES).index(name))
    q, k, v = (normal(rng, (B, Sq, K, G, Dh)), normal(rng, (B, Skv, K, Dh)),
               normal(rng, (B, Skv, K, Dh)))
    qp, kp = qp.astype(np.int32), kp.astype(np.int32)
    want = RL.attention_ref(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        jnp.broadcast_to(qp, (B, Sq)), jnp.broadcast_to(kp, (B, Skv)),
        causal=causal, window=window,
        kv_valid=jnp.broadcast_to(kp >= 0, (B, Skv)))
    got = L.attention(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
                      torch.as_tensor(qp), torch.as_tensor(kp),
                      causal=causal, window=window, backend=backend)
    assert got.shape == (B, Sq, K, G, Dh) and got.dtype == tdt
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


def test_strided_cache_is_read_in_place():
    """k/v as slices of a stacked (L, B, cap, K, Dh) cache give what
    contiguous copies give."""
    rng = np.random.default_rng(7)
    cache = torch.as_tensor(normal(rng, (3, 2, 12, 2, 16)))
    q = torch.as_tensor(normal(rng, (2, 1, 2, 2, 16)))
    qp = torch.tensor([7], dtype=torch.int32)
    kp = torch.as_tensor(ring_positions(12, 8))
    got = flash_attention(q, cache[1], cache[2], qp, kp)
    want = attention_ref(q, cache[1].contiguous(), cache[2].contiguous(),
                         qp, kp)
    assert torch.equal(got, want)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(1, 4, 2, 2, 16)
    k = torch.zeros(1, 6, 2, 16)
    qp, kp = torch.arange(4, dtype=torch.int32), \
        torch.arange(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="q_pos"):
        flash_attention(q, k, k, kp, kp)
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, k, k, qp.long(), kp)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.bfloat16(), k, qp, kp)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, k, qp, kp, window=0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(*(t.to("meta") for t in (q, k, k, qp, kp)))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 6), (False, 6)])
def test_attention_mask_matches_reference(causal, window):
    """The (Sq, Skv) mask against the reference layer's ``_build_mask``
    (with ``kv_valid`` for the empty slots), every row written out: a
    non-causal mask without a window too, whose count of attended pairs
    the chip script's bounds read."""
    q_pos = np.arange(9, 21, dtype=np.int32)
    kv_pos = np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                       14, 15, 16, 17, 18, 19, 20, -1], np.int32)
    want = RL._build_mask(jnp.asarray(q_pos)[None], jnp.asarray(kv_pos)[None],
                          causal, window,
                          jnp.asarray(kv_pos >= 0)[None])[0, 0, 0]
    got = attention_mask(torch.as_tensor(q_pos), torch.as_tensor(kv_pos),
                         causal, window)
    assert got.shape == (len(q_pos), len(kv_pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not causal and window is None:
        assert int(got.sum()) == len(q_pos) * 21
