"""The split-KV decode route of the port's attention, on the CPU.

Every CUDA call with one query position takes the split-KV decode kernel:
the cache is cut into ``ops.decode_splits(B, K, Skv)`` contiguous splits
(``ref.split_range``), each block writes its split's running max,
denominator and unnormalised output, and a second pass merges them in
split order.  The kernel runs only on a GPU (``tests/test_torch_gpu.py``).
Here the split count's rule is held, and the plain two-pass twin
``attention_decode_split_ref`` is held against the port's
``attention_ref`` (float32, 1e-6: the two differ only in the order of
fp32 sums) and the JAX package's ``repro.models.layers.attention_ref`` on
the same numpy inputs (2e-5, ``tests/test_kernels.py``'s float32
tolerance), at 1, 2, 7 and Skv splits (one key each).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_decode_split_ref, attention_ref, decode_splits, split_range)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    DECODE_TARGET_BLOCKS, DECODE_TILE_KEYS)


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


# (B, K, Skv): the five decode shapes of the serve paths (yi-9b,
# mixtral-8x22b, its window wave's wrapped ring, recurrentgemma-2b, its
# window wave's), with the split count the rule gives, then edges
SERVED_SPLITS = {(4, 4, 1057): 17, (4, 8, 1057): 12, (1, 8, 4096): 43,
                 (4, 1, 1057): 34, (1, 1, 2048): 64}
EDGE_SHAPES = [(1, 1, 1), (1, 1, 31), (1, 1, 32), (1, 1, 65), (2, 3, 100),
               (64, 8, 4096), (300, 1, 10), (1, 1, 8200), (3, 5, 777)]


@pytest.mark.parametrize("shape", sorted(SERVED_SPLITS) + EDGE_SHAPES,
                         ids=str)
def test_decode_splits_cover_every_slot_once(shape):
    B, K, skv = shape
    splits = decode_splits(B, K, skv)
    tiles = -(-skv // DECODE_TILE_KEYS)
    # no more splits than the kernel's tiles, and none of them empty
    assert 1 <= splits <= tiles
    seen = np.zeros(skv, np.int64)
    for s in range(splits):
        start, end = split_range(skv, splits, s)
        assert 0 <= start < end <= skv
        seen[start:end] += 1
    assert (seen == 1).all()
    # the target where the cache has tiles enough, else a tile a split
    want = -(-DECODE_TARGET_BLOCKS // (B * K))
    if want <= tiles:
        assert B * K * splits >= DECODE_TARGET_BLOCKS
    else:
        assert splits == tiles


@pytest.mark.parametrize("shape", sorted(SERVED_SPLITS), ids=str)
def test_decode_splits_at_the_served_shapes(shape):
    assert decode_splits(*shape) == SERVED_SPLITS[shape]


def ring_positions(cap, written):
    kv_pos = np.full(cap, -1, np.int32)
    for p in range(written):
        kv_pos[p % cap] = p
    return kv_pos


# name: (B, K, G, Dh, query position, kv positions, window)
CASES = {
    "ring-empty-slots-g6": (2, 2, 6, 32, 40, ring_positions(70, 41), None),
    "ring-wrapped-window-g10": (1, 2, 10, 64, 150, ring_positions(64, 151),
                                16),
    # a binding window over a straight cache: the first splits attend
    # nothing
    "splits-attend-nothing-g1": (2, 4, 1, 16, 59, np.arange(60), 10),
    "g20-ring-empty": (1, 1, 20, 64, 29, ring_positions(40, 30), None),
    # recurrentgemma-2b's window decode: one KV head of 10 queries at head
    # dim 256 over its wrapped 2,048-slot ring
    "recurrentgemma-window-decode": (1, 1, 10, 256, 2311,
                                     ring_positions(2048, 2312), 2048),
}
SPLITS = ["1", "2", "7", "skv"]


def case_inputs(name, empty_value=None):
    B, K, G, Dh, qp, kp, window = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    skv = len(kp)
    q = rng.standard_normal((B, 1, K, G, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, skv, K, Dh)).astype(np.float32)
            for _ in range(2))
    if empty_value is not None:
        k[:, kp < 0] = empty_value
        v[:, kp < 0] = empty_value
    return q, k, v, np.array([qp], np.int32), kp.astype(np.int32), window


def n_splits(name, splits):
    return len(CASES[name][5]) if splits == "skv" else int(splits)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_ref_matches_both_references(name, splits):
    q, k, v, qp, kp, window = case_inputs(name)
    B, skv = q.shape[0], len(kp)
    got = attention_decode_split_ref(
        *(torch.as_tensor(a) for a in (q, k, v, qp, kp)),
        n_splits(name, splits), causal=True, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    want = attention_ref(*(torch.as_tensor(a) for a in (q, k, v, qp, kp)),
                         causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    jref = RL.attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.broadcast_to(qp, (B, 1)),
        jnp.broadcast_to(kp, (B, skv)), causal=True, window=window,
        kv_valid=jnp.broadcast_to(kp >= 0, (B, skv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("splits", SPLITS)
def test_split_ref_never_reads_an_empty_slot(splits):
    """A ring cache's empty slot may hold NaN: the twin reads only the
    keys the query attends, as the kernel's copies do, so NaN there gives
    the same bits as zeros."""
    name = "ring-empty-slots-g6"
    zeros, nans = (attention_decode_split_ref(
        *(torch.as_tensor(a) for a in case_inputs(name, fill)[:5]),
        n_splits(name, splits), causal=True, window=CASES[name][6])
        for fill in (0.0, float("nan")))
    assert torch.isfinite(zeros).all()
    assert torch.equal(zeros, nans)


@pytest.mark.parametrize("splits", [1, 3])
def test_split_ref_row_attending_nothing_is_zero(splits):
    """Every key lies after the query's position: the kernels return 0
    where the reference's softmax over all -1e30 scores gives the mean
    of v."""
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.standard_normal((1, 1, 2, 3, 16)),
                        dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((1, 40, 2, 16)),
                            dtype=torch.float32) for _ in range(2))
    qp = torch.tensor([5], dtype=torch.int32)
    kp = torch.arange(10, 50, dtype=torch.int32)
    got = attention_decode_split_ref(q, k, v, qp, kp, splits)
    assert torch.equal(got, torch.zeros_like(q))


def test_split_ref_in_bfloat16_matches_attention_ref():
    """bf16 in and out, fp32 inside: within 5e-2 of ``attention_ref``
    (the bf16 tolerance of ``tests/test_kernels.py``), which also rounds
    its weights to bf16."""
    q, k, v, qp, kp, window = case_inputs("recurrentgemma-window-decode")
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    tqp, tkp = torch.as_tensor(qp), torch.as_tensor(kp)
    got = attention_decode_split_ref(tq, tk, tv, tqp, tkp,
                                     decode_splits(1, 1, len(kp)),
                                     causal=True, window=window)
    assert got.dtype == torch.bfloat16
    want = attention_ref(tq, tk, tv, tqp, tkp, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=5e-2, rtol=5e-2)
