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
from repro_torch.kernels.rmsnorm import ops  # noqa: E402
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


# one case per check the wrapper keeps: (x, scale, error, message)
BAD_INPUTS = {
    "rank": (lambda: torch.zeros(8), lambda: torch.ones(8), ValueError,
             r"x must be \(N, D\)"),
    "scale-shape": (lambda: torch.zeros(3, 8), lambda: torch.ones(7),
                    ValueError, "scale"),
    "dtype": (lambda: torch.zeros(3, 8, dtype=torch.float64),
              lambda: torch.ones(8, dtype=torch.float64), TypeError,
              "float32 or bfloat16"),
    "scale-dtype": (lambda: torch.zeros(3, 8, dtype=torch.bfloat16),
                    lambda: torch.ones(8), TypeError, "x's dtype"),
    "devices-differ": (lambda: torch.zeros(3, 8),
                       lambda: torch.ones(8, device="meta"), ValueError,
                       "different devices"),
    "no-kernel-for-device": (lambda: torch.zeros(3, 8, device="meta"),
                             lambda: torch.ones(8, device="meta"),
                             ValueError, "no kernel for device meta"),
    "overlapping-rows": (lambda: torch.zeros(16).as_strided((3, 8), (4, 1)),
                         lambda: torch.ones(8), ValueError, "not overlap"),
    "broadcast-rows": (lambda: torch.zeros(8).expand(3, 8),
                       lambda: torch.ones(8), ValueError, "not overlap"),
    "column-stride": (lambda: torch.zeros(3, 16)[:, ::2],
                      lambda: torch.ones(8), ValueError,
                      "rows must be contiguous"),
    "scale-not-contiguous": (lambda: torch.zeros(3, 8),
                             lambda: torch.ones(16)[::2], ValueError,
                             "scale contiguous"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_checks_its_inputs(case):
    """Each check raises on the CPU as it does on the card: the checks
    run before the wrapper looks at the device."""
    make_x, make_scale, error, message = BAD_INPUTS[case]
    reset_launch_counts()
    with pytest.raises(error, match=message):
        rmsnorm(make_x(), make_scale())
    assert LAUNCHES["rmsnorm"] == 0


@pytest.mark.parametrize("n", [1, 3])
def test_wrapper_takes_strided_rows(n):
    """Rows of a wider buffer (a row stride above D) and, for one row,
    any row stride pass the checks and match the plain version."""
    x, s = inputs(n, 24, 11)
    big = torch.as_tensor(np.concatenate([x, x[:, :5]], axis=1))
    got = rmsnorm(big[:, :24], torch.as_tensor(s))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), as_np(jax_rmsnorm_ref(
        jnp.asarray(x), jnp.asarray(s), 1e-6)), atol=2e-5, rtol=2e-5)


PLAN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the register route at the serve paths' widths, bf16: (threads, vectors)
SERVE_PLANS = {1536: (192, 1), 2560: (160, 2), 4096: (256, 2),
               6144: (192, 4)}


def config_widths() -> "list[int]":
    """Every row width the port's configs normalise: d_model, the head
    dim of a config with per-head q/k norm, and the mLSTM's ``out_norm``
    width d_in of an ssm config."""
    from repro_torch.models.registry import PORTED_ARCH_IDS, get_config
    from repro_torch.models.xlstm import XLSTMModel

    widths = set()
    for arch in PORTED_ARCH_IDS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            widths.add(cfg.d_model)
            if cfg.qk_norm:
                widths.add(cfg.resolved_head_dim)
            if cfg.family == "ssm":
                widths.add(XLSTMModel(cfg, device="meta").d_in)
    return sorted(widths)


@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("d", [1536, 2560, 4096, 5120, 6144, 7168])
def test_plan_register_route_at_model_widths(d, dtype):
    """The serve paths' widths and the other configs' d_model take the
    one-pass register route, every thread of the row holding the same
    number of vectors, in whole warps."""
    dt = PLAN_DTYPES[dtype]
    p = ops.plan(d, dt, True)
    per_vec = 16 // (torch.finfo(dt).bits // 8)
    assert p.route == "register"
    assert p.threads % 32 == 0 and p.threads <= max(ops.REGISTER_THREADS)
    assert p.vecs in ops.REGISTER_VECS
    assert p.threads * p.vecs * per_vec == d
    if dt == torch.bfloat16 and d in SERVE_PLANS:
        assert (p.threads, p.vecs) == SERVE_PLANS[d]
    # unaligned rows (a misaligned view) take the loop
    assert ops.plan(d, dt, False) == ops.Plan("loop", ops.LOOP_THREADS, 0)


@pytest.mark.parametrize("d,aligned,route", [
    (80, True, "narrow"),         # qwen3-32b's per-head q/k norm
    (768, True, "narrow"),        # xlstm-125m's d_model
    (128, True, "narrow"),
    (128, False, "narrow"),
    (1, True, "narrow"),
    (1001, True, "narrow"),
    (1025, False, "loop"),        # odd D: unaligned rows
    (8200, True, "loop"),         # 1,025 vectors: no even split
    (1 << 16, True, "loop"),      # wider than the register route
])
def test_plan_narrow_and_loop_routes(d, aligned, route):
    """Off the register route the plan is the route alone: a block of
    the kernel's fixed size, no vectors a thread to hold."""
    for dt in PLAN_DTYPES.values():
        assert ops.plan(d, dt, aligned) == ops.Plan(route, ops.LOOP_THREADS,
                                                    0)


# the register kernel's instances: 16-byte vectors a thread
# (csrc/rmsnorm.cu), and its launch bound
KERNEL_VECS = (1, 2, 4, 8)
KERNEL_MAX_THREADS = 512


def even_splits(d: int, dtype) -> "dict[int, int]":
    """Every split of a row's 16-byte vectors that the register kernel
    runs, by brute force: {vectors a thread: threads}, the threads whole
    warps within the launch bound and each holding the same number."""
    n_bytes = d * torch.finfo(dtype).bits // 8
    splits = {}
    for vecs in KERNEL_VECS:
        for threads in range(32, KERNEL_MAX_THREADS + 1, 32):
            if threads * vecs * 16 == n_bytes:
                splits[vecs] = threads
    return splits


@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_plan_splits_rows_evenly(dtype):
    """A register plan is a split the kernel runs (whole warps within
    its launch bound, the same vectors in every thread), within 256
    threads wherever such a split exists, with the fewest vectors a
    thread among those; an aligned row of 1,024 or more takes the loop
    only where no split exists.  Every width of the port's configs, and
    every multiple of 8 up to 20,000."""
    dt = PLAN_DTYPES[dtype]
    assert {80, 128, 768, 1536} <= set(config_widths())
    widths = sorted(set(config_widths()) | set(range(1024, 20001, 8)))
    assert {80, 2560, 4096, 5120, 6144, 7168} <= set(widths)
    for d in widths:
        p = ops.plan(d, dt, True)
        if d < ops.NARROW_BELOW:
            assert p.route == "narrow", d
            continue
        splits = even_splits(d, dt)
        if not splits:
            assert p.route == "loop", d
            continue
        assert p.route == "register", d
        assert splits.get(p.vecs) == p.threads, d
        small = [v for v, t in splits.items() if t <= 256]
        if small:
            assert p.vecs == min(small), d
        else:
            assert p.vecs == min(splits), d


def test_call_plan_follows_the_alignment():
    """The plan a call takes reads the alignment from the tensors: a view
    one element into its buffer, or rows of an odd stride, loops."""
    x = torch.zeros(4, 4096 + 1, dtype=torch.bfloat16)
    s = torch.ones(4096, dtype=torch.bfloat16)
    want = ops.plan(4096, torch.bfloat16, True)
    assert ops.call_plan(x[:, :4096].contiguous(), s) == want
    assert ops.call_plan(x[:, 1:], s).route == "loop"
    assert ops.call_plan(x[:, :4096], s).route == "loop"
    assert ops.call_plan(x[:1, :4096], s) == want


@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("d,aligned,device", [
    (80, True, 0), (1025, False, 1), (4096, True, 0), (6144, True, 3),
    (8200, True, 0), ((1 << 31) - 1, True, 255)])
def test_launch_word_packs_the_plan(dtype, d, aligned, device):
    """The entry point's one word carries the dtype, the plan's route and
    vecs, the device and D, each in its field of ``LAUNCH_WORD``."""
    dt = PLAN_DTYPES[dtype]
    p = ops.plan(d, dt, aligned)
    word = ops.launch_word(d, dt, aligned, device)
    assert 0 <= word < 1 << 63
    assert ops.LAUNCH_WORD.unpack(word) == {
        "dtype": int(dt == torch.bfloat16), "route": ops.ROUTE_CODES[p.route],
        "vecs": p.vecs, "device": device, "d": d}


@pytest.mark.parametrize("field,value", [
    ("device", 256), ("device", -1), ("d", 1 << 31), ("vecs", 16),
    ("route", 4)])
def test_launch_word_refuses_what_a_field_cannot_hold(field, value):
    """A value wider than its field raises instead of spilling into the
    next field or being cut."""
    values = {"dtype": 1, "route": 0, "vecs": 2, "device": 0, "d": 4096}
    values[field] = value
    with pytest.raises(ValueError, match=f"{field}={value} does not fit"):
        ops.LAUNCH_WORD.pack(**values)
