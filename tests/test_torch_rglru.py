"""The port's hybrid slice against the JAX package: the RG-LRU scan, its
gates and conv, and ``RGLRUModel``.

Inputs are made with numpy from a seed (the reference's parameters with
``jax.random`` and carried across with
``repro_torch.convert.hybrid_params_from_numpy``).  Tolerances are the
reference's own: the scan at 1e-5 (``tests/test_kernels.py``'s
``test_lru_scan_sweep``), the model's scan against the associative and
the sequential scans at atol 1e-5 / rtol 1e-4
(``test_rg_lru_pallas_matches_model_scan``), the model's logits at 2e-3
(``tests/test_models_smoke.py``, fp32 smoke config).  The port runs with
``kernel_backend="cuda"`` unless a test says otherwise: on CPU tensors
the ``lru_scan`` wrapper takes its plain version.  The CUDA kernel runs
only on a GPU (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rg_lru import lru_scan as pallas_lru_scan  # noqa: E402
from repro.kernels.rg_lru import lru_scan_ref as jax_lru_scan_ref  # noqa
from repro.kernels.rg_lru import rg_lru_pallas  # noqa: E402
from repro.models import rglru as R  # noqa: E402
from repro.models.registry import get_config as ref_get_config  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro_torch.convert import hybrid_params_from_numpy  # noqa: E402
from repro_torch.kernels.rg_lru import (LAUNCHES, lru_scan,  # noqa: E402
                                        lru_scan_ref, reset_launch_counts)
from repro_torch.models import rglru as P  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402

ARCH = "recurrentgemma-2b"
ATOL = 2e-3
# B, S, W, chunk, block_w: tests/test_kernels.py's test_lru_scan_sweep
SCAN_CASES = [(1, 16, 32, 8, 16), (2, 75, 96, 16, 32), (3, 128, 64, 128, 64),
              (1, 200, 48, 32, 48)]


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def scan_inputs(rng, B, S, W):
    a = rng.uniform(0.4, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


def close(got, want, atol, rtol=None, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=atol if rtol is None else rtol,
                               err_msg=what)


def torch_tree(tree):
    """A reference parameter subtree (no layer stacking) as float32
    tensors."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zero-state"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_lru_scan_matches_reference_and_pallas(case, with_h0):
    B, S, W, chunk, bw = case
    rng = np.random.default_rng(SCAN_CASES.index(case))
    a, b, h0 = scan_inputs(rng, B, S, W)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.as_tensor(h0) if with_h0 else None
    want_y, want_h = jax_lru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)
    pal_y, pal_h = pallas_lru_scan(jnp.asarray(a), jnp.asarray(b), jh0,
                                   chunk=chunk, block_w=bw)
    reset_launch_counts()
    for fn in (lru_scan_ref, lru_scan):
        y, h = fn(torch.as_tensor(a), torch.as_tensor(b), th0)
        assert y.shape == (B, S, W) and h.shape == (B, W)
        assert y.dtype == h.dtype == torch.float32
        for wy, wh, what in ((want_y, want_h, "lru_scan_ref"),
                             (pal_y, pal_h, "Pallas lru_scan")):
            close(y, wy, 1e-5, what=f"{fn.__name__} y vs {what}")
            close(h, wh, 1e-5, what=f"{fn.__name__} h_last vs {what}")
        np.testing.assert_array_equal(h.numpy(), y[:, -1].numpy())
    # the CPU path is the plain version, not a launch
    assert LAUNCHES == {"lru_scan": 0}


def test_lru_scan_checks_its_inputs():
    a = torch.rand(2, 5, 8)
    with pytest.raises(TypeError, match="float32"):
        lru_scan(a.double(), a.double())
    with pytest.raises(ValueError, match=r"\(B, S, W\)"):
        lru_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="h0 must be"):
        lru_scan(a, a, torch.zeros(2, 5))
    with pytest.raises(TypeError, match="float32"):
        lru_scan(a, a, torch.zeros(2, 8, dtype=torch.bfloat16))
    y, h = lru_scan(a[:, :0], a[:, :0], torch.ones(2, 8))
    assert y.shape == (2, 0, 8) and torch.equal(h, torch.ones(2, 8))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_rg_lru_scan_matches_the_reference_scans(backend):
    """The port's scan (gates in PyTorch, then the recurrence) against
    the reference's associative scan, its sequential oracle and its Pallas
    wrapper (interpret mode), with and without an initial state."""
    B, S, W = 2, 40, 64
    p = R.rg_lru_init(jax.random.PRNGKey(8), W)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    tp = torch_tree(p)
    for init in (h0, None):
        jh0 = None if init is None else jnp.asarray(init)
        th0 = None if init is None else torch.as_tensor(init)
        y, h = P.rg_lru_scan(tp, torch.as_tensor(x), th0, backend=backend)
        refs = {"associative": R.rg_lru_scan(p, jnp.asarray(x), h0=jh0),
                "sequential": R.rg_lru_sequential(p, jnp.asarray(x), jh0),
                "pallas": rg_lru_pallas(p, jnp.asarray(x), jh0, chunk=16,
                                        block_w=32)}
        for name, (wy, wh) in refs.items():
            close(y, wy, 1e-5, 1e-4, f"y vs {name}, h0={init is not None}")
            close(h, wh, 1e-5, 1e-4, f"h vs {name}, h0={init is not None}")
    sy, sh = P.rg_lru_sequential(tp, torch.as_tensor(x), torch.as_tensor(h0))
    wy, wh = R.rg_lru_sequential(p, jnp.asarray(x), jnp.asarray(h0))
    close(sy, wy, 1e-5, 1e-4, "rg_lru_sequential y")
    close(sh, wh, 1e-5, 1e-4, "rg_lru_sequential h")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_matches_reference(dtype):
    """The causal conv over a sequence and its one-step form, summed in
    float32 and returned in the input's dtype (exact in float32 to
    round-off; one bf16 rounding apart at most in bfloat16)."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    B, S, W, k = 2, 11, 24, 4
    p = R.conv1d_init(jax.random.PRNGKey(3), W, k)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    buf = rng.standard_normal((B, k - 1, W)).astype(np.float32)
    tp = torch_tree(p)
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    tol = 1e-6 if dtype == "float32" else 1e-2
    got = P.conv1d_causal(tp, tx)
    assert got.dtype == tdt
    close(got, R.conv1d_causal(p, jx).astype(jnp.float32), tol,
          what="conv1d_causal")
    want_y, want_buf = R.conv1d_step(p, jx[:, 0], jnp.asarray(buf, jdt))
    got_y, got_buf = P.conv1d_step(tp, tx[:, 0], torch.as_tensor(buf)
                                   .to(tdt))
    assert got_y.dtype == got_buf.dtype == tdt
    close(got_y, want_y.astype(jnp.float32), tol, what="conv1d_step y")
    close(got_buf, want_buf.astype(jnp.float32), 0.0, what="conv1d_step buf")


def build(backend="cuda"):
    ref_cfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    model = get_model(cfg, device="cpu", kernel_backend=backend)
    return ref, ref_params, model, hybrid_params_from_numpy(tree, cfg,
                                                            device="cpu")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_model_matches_reference(backend):
    """forward, prefill and decode of the smoke config (1 unit of
    (rec, rec, attn) and 2 tail rec blocks, an 8-token local window): a
    12-token prompt, so the window binds in prefill, then 7 decode steps,
    so the ring cache wraps."""
    ref, ref_params, model, params = build(backend)
    cfg = model.cfg
    assert model.n_units == 1 and model.tail == ("rec", "rec")
    rng = np.random.default_rng(11)
    B, S, steps = 2, 12, 7
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    max_len = S + steps + 1

    want, _ = ref.forward(ref_params, jnp.asarray(tokens))
    got, aux = model.forward(params, torch.as_tensor(tokens))
    close(got, want, ATOL, what="forward")
    assert float(aux) == 0.0

    want_last, ref_caches = ref.prefill(ref_params, jnp.asarray(tokens),
                                        max_len=max_len)
    got_last, caches = model.prefill(params, torch.as_tensor(tokens),
                                     max_len=max_len)
    close(got_last, want_last, ATOL, what="prefill")
    assert caches["pos"] == S
    assert caches["attn"]["k"].shape == (1, B, cfg.local_window, 1, 16)
    # recurrent states: the unit's two blocks, then the tail's two
    ref_states = [ref_caches["units"][f"rec_{i}"] for i in (0, 1)]
    ref_states = [{k: v[0] for k, v in s.items()} for s in ref_states]
    ref_states += ref_caches["tail"]
    assert len(caches["rec"]) == len(ref_states) == 4
    for got_s, want_s in zip(caches["rec"], ref_states):
        close(got_s["h"], want_s["h"], ATOL, what="prefill state h")
        close(got_s["conv"], want_s["conv"], ATOL, what="prefill state conv")

    feed = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    for i in range(steps):
        want_step, ref_caches = ref.decode_step(
            ref_params, jnp.asarray(feed[i]), ref_caches)
        got_step, caches = model.decode_step(params,
                                             torch.as_tensor(feed[i]), caches)
        close(got_step, want_step, ATOL, what=f"decode step {i}")
    # the ring wrapped: every slot holds one of the last `window` positions
    kv_pos = caches["attn"]["kv_pos"].tolist()
    assert sorted(kv_pos) == list(range(S + steps - 8, S + steps))
    np.testing.assert_array_equal(
        np.asarray(ref_caches["units"]["attn_2"]["kv_pos"][0]), kv_pos)
    for got_s, want_s in zip(caches["rec"][2:], ref_caches["tail"]):
        close(got_s["h"], want_s["h"], ATOL, what="tail state h")


def test_prefill_runs_one_scan_per_recurrent_block(monkeypatch):
    """The model's prefill calls the scan wrapper once per recurrent
    block, decode never, and the ``torch`` backend never (it takes the
    plain version): counted here at the wrapper, where the card counts
    kernel launches."""
    _, _, model, params = build()
    calls = []
    real = P.lru_scan

    def counting(a, b, h0=None):
        calls.append(tuple(a.shape))
        return real(a, b, h0)

    monkeypatch.setattr(P, "lru_scan", counting)
    tokens = torch.zeros((2, 5), dtype=torch.int64)
    _, caches = model.prefill(params, tokens, max_len=8)
    assert calls == [(2, 5, 64)] * 4
    model.decode_step(params, tokens[:, :1], caches)
    assert len(calls) == 4
    _, _, plain, plain_params = build("torch")
    plain.prefill(plain_params, tokens, max_len=8)
    assert len(calls) == 4


def test_short_prompt_keeps_a_zero_padded_conv_state():
    """A prompt shorter than the conv's k-1 = 3 taps: the state holds the
    prompt's inputs behind zeros, and decoding on matches a forward pass
    over the whole sequence."""
    _, _, model, params = build()
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, 512, (2, 6)))
    last, caches = model.prefill(params, tokens[:, :2], max_len=8)
    assert caches["rec"][0]["conv"].shape == (2, 3, 64)
    assert float(caches["rec"][0]["conv"][:, 0].abs().max()) == 0.0
    steps = [last]
    for t in range(2, 6):
        logits, caches = model.decode_step(params, tokens[:, t:t + 1],
                                           caches)
        steps.append(logits)
    full, _ = model.forward(params, tokens)
    for t, logits in enumerate(steps):
        close(logits, full[:, t + 1].numpy(), ATOL, what=f"position {t + 1}")


def test_param_count_matches_reference():
    for smoke in (False, True):
        want = ref_get_model(ref_get_config(ARCH, smoke=smoke)).param_count()
        cfg = get_config(ARCH, smoke=smoke)
        assert cfg.param_count() == want
        model = get_model(cfg, device="cpu")
        assert model.param_count() == model.active_param_count() == want
    # 26 blocks of recurrentgemma-2b plus the 256,000 x 2,560 embedding
    assert get_config(ARCH).param_count() == 2_894_574_080


def test_convert_keeps_lru_and_conv_float32():
    """A bf16 config: every leaf under ``lru`` and ``conv`` stays float32
    (the reference's init makes them so); the rest is bf16, carried
    exactly."""
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    ref = ref_get_model(ref_get_config(ARCH, smoke=True)
                        .replace(param_dtype="bfloat16"))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params = hybrid_params_from_numpy(tree, cfg, device="cpu")
    assert len(params["units"]) == 1 and len(params["tail"]) == 2
    blocks = [(params["units"][0]["rec_0"],
               jax.tree.map(lambda a: a[0], tree["units"]["rec_0"])),
              (params["tail"][1], tree["tail"][1])]
    for got, want in blocks:
        for sub in ("lru", "conv"):
            for name, t in got["rec"][sub].items():
                assert t.dtype == torch.float32, (sub, name)
                np.testing.assert_array_equal(t.numpy(),
                                              want["rec"][sub][name])
        for name in ("wx", "wy", "wo"):
            t = got["rec"][name]
            assert t.dtype == torch.bfloat16 and t.is_contiguous()
            np.testing.assert_array_equal(
                t.float().numpy(), want["rec"][name].astype(np.float32))
    attn = params["units"][0]["attn_2"]["attn"]["wq"]
    assert attn.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        attn.float().numpy(),
        tree["units"]["attn_2"]["attn"]["wq"][0].astype(np.float32))
    with pytest.raises(ValueError, match="layers"):
        hybrid_params_from_numpy(tree, cfg.replace(n_layers=8), device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid"):
        hybrid_params_from_numpy(tree, get_config("yi-9b", smoke=True),
                                 device="cpu")


def test_init_draws_the_reference_distributions():
    """lam such that a = exp(-8 softplus(lam)) at r = 1 lies in
    (0.9, 0.999); the conv taps truncated at 2 / sqrt(k); the gates and
    taps float32 in a bf16 config."""
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    params = get_model(cfg, device="cpu").init(seed=2)
    rec = params["units"][0]["rec_1"]["rec"]
    a = torch.exp(-P.LRU_C * torch.nn.functional.softplus(rec["lru"]["lam"]))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert rec["lru"]["wa"].dtype == rec["conv"]["w"].dtype == torch.float32
    assert rec["wx"].dtype == torch.bfloat16
    assert float(rec["conv"]["w"].abs().max()) <= 2.0 / 2.0 + 1e-6
    again = get_model(cfg, device="cpu").init(seed=2)
    assert torch.equal(again["tail"][0]["rec"]["wy"],
                       params["tail"][0]["rec"]["wy"])
