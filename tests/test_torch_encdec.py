"""The port's audio slice against the JAX package: the layers the
encoder-decoder adds (LayerNorm, the GELU MLP, the sinusoidal positions)
and ``EncDecLM`` (encode, forward, loss and its gradient, prefill and
decode).

Inputs are made with numpy from a seed (the reference's parameters with
``jax.random``, carried across with
``repro_torch.convert.encdec_params_from_numpy``); the config is
whisper-small's smoke config in float32.  Tolerances: the layer functions
at 1e-6 (absolute and relative), the model's logits, loss and caches at
2e-3 (the other model tests'), the gradient within 1e-5 of each leaf's
max |g|, greedy tokens exact.  The port runs with
``kernel_backend="cuda"`` unless a test says otherwise: on CPU tensors
the attention wrapper takes its plain version.  The kernel path on a card
is ``tests/test_torch_gpu.py``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.serve import main as ref_serve_main  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.registry import get_config as ref_get_config  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import encdec_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import encdec as P  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ARCH = "whisper-small"
ATOL = 2e-3
LAYER_TOL = 1e-6
GRAD_TOL = 1e-5
# (batch, decoder tokens, encoder frames): the smoke tests' S // 2 frames,
# and the edge case of 13 frames under a 1-token prompt
MODEL_CASES = {"12-tokens": (2, 12, 6), "13-frames-1-token": (2, 1, 13)}


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


# ------------------------------------------------------------ layers ----


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 768)], ids=str)
def test_layernorm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    d = shape[-1]
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    p = {"scale": rng.standard_normal(d).astype(np.float32),
         "bias": rng.standard_normal(d).astype(np.float32)}
    want = RL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    close(PL.layernorm(torch_tree(p), torch.as_tensor(x)), want, LAYER_TOL)
    # the init: scale 1, bias 0, in the given dtype
    init = PL.layernorm_init(d, torch.bfloat16, "cpu")
    ref_init = RL.layernorm_init(d, jnp.bfloat16)
    for k in ("scale", "bias"):
        assert init[k].dtype == torch.bfloat16
        close(init[k], ref_init[k], 0.0, k)


def test_layernorm_keeps_the_activation_dtype():
    """bf16 in, bf16 out, computed in float32 (the reference's casts)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    p = {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}
    got = PL.layernorm({k: torch.tensor(v).bfloat16() for k, v in p.items()},
                       torch.tensor(x).bfloat16())
    want = RL.layernorm({k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in p.items()}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of values of size ~3
    close(got, np.asarray(want, np.float32), 2e-2)


def test_gelu_mlp_matches_reference():
    """The tanh approximation (``jax.nn.gelu``'s default), in float32."""
    p = RL.gelu_mlp_init(jax.random.PRNGKey(4), 64, 128, jnp.float32)
    rng = np.random.default_rng(4)
    p = {k: np.asarray(v) for k, v in p.items()}
    # non-zero biases, so the bias adds are held too
    p["b1"] = rng.standard_normal(128).astype(np.float32)
    p["b2"] = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    want = RL.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    close(PL.gelu_mlp(torch_tree(p), torch.as_tensor(x)), want, LAYER_TOL)
    tp = PL.gelu_mlp_init(torch.Generator().manual_seed(0), 64, 128,
                          torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in p.items()}
    assert float(tp["b1"].abs().max()) == float(tp["b2"].abs().max()) == 0.0


@pytest.mark.parametrize("n,d", [(13, 64), (64, 64), (16, 768)])
def test_sinusoidal_positions_match_reference(n, d):
    want = RL.sinusoidal_positions(n, d)
    got = PL.sinusoidal_positions(n, d, "cpu")
    assert got.dtype == torch.float32
    close(got, want, LAYER_TOL)
    for pos in (0, 1, n // 2, n - 1):
        at = PL.sinusoidal_position_at(pos, d, "cpu")
        close(at, RL.sinusoidal_position_at(jnp.asarray(pos, jnp.int32), d),
              LAYER_TOL, f"position {pos}")
        # one position's embedding is that row of the table
        np.testing.assert_array_equal(at.numpy(), got[pos:pos + 1].numpy())


# ------------------------------------------------------------- model ----


def build(backend="cuda", dtype=None):
    over = {} if dtype is None else dict(param_dtype=dtype,
                                         activation_dtype=dtype)
    ref_cfg = ref_get_config(ARCH, smoke=True).replace(**over)
    cfg = get_config(ARCH, smoke=True).replace(**over)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    model = get_model(cfg, device="cpu", kernel_backend=backend)
    return ref, ref_params, model, encdec_params_from_numpy(tree, cfg,
                                                            device="cpu")


def inputs(case, vocab=512, d=64):
    """tokens and labels (B, S) int32, frames 0.1 x N(0, 1) (B, S_enc, d),
    as the reference's smoke tests draw them."""
    B, S, S_enc = MODEL_CASES[case]
    rng = np.random.default_rng(sorted(MODEL_CASES).index(case))
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    frames = (0.1 * rng.standard_normal((B, S_enc, d))).astype(np.float32)
    return tokens, labels, frames


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_encode_and_forward_match_reference(case):
    ref, ref_params, model, params = build()
    tokens, _, frames = inputs(case)
    want = ref.encode(ref_params, jnp.asarray(frames))
    got = model.encode(params, torch.as_tensor(frames))
    close(got, want, ATOL, "encode")
    want, want_aux = ref.forward(ref_params, jnp.asarray(tokens),
                                 jnp.asarray(frames))
    got, aux = model.forward(params, torch.as_tensor(tokens),
                             torch.as_tensor(frames))
    assert got.dtype == torch.float32
    close(got, want, ATOL, "forward")
    assert float(aux) == float(want_aux) == 0.0


def test_loss_and_gradient_match_reference():
    """The loss at 2e-3; its gradient by autograd on the plain path
    against ``jax.grad``, each leaf within 1e-5 of its max |g|
    (``tests/test_models_smoke.py``'s train step, held leaf by leaf)."""
    ref, ref_params, model, params = build(backend="torch")
    tokens, labels, frames = inputs("12-tokens")
    ref_batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
                 "frames": jnp.asarray(frames)}
    batch = {k: torch.tensor(np.asarray(v)) for k, v in ref_batch.items()}

    want_loss, want_grads = jax.value_and_grad(
        lambda p: ref.loss(p, ref_batch)[0])(ref_params)
    leaves = list(PL.tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss, parts = model.loss(params, batch)
    close(loss, want_loss, ATOL, "loss")
    assert float(parts["ce"].detach()) == float(loss.detach())
    assert float(parts["aux"]) == 0.0
    grads = torch.autograd.grad(loss, leaves)

    # the reference's gradient in the port's layout: layer i of each group
    def port_layout(tree):
        out = {k: v for k, v in tree.items()
               if k not in ("enc_layers", "dec_layers")}
        for group, n in (("enc_layers", 2), ("dec_layers", 2)):
            out[group] = [jax.tree.map(lambda a, i=i: np.asarray(a[i]),
                                       tree[group]) for i in range(n)]
        return out

    want_leaves = list(PL.tree_leaves(port_layout(
        jax.tree.map(np.asarray, want_grads))))
    assert len(want_leaves) == len(grads) == 2 * 12 + 2 * 18 + 5
    for i, (g, w) in enumerate(zip(grads, want_leaves)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, i
        top = float(np.abs(w).max())
        gap = float(np.abs(g.numpy() - w).max())
        assert gap <= GRAD_TOL * top, (i, gap, top)
    assert any(float(g.abs().max()) > 0 for g in grads)


def close_caches(caches, ref_caches, model, what):
    n = model.cfg.n_layers
    ref_self = ref_caches["self"]
    for name in ("k", "v"):
        close(caches["self"][name], ref_self[name], ATOL,
              f"{what} self {name}")
    for i in range(n):
        np.testing.assert_array_equal(caches["self"]["kv_pos"].numpy(),
                                      np.asarray(ref_self["kv_pos"][i]))
    for name in ("cross_k", "cross_v"):
        close(caches[name], ref_caches[name], ATOL, f"{what} {name}")
    assert caches["pos"] == int(ref_caches["pos"])


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_prefill_and_decode_match_reference(case):
    """prefill's last logits, self caches and cross caches at 2e-3; then 8
    decode steps, each package fed its own greedy token: the tokens equal
    and the logits at 2e-3, the caches after them too."""
    ref, ref_params, model, params = build()
    tokens, _, frames = inputs(case)
    B, S, S_enc = MODEL_CASES[case]
    steps = 8
    max_len = S + steps + 3
    want, ref_caches = ref.prefill(ref_params, jnp.asarray(tokens),
                                   jnp.asarray(frames), max_len=max_len)
    got, caches = model.prefill(params, torch.as_tensor(tokens),
                                torch.as_tensor(frames), max_len=max_len)
    close(got, want, ATOL, "prefill")
    assert caches["self"]["k"].shape == (model.cfg.n_layers, B, max_len, 4,
                                         16)
    assert caches["cross_k"].shape == (model.cfg.n_layers, B, S_enc, 4, 16)
    close_caches(caches, ref_caches, model, "prefill")
    for i in range(steps):
        ref_tok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(got, -1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
        want, ref_caches = ref.decode_step(ref_params, ref_tok, ref_caches)
        got, caches = model.decode_step(params, tok, caches)
        close(got, want, ATOL, f"decode step {i}")
    close_caches(caches, ref_caches, model, "after decode")


def test_decode_continues_the_forward_pass():
    """Prefill of a prefix, then one decode step a token, gives the
    forward pass's logits at every later position."""
    _, _, model, params = build()
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, 512, (2, 15)))
    frames = torch.as_tensor(
        (0.1 * rng.standard_normal((2, 9, 64))).astype(np.float32))
    full, _ = model.forward(params, tokens, frames)
    last, caches = model.prefill(params, tokens[:, :10], frames, max_len=15)
    close(last, full[:, 9].numpy(), ATOL, "position 9")
    for t in range(10, 15):
        last, caches = model.decode_step(params, tokens[:, t:t + 1], caches)
        close(last, full[:, t].numpy(), ATOL, f"position {t}")


def test_attention_calls_per_pass(monkeypatch):
    """Every attention goes through ``layers.attention``: per encoder
    layer one non-causal call over the frames; per decoder layer a causal
    self-attention and a non-causal cross-attention over the frames, at
    prefill and at each decode step (the cross one over the cache)."""
    _, _, model, params = build()
    calls = []
    real = PL.attention

    def counting(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                 backend="cuda"):
        calls.append((q.shape[1], k.shape[1], causal, window, backend))
        return real(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                    backend=backend)

    monkeypatch.setattr(PL, "attention", counting)
    tokens, _, frames = inputs("12-tokens")
    _, caches = model.prefill(params, torch.as_tensor(tokens),
                              torch.as_tensor(frames), max_len=16)
    enc, dec = model.cfg.encdec.n_encoder_layers, model.cfg.n_layers
    assert calls == [(6, 6, False, None, "cuda")] * enc + \
        [(12, 12, True, None, "cuda"), (12, 6, False, None, "cuda")] * dec
    calls.clear()
    model.decode_step(params, torch.zeros((2, 1), dtype=torch.int64), caches)
    assert calls == [(1, 16, True, None, "cuda"),
                     (1, 6, False, None, "cuda")] * dec


def test_kernel_backend_on_cpu_tensors_is_the_plain_path():
    """The ``cuda`` backend on CPU tensors takes the attention wrapper's
    plain version: the ``torch`` backend's bits, and no launch."""
    _, _, kern, params = build(backend="cuda")
    _, _, plain, _ = build(backend="torch")
    tokens, _, frames = inputs("12-tokens")
    tokens, frames = torch.as_tensor(tokens), torch.as_tensor(frames)
    fa.reset_launch_counts()
    rn.reset_launch_counts()
    a, ca = kern.prefill(params, tokens, frames, max_len=14)
    b, cb = plain.prefill(params, tokens, frames, max_len=14)
    assert torch.equal(a, b)
    a, _ = kern.decode_step(params, tokens[:, :1], ca)
    b, _ = plain.decode_step(params, tokens[:, :1], cb)
    assert torch.equal(a, b)
    assert torch.equal(kern.forward(params, tokens, frames)[0],
                       plain.forward(params, tokens, frames)[0])
    assert not any(fa.LAUNCHES.values()) and not any(rn.LAUNCHES.values())


def test_bf16_model_matches_reference():
    """A bf16 config: the port's prefill within 5e-2 of max |logit| of
    the reference's, and its decode step's, both finite float32."""
    ref, ref_params, model, params = build(dtype="bfloat16")
    assert params["dec_layers"][0]["mlp"]["w1"].dtype == torch.bfloat16
    tokens, _, frames = inputs("12-tokens")
    want, ref_caches = ref.prefill(ref_params, jnp.asarray(tokens),
                                   jnp.asarray(frames), max_len=14)
    got, caches = model.prefill(params, torch.as_tensor(tokens),
                                torch.as_tensor(frames), max_len=14)
    assert got.dtype == torch.float32 and caches["cross_k"].dtype == \
        torch.bfloat16
    for what in ("prefill", "decode"):
        w = np.asarray(want, np.float32)
        assert bool(torch.isfinite(got).all()), what
        assert float(np.abs(got.numpy() - w).max()) <= \
            5e-2 * float(np.abs(w).max()), what
        tok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
        want, ref_caches = ref.decode_step(ref_params, tok, ref_caches)
        got, caches = model.decode_step(params, torch.tensor(
            np.asarray(tok)), caches)


def test_enc_len_matches_reference():
    ref = ref_get_model(ref_get_config(ARCH, smoke=True))
    model = get_model(get_config(ARCH, smoke=True), device="cpu")
    for seq_len in (1, 2, 15, 16, 17, 3000, 4096):
        assert model.enc_len(seq_len) == ref.enc_len(seq_len), seq_len
    assert model.enc_len(3000) == 1500 and model.enc_len(4) == 8


def test_param_count_matches_reference():
    """whisper-small at full size: 238,200,576 parameters (the reference's
    count), from shapes on the meta device, nothing allocated."""
    for smoke, want in ((False, 238_200_576), (True, None)):
        ref_n = ref_get_model(ref_get_config(ARCH, smoke=smoke)) \
            .param_count()
        assert want is None or ref_n == want
        cfg = get_config(ARCH, smoke=smoke)
        assert cfg.param_count() == ref_n
        model = get_model(cfg, device="cpu")
        assert model.param_count() == model.active_param_count() == ref_n
    meta = get_model(get_config(ARCH), device="cpu").init(device="meta")
    assert all(t.is_meta for t in PL.tree_leaves(meta))


def test_init_has_the_reference_shapes_and_distributions():
    """The port's own init: every leaf of the reference's tree, in the
    port's layout, at its shape; norms 1 and 0, biases 0; one seed, one
    set of weights."""
    ref = ref_get_model(ref_get_config(ARCH, smoke=True))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    model = get_model(get_config(ARCH, smoke=True), device="cpu")
    params = model.init(seed=1)
    converted = encdec_params_from_numpy(tree, model.cfg, device="cpu")
    shapes = PL.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == PL.tree_map(lambda t: tuple(t.shape), converted)
    lp = params["dec_layers"][1]
    assert float(lp["xattn_norm"]["scale"].min()) == 1.0
    assert float(lp["mlp"]["b1"].abs().max()) == 0.0
    assert float(params["enc_norm"]["bias"].abs().max()) == 0.0
    d = model.cfg.d_model
    assert float(lp["attn"]["wq"].abs().max()) <= 2.0 / d ** 0.5 + 1e-6
    again = model.init(seed=1)
    assert torch.equal(again["enc_layers"][0]["mlp"]["w1"],
                       params["enc_layers"][0]["mlp"]["w1"])


def test_convert_carries_bf16_and_refuses_other_trees():
    """A bf16 config: every leaf bf16, carried exactly, each layer a
    tensor of its own.  A wrong layer count or family raises."""
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    ref = ref_get_model(ref_get_config(ARCH, smoke=True)
                        .replace(param_dtype="bfloat16"))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params = encdec_params_from_numpy(tree, cfg, device="cpu")
    assert len(params["enc_layers"]) == len(params["dec_layers"]) == 2
    assert all(t.dtype == torch.bfloat16 for t in PL.tree_leaves(params))
    np.testing.assert_array_equal(
        params["dec_layers"][1]["xattn"]["wk"].float().numpy(),
        tree["dec_layers"]["xattn"]["wk"][1].astype(np.float32))
    assert params["enc_layers"][0]["attn"]["wq"].is_contiguous()
    with pytest.raises(ValueError, match="layers"):
        encdec_params_from_numpy(tree, cfg.replace(n_layers=3), device="cpu")
    bad = cfg.replace(encdec=type(cfg.encdec)(n_encoder_layers=3))
    with pytest.raises(ValueError, match="layers"):
        encdec_params_from_numpy(tree, bad, device="cpu")
    with pytest.raises(NotImplementedError, match="audio"):
        encdec_params_from_numpy(tree, get_config("yi-9b", smoke=True),
                                 device="cpu")


def test_serve_cli_refuses_the_audio_family():
    """``launch.serve --arch whisper-small`` exits with the reference's
    message, before any model is built."""
    with pytest.raises(SystemExit) as want:
        ref_serve_main(["--arch", ARCH, "--smoke"])
    with pytest.raises(SystemExit) as got:
        serve_main(["--arch", ARCH, "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "serve driver targets decoder LMs" in str(got.value)


def test_model_refuses_other_families_and_a_missing_device():
    with pytest.raises(ValueError, match="audio"):
        P.EncDecLM(get_config("yi-9b", smoke=True), device="cpu")
    cfg = get_config(ARCH, smoke=True)
    assert isinstance(get_model(cfg, device="cpu"), P.EncDecLM)
    with pytest.raises(NotImplementedError, match="audio"):
        Trainer(get_model(cfg, device="cpu"), RunConfig())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.EncDecLM(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(cfg)
