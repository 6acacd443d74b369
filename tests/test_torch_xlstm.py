"""The port's ssm slice against the JAX package: the mLSTM (recurrent
step, sequential and chunkwise forms), the sLSTM (cell and sequence) and
``XLSTMModel``.

Inputs are made with numpy from a seed (the reference's parameters with
``jax.random`` and carried across with
``repro_torch.convert.ssm_params_from_numpy``).  Tolerances: the cores at
1e-5 (absolute and relative; all float32), the model's logits, loss and
states at 2e-3 (``tests/test_torch_rglru.py``'s, the fp32 smoke config),
greedy tokens exact.  The port runs with ``kernel_backend="cuda"`` unless
a test says otherwise: on CPU tensors the RMSNorm wrapper takes its plain
version.  The kernel path on a card is ``tests/test_torch_gpu.py``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as R  # noqa: E402
from repro.models.registry import get_config as ref_get_config  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import ssm_params_from_numpy  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.models import xlstm as P  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ARCH = "xlstm-125m"
ATOL = 2e-3
CORE_TOL = 1e-5
# (S, chunk): one whole chunk, a padded second chunk, a prompt shorter
# than the chunk, four chunks
CHUNK_CASES = [(16, 16), (20, 16), (7, 16), (64, 16)]
# the smoke config (one (mlstm, slstm) unit and an mlstm tail) and a
# 4-layer variant with no tail
MODEL_CASES = {"smoke": {}, "4-layer": {"n_layers": 4}}


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def close(got, want, atol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol,
                               err_msg=what)


def torch_tree(tree):
    """A reference subtree (no layer stacking) as float32 tensors."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def close_tree(got: dict, want: dict, atol, what):
    assert set(got) == set(want), what
    for k in want:
        close(got[k], want[k], atol, f"{what} {k}")


# ------------------------------------------------------------- mLSTM ----

D_IN, HEADS, BATCH = 32, 4, 2


def mlstm_inputs(seed, S, with_state):
    """The reference's mLSTM parameters, x (B,S,d_in), and (with_state)
    the state the reference's sequential form leaves after a 9-token
    prefix, or None."""
    p = R.mlstm_init(jax.random.PRNGKey(seed), D_IN, HEADS, jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, S, D_IN)).astype(np.float32)
    state = None
    if with_state:
        prefix = rng.standard_normal((BATCH, 9, D_IN)).astype(np.float32)
        _, state = R.mlstm_sequential(p, jnp.asarray(prefix), HEADS)
    return p, x, state


def test_mlstm_recurrent_step_matches_reference():
    B, H, Dh = 3, 2, 8
    rng = np.random.default_rng(0)
    state = {"C": rng.standard_normal((B, H, Dh, Dh)).astype(np.float32),
             "n": rng.standard_normal((B, H, Dh)).astype(np.float32),
             "m": rng.standard_normal((B, H)).astype(np.float32)}
    q, k, v = (rng.standard_normal((B, H, Dh)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((B, H)).astype(np.float32)
    log_f = -rng.uniform(0.01, 3.0, (B, H)).astype(np.float32)
    args = (q, k, v, i_pre, log_f)
    want_st, want_h = R.mlstm_recurrent_step(
        {k_: jnp.asarray(a) for k_, a in state.items()},
        *map(jnp.asarray, args))
    got_st, got_h = P.mlstm_recurrent_step(
        {k_: torch.as_tensor(a) for k_, a in state.items()},
        *map(torch.as_tensor, args))
    close(got_h, want_h, CORE_TOL, "h")
    close_tree(got_st, want_st, CORE_TOL, "state")
    # from the zero state: m = -1e30 gives way to the first input gate
    zero = P.mlstm_state_init(B, H, Dh, "cpu")
    assert float(zero["m"].max()) == float(np.float32(-1e30))
    assert zero["m"].dtype == torch.float32
    want_st, want_h = R.mlstm_recurrent_step(
        R.mlstm_state_init(B, H, Dh), *map(jnp.asarray, args))
    got_st, got_h = P.mlstm_recurrent_step(zero, *map(torch.as_tensor, args))
    close(got_h, want_h, CORE_TOL, "h from zero")
    close_tree(got_st, want_st, CORE_TOL, "state from zero")


@pytest.mark.parametrize("with_state", [True, False],
                         ids=["state", "zero-state"])
@pytest.mark.parametrize("case", CHUNK_CASES, ids=str)
def test_mlstm_forms_match_reference(case, with_state):
    """The port's sequential and chunkwise forms against the reference's
    (both forms), outputs and final state, and the port's chunkwise form
    against its own sequential one."""
    S, chunk = case
    p, x, state = mlstm_inputs(CHUNK_CASES.index(case), S, with_state)
    tp, tx = torch_tree(p), torch.as_tensor(x)
    tstate = None if state is None else torch_tree(state)
    want = {"sequential": R.mlstm_sequential(p, jnp.asarray(x), HEADS,
                                             state),
            "chunkwise": R.mlstm_chunkwise(p, jnp.asarray(x), HEADS,
                                           chunk=chunk, state=state)}
    got = {"sequential": P.mlstm_sequential(tp, tx, HEADS, tstate),
           "chunkwise": P.mlstm_chunkwise(tp, tx, HEADS, chunk=chunk,
                                          state=tstate)}
    for name, (h, st) in got.items():
        assert h.shape == (BATCH, S, D_IN) and h.dtype == torch.float32
        for ref_name, (wh, wst) in want.items():
            what = f"port {name} vs reference {ref_name}"
            close(h, wh, CORE_TOL, what)
            close_tree(st, wst, CORE_TOL, what + " state")
    (h, st), (sh, sst) = got["chunkwise"], got["sequential"]
    close(h, sh.numpy(), CORE_TOL, "chunkwise vs sequential")
    close_tree(st, {k: v.numpy() for k, v in sst.items()}, CORE_TOL,
               "chunkwise vs sequential state")


def test_mlstm_qkv_keeps_the_activation_dtype():
    """q, k scaled in the activation dtype; the gates float32 from
    x.float() @ w_gates, as the reference."""
    p = R.mlstm_init(jax.random.PRNGKey(1), D_IN, HEADS, jnp.bfloat16)
    x = np.random.default_rng(1).standard_normal((2, 5, D_IN))
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k in ("w_gates", "b_gates") else torch.bfloat16)
        for k, v in p.items() if k != "out_norm"}
    tx = torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16)
    q, k, v, i_pre, log_f = P._mlstm_qkv(tp, tx, HEADS)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    assert i_pre.dtype == log_f.dtype == torch.float32
    wq, wk, wv, wi, wf = R._mlstm_qkv(p, jnp.asarray(x, jnp.bfloat16), HEADS)
    for got, want, tol in ((q, wq, 2e-2), (k, wk, 2e-2), (v, wv, 2e-2),
                           (i_pre, wi, 1e-5), (log_f, wf, 1e-5)):
        close(got, np.asarray(want, np.float32), tol)


# ------------------------------------------------------------- sLSTM ----

D_S = 32


@pytest.mark.parametrize("with_state", [True, False],
                         ids=["state", "zero-state"])
def test_slstm_matches_reference(with_state):
    """One cell from precomputed preactivations, the decode step and the
    sequence form (13 steps), with a state left by a prefix or from
    zero."""
    p = R.slstm_init(jax.random.PRNGKey(5), D_S, HEADS, jnp.float32)
    tp = torch_tree(p)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, 13, D_S)).astype(np.float32)
    state = R.slstm_state_init(BATCH, D_S, HEADS)
    if with_state:
        prefix = rng.standard_normal((BATCH, 5, D_S)).astype(np.float32)
        _, state = R.slstm_sequential(p, jnp.asarray(prefix), HEADS)
    tstate = torch_tree(state)
    if not with_state:
        close_tree(P.slstm_state_init(BATCH, D_S, HEADS, "cpu"), state, 0.0,
                   "zero state")

    pre = rng.standard_normal((BATCH, 4 * D_S)).astype(np.float32)
    want_st, want_h = R.slstm_cell(p, state, jnp.asarray(pre), HEADS)
    got_st, got_h = P.slstm_cell(tp, tstate, torch.as_tensor(pre), HEADS)
    close(got_h, want_h, CORE_TOL, "cell h")
    close_tree(got_st, want_st, CORE_TOL, "cell state")

    want_st, want_h = R.slstm_step(p, state, jnp.asarray(x[:, 0]), HEADS)
    got_st, got_h = P.slstm_step(tp, tstate, torch.as_tensor(x[:, 0]), HEADS)
    close(got_h, want_h, CORE_TOL, "step h")
    close_tree(got_st, want_st, CORE_TOL, "step state")

    want_h, want_st = R.slstm_sequential(p, jnp.asarray(x), HEADS,
                                         state if with_state else None)
    got_h, got_st = P.slstm_sequential(tp, torch.as_tensor(x), HEADS,
                                       tstate if with_state else None)
    close(got_h, want_h, CORE_TOL, "sequential h")
    close_tree(got_st, want_st, CORE_TOL, "sequential state")


def test_slstm_gates_are_split_per_head():
    """Each head's 4 Dh block of the preactivation holds its own i, f, z,
    o: moving head 0's z block changes head 0's h alone."""
    p = torch_tree(R.slstm_init(jax.random.PRNGKey(2), D_S, HEADS,
                                jnp.float32))
    st = P.slstm_state_init(1, D_S, HEADS, "cpu")
    pre = torch.zeros(1, 4 * D_S)
    Dh = D_S // HEADS
    _, h0 = P.slstm_cell(p, st, pre, HEADS)
    pre[0, 2 * Dh:3 * Dh] = 1.0          # head 0's z
    _, h1 = P.slstm_cell(p, st, pre, HEADS)
    moved = (h1 != h0)[0].reshape(HEADS, Dh).any(dim=1)
    assert moved.tolist() == [True] + [False] * (HEADS - 1)


# ------------------------------------------------------------- model ----


def build(case="smoke", backend="cuda", dtype=None):
    over = dict(MODEL_CASES[case])
    if dtype is not None:
        over.update(param_dtype=dtype, activation_dtype=dtype)
    ref_cfg = ref_get_config(ARCH, smoke=True).replace(**over)
    cfg = get_config(ARCH, smoke=True).replace(**over)
    ref = ref_get_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    model = get_model(cfg, device="cpu", kernel_backend=backend)
    return ref, ref_params, model, ssm_params_from_numpy(tree, cfg,
                                                         device="cpu")


def ref_block_states(ref_caches, model):
    """The reference's states in the port's layout: a list of unit dicts
    (the stacked leaves indexed) and the tail's list."""
    units = [{name: {k: v[u] for k, v in st.items()}
              for name, st in ref_caches["units"].items()}
             for u in range(model.n_units)]
    return units, list(ref_caches.get("tail", []))


def close_states(caches, ref_caches, model, what):
    units, tail = ref_block_states(ref_caches, model)
    assert len(caches["units"]) == len(units) == model.n_units
    for got, want in zip(caches["units"], units):
        assert set(got) == set(want)
        for name in want:
            close_tree(got[name], want[name], ATOL, f"{what} {name}")
    assert len(caches.get("tail", [])) == len(tail) == len(model.tail)
    for j, (got, want) in enumerate(zip(caches.get("tail", []), tail)):
        close_tree(got, want, ATOL, f"{what} tail {j}")
    assert caches["pos"] == int(ref_caches["pos"])


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_matches_reference(case):
    """forward and loss, prefill's last logits and every state leaf, then
    4 decode steps: a 20-token prompt, so each mLSTM block's chunkwise
    form runs a padded second chunk of the smoke config's 16."""
    ref, ref_params, model, params = build(case)
    cfg = model.cfg
    assert model.tail == (("mlstm",) if case == "smoke" else ())
    rng = np.random.default_rng(sorted(MODEL_CASES).index(case))
    B, S, steps = 2, 20, 4
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    want, _ = ref.forward(ref_params, jnp.asarray(tokens))
    got, aux = model.forward(params, torch.as_tensor(tokens))
    close(got, want, ATOL, "forward")
    assert float(aux) == 0.0 and got.dtype == torch.float32
    want_loss, want_parts = ref.loss(
        ref_params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels)})
    got_loss, parts = model.loss(params, {"tokens": torch.as_tensor(tokens),
                                          "labels": torch.as_tensor(labels)})
    close(got_loss, want_loss, CORE_TOL, "loss")
    assert float(parts["ce"]) == float(got_loss) and float(parts["aux"]) == \
        float(want_parts["aux"]) == 0.0

    want_last, ref_caches = ref.prefill(ref_params, jnp.asarray(tokens))
    got_last, caches = model.prefill(params, torch.as_tensor(tokens),
                                     max_len=S + steps + 1)
    close(got_last, want_last, ATOL, "prefill")
    close_states(caches, ref_caches, model, "prefill")

    feed = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    for i in range(steps):
        want_step, ref_caches = ref.decode_step(
            ref_params, jnp.asarray(feed[i]), ref_caches)
        got_step, caches = model.decode_step(params,
                                             torch.as_tensor(feed[i]), caches)
        close(got_step, want_step, ATOL, f"decode step {i}")
    close_states(caches, ref_caches, model, "after decode")


def test_decode_continues_the_forward_pass():
    """Prefill of a prefix, then one decode step a token, gives the
    forward pass's logits at every later position (the recurrent step
    against the chunkwise form inside the model)."""
    _, _, model, params = build()
    tokens = torch.as_tensor(np.random.default_rng(7).integers(0, 512,
                                                               (2, 23)))
    full, _ = model.forward(params, tokens)
    last, caches = model.prefill(params, tokens[:, :17])
    close(last, full[:, 16].numpy(), ATOL, "position 16")
    for t in range(17, 23):
        last, caches = model.decode_step(params, tokens[:, t:t + 1], caches)
        close(last, full[:, t].numpy(), ATOL, f"position {t}")


def test_cache_does_not_depend_on_the_context_length():
    _, _, model, _ = build()
    short, long = model.init_cache(2, 16), model.init_cache(2, 500_000)

    def shapes(c):
        return [t.shape for t in tree_leaves({k: v for k, v in c.items()
                                              if k != "pos"})]

    assert shapes(short) == shapes(long)
    assert short["pos"] == long["pos"] == 0


def test_greedy_outputs_equal_the_reference_engine():
    """Two waves of the smoke model through both packages' engines."""
    ref, ref_params, model, params = build()
    prompts = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (3, 18)).astype(np.int32)
    ref_eng = RefServeEngine(ref, ref_params, max_batch=2, max_len=32)
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=6) for p in prompts]
    ref_eng.run(ref_reqs)
    eng = ServeEngine(model, params, max_batch=2, max_len=32)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert eng.stats.tokens_out == 18 and eng.stats.waves == 2


def test_kernel_backend_on_cpu_tensors_is_the_plain_path():
    """The ``cuda`` backend on CPU tensors takes the RMSNorm wrapper's
    plain version: the ``torch`` backend's bits, and no launch."""
    _, _, kern, params = build(backend="cuda")
    _, _, plain, _ = build(backend="torch")
    tokens = torch.as_tensor(np.random.default_rng(8).integers(0, 512,
                                                               (2, 19)))
    rn.reset_launch_counts()
    a, ca = kern.prefill(params, tokens)
    b, cb = plain.prefill(params, tokens)
    assert torch.equal(a, b)
    a, _ = kern.decode_step(params, tokens[:, :1], ca)
    b, _ = plain.decode_step(params, tokens[:, :1], cb)
    assert torch.equal(a, b)
    assert torch.equal(kern.forward(params, tokens)[0],
                       plain.forward(params, tokens)[0])
    assert rn.LAUNCHES["rmsnorm"] == 0


def test_rmsnorm_calls_per_pass(monkeypatch):
    """Two RMSNorms a block and the final one, at the widths d_model and
    (the mLSTM's out_norm) d_in: 7 a pass at the smoke config's 3
    layers."""
    _, _, model, params = build()
    widths = []
    real = P.L.rmsnorm

    def counting(p, x, eps=1e-6, *, backend="cuda"):
        widths.append(x.shape[-1])
        return real(p, x, eps, backend=backend)

    monkeypatch.setattr(P.L, "rmsnorm", counting)
    tokens = torch.zeros((2, 5), dtype=torch.int64)
    _, caches = model.prefill(params, tokens)
    assert sorted(widths) == [64] * 5 + [128] * 2
    model.decode_step(params, tokens[:, :1], caches)
    assert len(widths) == 14 == 2 * (2 * model.cfg.n_layers + 1)
    assert model.d_in == 128


def test_bf16_model_keeps_states_and_gates_float32():
    ref, ref_params, model, params = build(dtype="bfloat16")
    tokens = torch.as_tensor(np.random.default_rng(9).integers(0, 512,
                                                               (2, 9)))
    logits, caches = model.prefill(params, tokens)
    assert logits.dtype == torch.float32
    for unit in caches["units"]:
        for st in unit.values():
            assert all(t.dtype == torch.float32 for t in st.values())
    logits, caches = model.decode_step(params, tokens[:, :1], caches)
    assert all(t.dtype == torch.float32 for t in caches["tail"][0].values())
    assert bool(torch.isfinite(logits).all())
    want, _ = ref.prefill(ref_params, jnp.asarray(tokens.numpy()))
    got, _ = model.prefill(params, tokens)
    # bf16 activations: a few bf16 roundings of the logits' scale
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    assert float(np.abs(got.numpy() - np.asarray(want, np.float32)).max()) \
        <= 5e-2 * scale


def test_param_count_matches_reference():
    for smoke, want in ((False, 134_300_976), (True, 219_920)):
        assert ref_get_model(ref_get_config(ARCH, smoke=smoke)) \
            .param_count() == want
        cfg = get_config(ARCH, smoke=smoke)
        assert cfg.param_count() == want
        model = get_model(cfg, device="cpu")
        assert model.param_count() == model.active_param_count() == want


def test_convert_keeps_gates_and_slstm_float32():
    """A bf16 config: the mLSTM's w_gates and b_gates and every sLSTM
    leaf stay float32 (the reference's init makes them so); the rest is
    bf16, carried exactly.  A wrong layer count or family raises."""
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    ref = ref_get_model(ref_get_config(ARCH, smoke=True)
                        .replace(param_dtype="bfloat16"))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params = ssm_params_from_numpy(tree, cfg, device="cpu")
    assert len(params["units"]) == 1 and len(params["tail"]) == 1
    unit = params["units"][0]
    want_unit = jax.tree.map(lambda a: a[0], tree["units"])
    for mlstm, want in ((unit["mlstm_0"], want_unit["mlstm_0"]),
                        (params["tail"][0], tree["tail"][0])):
        for name in ("w_gates", "b_gates"):
            t = mlstm["mlstm"][name]
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), want["mlstm"][name])
        for name in ("wq", "wk", "wv"):
            t = mlstm["mlstm"][name]
            assert t.dtype == torch.bfloat16 and t.is_contiguous()
            np.testing.assert_array_equal(
                t.float().numpy(), want["mlstm"][name].astype(np.float32))
        assert mlstm["w_up"].dtype == mlstm["mlstm"]["out_norm"]["scale"] \
            .dtype == torch.bfloat16
    for name, t in unit["slstm_1"]["slstm"].items():
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(),
                                      want_unit["slstm_1"]["slstm"][name])
    assert unit["slstm_1"]["ffn"]["w_gate"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="layers"):
        ssm_params_from_numpy(tree, cfg.replace(n_layers=5), device="cpu")
    with pytest.raises(NotImplementedError, match="ssm"):
        ssm_params_from_numpy(tree, get_config("yi-9b", smoke=True),
                              device="cpu")


def test_init_draws_the_reference_distributions():
    """wr truncated at 2 / sqrt(Dh); the gates and the sLSTM float32 in a
    bf16 config; the stabiliser-free parameters in its dtype; one seed,
    one set of weights."""
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="bfloat16")
    model = get_model(cfg, device="cpu")
    params = model.init(seed=2)
    slstm = params["units"][0]["slstm_1"]["slstm"]
    Dh = cfg.d_model // cfg.n_heads
    assert slstm["wr"].shape == (cfg.n_heads, Dh, 4 * Dh)
    assert float(slstm["wr"].abs().max()) <= 2.0 / Dh ** 0.5 + 1e-6
    assert all(t.dtype == torch.float32 for t in slstm.values())
    assert float(slstm["b"].abs().max()) == 0.0
    mlstm = params["tail"][0]["mlstm"]
    assert mlstm["w_gates"].dtype == mlstm["b_gates"].dtype == torch.float32
    assert mlstm["wq"].dtype == torch.bfloat16
    assert mlstm["w_gates"].shape == (model.d_in, 2 * cfg.n_heads)
    again = model.init(seed=2)
    assert torch.equal(again["tail"][0]["w_up"], params["tail"][0]["w_up"])


def test_model_refuses_other_families():
    with pytest.raises(ValueError, match="ssm"):
        P.XLSTMModel(get_config("recurrentgemma-2b", smoke=True),
                     device="cpu")
    cfg = get_config(ARCH, smoke=True)
    bad = cfg.replace(hybrid=type(cfg.hybrid)(pattern=("mlstm", "rec")))
    with pytest.raises(ValueError, match="blocks"):
        P.XLSTMModel(bad, device="cpu")


def test_trainer_refuses_the_ssm_family():
    model = get_model(get_config(ARCH, smoke=True), device="cpu")
    with pytest.raises(NotImplementedError, match="ssm training.*ROADMAP"):
        Trainer(model, RunConfig())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_serve_cli_smoke_on_cpu(backend):
    stats = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--prompt-len", "20",
                        "--max-new", "4", "--kernel-backend", backend])
    assert stats.tokens_out == 12 and stats.waves == 1
