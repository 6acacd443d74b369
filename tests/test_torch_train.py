"""The port's training slice against the JAX package's, on the CPU.

A tiny float32 dense config with QKV bias and qk-norm (so that the
weight-decay decision on ``bq``/``bk``/``bv``, stacked ``(L, H*Dh)``
leaves in the reference and 1-d per-layer leaves in the port, shows).
The reference's parameters are moved off their init by numpy noise (every
bias and scale nonzero), and carried across with ``repro_torch.convert``;
batches come from the synthetic pipeline (numpy, from a seed).  The port
runs with ``kernel_backend="cuda"``: on CPU tensors the kernels' autograd
functions take their plain forward and backward versions.

Tolerances: batches bit for bit; ``warmup_cosine`` 1e-7; one AdamW update
fed the reference's own gradients 1e-6; the loss 1e-5; step-1 gradients
within 1e-5 of each leaf's max |g|; after three steps losses 1e-5 and
params at ``tests/test_trainer_serve.py``'s atol 1e-4 / rtol 1e-3.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import RunConfig as RefRunConfig  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.sharding import path_str  # noqa: E402
from repro.models.transformer import DecoderLM as RefDecoderLM  # noqa
from repro.optim.adamw import AdamW as RefAdamW  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro.train import fault as ref_fault  # noqa: E402
from repro.train.trainer import TrainState as RefTrainState  # noqa: E402
from repro.train.trainer import Trainer as RefTrainer  # noqa: E402
from repro_torch.configs.base import ModelConfig, RunConfig  # noqa: E402
from repro_torch.convert import (decoder_params_from_numpy,  # noqa: E402
                                 decoder_params_to_numpy,
                                 train_state_from_numpy)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.optim.adamw import AdamW, leaf_groups  # noqa: E402
from repro_torch.train import fault  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

FIELDS = dict(arch_id="tiny", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
              qkv_bias=True, qk_norm=True, param_dtype="float32",
              activation_dtype="float32")
B, S = 4, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors, thousands of small ops: under the test runner's
    parallel workers torch's thread pools would oversubscribe the
    cores, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    fields = {**FIELDS, **kw}
    return RefModelConfig(**fields), ModelConfig(**fields)


def noisy_params(ref_cfg, seed=0):
    """The reference's init, every leaf moved by numpy noise (std 0.05),
    as numpy arrays in the parameters' dtype (made once a config)."""
    return _noisy_params(ref_cfg, seed)


@functools.lru_cache(maxsize=None)
def _noisy_params(ref_cfg, seed):
    params = jax.jit(RefDecoderLM(ref_cfg).init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p, np.float32) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32)).astype(p.dtype), params)


@functools.lru_cache(maxsize=None)
def ref_loss_grad(ref_cfg):
    """The reference's jitted ``jax.grad`` of its loss (one compile a
    config)."""
    model = RefDecoderLM(ref_cfg)
    return jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))


def batch_np(step=0, seed=0):
    ds = ref_pipeline.SyntheticDataset(ref_pipeline.DataConfig(
        vocab_size=FIELDS["vocab_size"], seq_len=S, global_batch=B,
        seed=seed))
    return ds.batch(step)


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def flat(tree):
    return {path_str(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def trees_close(got, want, atol, rtol, what):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=f"{what} {k}")


def leafwise_close(got, want, tol, what):
    """Each leaf within ``tol`` of its max |want|."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        top = float(np.abs(w[k]).max())
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= tol * max(top, 1e-30), (what, k, err, top)


def port_model(cfg, **run_kw):
    run = RunConfig(**run_kw)
    return DecoderLM(cfg, run, device="cpu"), run


def port_state(trainer, tree_np, cfg):
    return trainer.state_from_params(
        decoder_params_from_numpy(tree_np, cfg, device="cpu"))


def ref_state(trainer, tree_np):
    params = jax.tree.map(jnp.asarray, tree_np)
    ef = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params) \
        if trainer.run.grad_compression == "int8_ef" else None
    return RefTrainState(params, trainer.opt.init(params), ef)


# --------------------------------------------------------------------------
# data, schedule, fault tolerance


@pytest.mark.parametrize("kind", ["lcg", "copy", "uniform"])
def test_synthetic_batches_bit_for_bit(kind):
    kw = dict(kind=kind, vocab_size=97, seq_len=24, global_batch=8, seed=3)
    ref = ref_pipeline.SyntheticDataset(ref_pipeline.DataConfig(**kw))
    port = pipeline.SyntheticDataset(pipeline.DataConfig(**kw))
    for step in (0, 1, 7):
        for n_shards in (1, 2, 4):
            for shard in range(n_shards):
                want = ref.batch(step, shard, n_shards)
                got = port.batch(step, shard, n_shards)
                for k in ("tokens", "labels"):
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    assert pipeline.loss_floor(pipeline.DataConfig(**kw)) == \
        ref_pipeline.loss_floor(ref_pipeline.DataConfig(**kw))
    pf = pipeline.Prefetcher(port, start_step=2)
    try:
        for step in (2, 3):
            got_step, got = next(pf)
            assert got_step == step
            np.testing.assert_array_equal(got["tokens"],
                                          ref.batch(step)["tokens"])
    finally:
        pf.close()


def test_run_config_has_the_reference_fields_and_defaults():
    assert dataclasses.asdict(RunConfig()) == \
        dataclasses.asdict(RefRunConfig())


def test_warmup_cosine_matches_reference():
    for warmup, total in ((10, 100), (0, 50), (1, 1), (20, 20), (5, 7)):
        for step in range(0, 120, 3):
            want = float(ref_schedule.warmup_cosine(
                jnp.asarray(step, jnp.int32), warmup, total))
            got = schedule.warmup_cosine(
                torch.tensor(step, dtype=torch.int32), warmup, total)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-7, (warmup, total, step)
    assert float(schedule.constant(torch.tensor(3))) == 1.0
    assert set(schedule.SCHEDULES) == set(ref_schedule.SCHEDULES)


def test_fault_tolerance_matches_reference():
    def heartbeats(mod):
        clock = iter([0.0, 0.0, 10.0, 40.0, 40.0, 50.0]).__next__
        hb = mod.HeartbeatMonitor(3, timeout_s=30.0, clock=clock)
        hb.beat(1)
        return hb.dead(), hb.alive()

    assert heartbeats(fault) == heartbeats(ref_fault) == ([0], [1])
    for shape, names, avail in (((2, 16, 16), ("pod", "data", "model"), 480),
                                ((16, 16), ("data", "model"), 250),
                                ((4, 8, 4), ("pod", "data", "model"), 100)):
        a = ref_fault.plan_remesh(shape, names, avail)
        b = fault.plan_remesh(shape, names, avail)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.usable_fraction == b.usable_fraction
    for mod in (ref_fault, fault):
        with pytest.raises(RuntimeError):
            mod.plan_remesh((2, 16), ("data", "model"), 8)
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 1.0, 5.0, 1.02, 0.98, 6.0, 1.0]
    ref_m, port_m = ref_fault.StragglerMonitor(), fault.StragglerMonitor()
    assert [ref_m.observe(t, rank=i) for i, t in enumerate(times)] == \
        [port_m.observe(t, rank=i) for i, t in enumerate(times)]
    assert ref_m.flagged == port_m.flagged and ref_m.mean == port_m.mean
    for n in (1, 8, 1024, 16384):
        assert ref_fault.failure_mttf_steps(n) == fault.failure_mttf_steps(n)
        assert ref_fault.checkpoint_cadence_steps(n, 30.0) == \
            fault.checkpoint_cadence_steps(n, 30.0)


# --------------------------------------------------------------------------
# the optimizer


def test_weight_decay_decision_matches_reference():
    """The reference decides on the stacked leaf; the port on its
    per-layer leaf with one axis more counted: every leaf agrees, and the
    QKV biases are decayed."""
    ref_cfg, cfg = configs()
    tree = noisy_params(ref_cfg)
    ref_opt, opt = RefAdamW(), AdamW()
    want = {}

    def visit(path, p):
        want[path_str(path)] = p.ndim >= 2 and ref_opt._decayed(path)

    jax.tree_util.tree_map_with_path(visit, tree)
    params = decoder_params_from_numpy(tree, cfg, device="cpu")
    got = {path: opt.decays(path, stacked, ts[0])
           for path, stacked, ts in leaf_groups(params)}
    assert got == want
    assert got["layers/attn/bq"] and got["layers/attn/bk"] \
        and got["layers/attn/bv"]
    assert not got["layers/attn/q_norm/scale"]
    assert not got["final_norm/scale"] and got["embed"]


ADAMW_CASES = {
    "default": ({}, "float32", 1.0),
    "clipped": ({}, "float32", 50.0),
    "no-clip": ({"grad_clip_norm": None}, "float32", 1.0),
    "bf16-state": ({"state_dtype": "bfloat16"}, "float32", 1.0),
    "master-weights": ({"master_weights": True}, "bfloat16", 1.0),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_reference(case):
    """One update fed the reference's own gradients (scaled so that the
    clipped case clips), twice in a row, at 1e-6."""
    kw, dtype, gscale = ADAMW_CASES[case]
    ref_cfg, _ = configs()
    tree = noisy_params(ref_cfg)
    grads = ref_loss_grad(ref_cfg)(jax.tree.map(jnp.asarray, tree),
                                   jax.tree.map(jnp.asarray, batch_np()))
    # bf16 parameters (and their gradients): the float32 ones rounded
    _, cfg = configs(param_dtype=dtype)
    tree = jax.tree.map(lambda p: np.asarray(p).astype(jnp.dtype(dtype)),
                        tree)
    params = jax.tree.map(jnp.asarray, tree)
    grads = jax.tree.map(lambda g: (g * gscale).astype(dtype), grads)
    ref_opt = RefAdamW(lr=1e-2, **kw)
    opt = AdamW(lr=1e-2, **kw)
    port_params = decoder_params_from_numpy(tree, cfg, device="cpu")
    port_grads = decoder_params_from_numpy(jax.tree.map(np.asarray, grads),
                                           cfg, device="cpu")
    rstate, pstate = ref_opt.init(params), opt.init(port_params)
    ref_update = jax.jit(ref_opt.update)
    for _ in range(2):
        params, rstate, rmet = ref_update(grads, rstate, params, 0.7)
        port_params, pstate, pmet = opt.update(port_grads, pstate,
                                               port_params, 0.7)
        # the norm sums ~10^4 squares in float32 in another order
        assert abs(float(pmet["grad_norm"]) - float(rmet["grad_norm"])) \
            <= 1e-5 * max(1.0, float(rmet["grad_norm"]))
    assert int(pstate.step) == int(rstate.step) == 2
    if case == "clipped":
        assert float(rmet["grad_norm"]) > 1.0
    # bf16 parameters are their fp32 master rounded once: where the two
    # masters (equal to 1e-6) straddle a rounding boundary, one bf16 ulp
    # (2^-7 of the value at most: 7 stored mantissa bits)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    trees_close(decoder_params_to_numpy(port_params), params, 1e-6,
                max(1e-6, ulp), case)
    for got, want in ((pstate.m, rstate.m), (pstate.v, rstate.v)):
        assert str(got["embed"].dtype).endswith(kw.get("state_dtype",
                                                       "float32"))
        trees_close(decoder_params_to_numpy(got), want, 1e-6, 1e-6, case)
    if kw.get("master_weights"):
        trees_close(decoder_params_to_numpy(pstate.master), rstate.master,
                    1e-6, 1e-6, case)


# --------------------------------------------------------------------------
# the model's loss and gradients, and the plain backward versions


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(masked):
    ref_cfg, cfg = configs()
    tree = noisy_params(ref_cfg)
    batch = batch_np()
    if masked:
        batch["valid"] = np.random.default_rng(1).random((B, S)) < 0.6
    ref_model = RefDecoderLM(ref_cfg)
    want, want_m = jax.jit(ref_model.loss)(jax.tree.map(jnp.asarray, tree),
                                           jax.tree.map(jnp.asarray, batch))
    model, _ = port_model(cfg)
    got, got_m = model.loss(decoder_params_from_numpy(tree, cfg,
                                                      device="cpu"),
                            to_torch(batch))
    assert abs(float(got) - float(want)) <= 1e-5
    assert abs(float(got_m["ce"]) - float(want_m["ce"])) <= 1e-5
    assert float(got_m["aux"]) == float(want_m["aux"]) == 0.0


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_step1_gradients_match_jax_grad(backend):
    """Leaf by leaf within 1e-5 of each leaf's max |g|; the ``cuda``
    backend goes through the kernels' autograd functions (their plain
    forward and backward versions on the CPU), ``torch`` through autograd
    of the plain layers."""
    ref_cfg, cfg = configs()
    tree = noisy_params(ref_cfg)
    batch = batch_np()
    want = ref_loss_grad(ref_cfg)(jax.tree.map(jnp.asarray, tree),
                                  jax.tree.map(jnp.asarray, batch))
    model = DecoderLM(cfg, device="cpu", kernel_backend=backend)
    trainer = Trainer(model, RunConfig())
    rn.reset_launch_counts()
    loss, _, grads = trainer._grads(
        decoder_params_from_numpy(tree, cfg, device="cpu"), to_torch(batch))
    leafwise_close(decoder_params_to_numpy(grads), want, 1e-5, backend)
    # the CPU path launches nothing
    assert rn.LAUNCHES["rmsnorm_backward"] == 0


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(remat):
    ref_cfg, cfg = configs()
    tree = noisy_params(ref_cfg)
    batch = to_torch(batch_np())
    out = {}
    for how in ("none", remat):
        model, run = port_model(cfg, remat=how)
        trainer = Trainer(model, run)
        loss, _, grads = trainer._grads(
            decoder_params_from_numpy(tree, cfg, device="cpu"), batch)
        out[how] = (float(loss), decoder_params_to_numpy(grads))
    assert out[remat][0] == out["none"][0]
    trees_close(out[remat][1], out["none"][1], 1e-7, 1e-6, remat)


ATTN_GRAD_CASES = {  # B, S, K, G, Dh, window
    "causal-gqa": (2, 12, 2, 3, 16, None),
    "window": (1, 20, 1, 4, 8, 5),
    "mha": (2, 9, 3, 1, 32, None),
}


@pytest.mark.parametrize("name", sorted(ATTN_GRAD_CASES))
def test_plain_attention_backward_matches_jax_vjp(name):
    """The plain backward, without and with the forward's saved LSE
    (``attention_lse_ref``), and the autograd function's CPU path (which
    saves the LSE in its forward and hands it to the backward), against
    ``jax.vjp`` of the reference's attention: each gradient within 1e-5
    of its max, the three paths bit for bit equal."""
    B_, S_, K, G, Dh, window = ATTN_GRAD_CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((B_, S_, K, G, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B_, S_, K, Dh)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B_, S_))
    @jax.jit
    def out_and_vjp(a, b, c, dout):
        out, vjp = jax.vjp(lambda a, b, c: RL.attention_ref(
            a, b, c, pos, pos, causal=True, window=window), a, b, c)
        return out, vjp(dout)

    out, want = out_and_vjp(q, k, v, do)
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    tpos = torch.arange(S_, dtype=torch.int32)
    o = fa.attention_ref(t[0], t[1], t[2], tpos, tpos, causal=True,
                         window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5)
    got = fa.attention_backward_ref(t[0], t[1], t[2], o, t[3], tpos, tpos,
                                    causal=True, window=window)
    lse = fa.attention_lse_ref(t[0], t[1], tpos, tpos, causal=True,
                               window=window)
    with_lse = fa.attention_backward_ref(t[0], t[1], t[2], o, t[3], tpos,
                                         tpos, causal=True, window=window,
                                         lse=lse)
    # the autograd function's CPU path carries the saved LSE
    leaves = [x.clone().requires_grad_(True) for x in t[:3]]
    y = fa.flash_attention_differentiable(*leaves, tpos, tpos, causal=True,
                                          window=window)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 7 and torch.equal(saved[-1], lse)
    fn = torch.autograd.grad(y, leaves, t[3])
    for g, gl, f, w in zip(got, with_lse, fn, want):
        w = np.asarray(w)
        tol = 1e-5 * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=tol)
        np.testing.assert_allclose(gl.numpy(), w, atol=tol)
        assert torch.equal(g, gl) and torch.equal(g, f)


# B, K, G, q positions, kv positions (-1 = an empty slot), window: the
# second case's first query (position 0) attends nothing, its keys
# starting at position 1
LSE_CASES = {
    "causal-gqa": (2, 2, 3, np.arange(12), np.arange(12), None),
    "window": (1, 1, 4, np.arange(3, 20), np.arange(20), 5),
    "ring-empty-row": (2, 2, 2, np.arange(0, 9),
                       np.array([4, 5, 6, -1, 1, 2, 3, -1, 7, 8]), None),
}


@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_attention_lse_ref_matches_jax_logsumexp(name):
    """``attention_lse_ref`` against ``jax.nn.logsumexp`` of the
    reference's masked scores (``NEG_INF`` where masked, so a row that
    attends nothing gives ``NEG_INF``, the sentinel the kernels write),
    in the kernels' (B, K, Sq, G) layout, at 1e-5 relative; and through
    ``flash_attention_with_lse`` on the CPU beside ``attention_ref``."""
    B_, K, G, qp, kp, window = LSE_CASES[name]
    Dh = 16
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((B_, len(qp), K, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B_, len(kp), K, Dh)).astype(np.float32)
    qp, kp = qp.astype(np.int32), kp.astype(np.int32)
    scores = jnp.einsum("bqkgd,bskd->bkgqs", q, k) / np.sqrt(Dh)
    mask = RL._build_mask(jnp.broadcast_to(qp, (B_, len(qp))),
                          jnp.broadcast_to(kp, (B_, len(kp))), True, window,
                          jnp.broadcast_to(kp >= 0, (B_, len(kp))))
    want = np.asarray(jax.nn.logsumexp(
        jnp.where(mask, scores, RL.NEG_INF), axis=-1)).transpose(0, 1, 3, 2)
    tq, tk = torch.as_tensor(q), torch.as_tensor(k)
    tqp, tkp = torch.as_tensor(qp), torch.as_tensor(kp)
    got = fa.attention_lse_ref(tq, tk, tqp, tkp, causal=True, window=window)
    assert got.shape == (B_, K, len(qp), G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    if name == "ring-empty-row":
        assert bool((got[:, :, 0] == fa.ref.NEG_INF).all())
        assert bool((got[:, :, 1:] > -100).all())
    out, lse = fa.flash_attention_with_lse(tq, tk, tk, tqp, tkp, causal=True,
                                           window=window)
    assert torch.equal(lse, got)
    assert torch.equal(out, fa.attention_ref(tq, tk, tk, tqp, tkp,
                                             causal=True, window=window))


def test_flash_attention_with_lse_decode_writes_none():
    """One query position takes the decode route, which writes no LSE:
    the CPU path mirrors it, and the backward recomputes the LSE."""
    q = torch.randn(1, 1, 2, 3, 16)
    k = torch.randn(1, 5, 2, 16)
    pos = torch.tensor([4], dtype=torch.int32)
    kv_pos = torch.arange(5, dtype=torch.int32)
    out, lse = fa.flash_attention_with_lse(q, k, k, pos, kv_pos)
    assert lse is None
    assert torch.equal(out, fa.attention_ref(q, k, k, pos, kv_pos))
    leaf = q.clone().requires_grad_(True)
    y = fa.flash_attention_differentiable(leaf, k, k, pos, kv_pos)
    assert y.grad_fn.saved_tensors[-1] is None
    (g,) = torch.autograd.grad(y, leaf, torch.ones_like(y))
    want = fa.attention_backward_ref(q, k, k, out, torch.ones_like(out),
                                     pos, kv_pos)[0]
    assert torch.equal(g, want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_flash_attention_backward_refuses_a_bad_lse(bad):
    q = torch.randn(1, 4, 2, 3, 16)
    k = torch.randn(1, 4, 2, 16)
    pos = torch.arange(4, dtype=torch.int32)
    lse = {"shape": torch.zeros(1, 2, 3, 4),
           "dtype": torch.zeros(1, 2, 4, 3, dtype=torch.float64),
           "strided": torch.zeros(1, 2, 3, 4).transpose(2, 3)}[bad]
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_backward(q, k, k, q, q, pos, pos, lse=lse)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt")])
def test_backward_route_table(dtype, route):
    """The backward's route follows the dtype alone: the tensor-core
    kernels for bfloat16, the CUDA-core ones for float32."""
    from repro_torch.kernels.flash_attention.ops import _backward_route
    assert _backward_route(dtype) == route


def test_plain_rmsnorm_backward_matches_jax_vjp():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    dy = rng.standard_normal((7, 48)).astype(np.float32)
    want = jax.jit(lambda a, s, d: jax.vjp(
        lambda a, s: RL.rmsnorm({"scale": s}, a, 1e-6), a, s)[1](d))(
            x, scale, dy)
    t = [torch.as_tensor(a) for a in (x, scale, dy)]
    got = rn.rmsnorm_backward_ref(*t, 1e-6)
    leaves = [a.clone().requires_grad_(True) for a in t[:2]]
    fn = torch.autograd.grad(rn.rmsnorm_differentiable(*leaves, 1e-6),
                             leaves, t[2])
    for g, f, w in zip(got, fn, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-5 * float(np.abs(w).max()))
        assert torch.equal(g, f)


# --------------------------------------------------------------------------
# train steps against the reference's


@functools.lru_cache(maxsize=None)
def ref_trainer(ref_cfg, ref_run):
    """The reference's trainer and its jitted step (one compile a run)."""
    tr = RefTrainer(RefDecoderLM(ref_cfg, ref_run), ref_run)
    return tr, tr.make_train_step()


def run_both(steps=3, **run_kw):
    """``steps`` train steps of the reference and the port from the same
    parameters and batches: (losses, params) of each."""
    ref_cfg, cfg = configs()
    tree = noisy_params(ref_cfg)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, **run_kw)
    ref_run, run = RefRunConfig(**kw), RunConfig(**kw)
    ref_tr, ref_step = ref_trainer(ref_cfg, ref_run)
    tr = Trainer(DecoderLM(cfg, run, device="cpu"), run)
    rstate, pstate = ref_state(ref_tr, tree), port_state(tr, tree, cfg)
    step = tr.make_train_step()
    ref_losses, losses = [], []
    for i in range(steps):
        b = batch_np(i)
        rstate, rm = ref_step(rstate, jax.tree.map(jnp.asarray, b))
        pstate, pm = step(pstate, to_torch(b))
        ref_losses.append(float(rm["loss"]))
        losses.append(float(pm["loss"]))
    return (ref_losses, rstate), (losses, pstate)


@pytest.mark.parametrize("variant", ["plain", "microbatches-4", "int8-ef"])
def test_train_steps_match_reference(variant):
    run_kw = {"plain": {}, "microbatches-4": {"microbatches": 4},
              "int8-ef": {"grad_compression": "int8_ef"}}[variant]
    (ref_losses, rstate), (losses, pstate) = run_both(**run_kw)
    np.testing.assert_allclose(losses, ref_losses, atol=1e-5, rtol=0)
    trees_close(decoder_params_to_numpy(pstate.params), rstate.params,
                1e-4, 1e-3, variant)
    assert int(pstate.opt.step) == int(rstate.opt.step) == 3
    if variant == "int8-ef":
        # the residual keeps what int8 rounding dropped: where the two
        # gradients (equal to ~1e-7) straddle a rounding boundary, it
        # differs by one quantization step; at most 0.1% of a leaf may
        g, w = flat(decoder_params_to_numpy(pstate.ef)), flat(rstate.ef)
        for k in w:
            off = np.abs(g[k] - w[k]) > 1e-4 + 1e-3 * np.abs(w[k])
            assert off.mean() <= 1e-3, (k, int(off.sum()))


def test_train_state_from_numpy_continues_the_reference():
    """The reference's state after two steps, carried across, steps on in
    the port as in the reference."""
    ref_cfg, cfg = configs()
    tree = noisy_params(ref_cfg)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    ref_run, run = RefRunConfig(**kw), RunConfig(**kw)
    ref_tr, ref_step = ref_trainer(ref_cfg, ref_run)
    rstate = ref_state(ref_tr, tree)
    for i in range(2):
        rstate, _ = ref_step(rstate, jax.tree.map(jnp.asarray, batch_np(i)))
    np_state = {"params": jax.tree.map(np.asarray, rstate.params),
                "step": np.asarray(rstate.opt.step),
                "m": jax.tree.map(np.asarray, rstate.opt.m),
                "v": jax.tree.map(np.asarray, rstate.opt.v),
                "master": None, "ef": None}
    pstate = train_state_from_numpy(np_state, cfg, device="cpu")
    assert int(pstate.opt.step) == 2
    assert pstate.opt.m["layers"][0]["attn"]["wq"].dtype == torch.float32
    tr = Trainer(DecoderLM(cfg, run, device="cpu"), run)
    rstate, rm = ref_step(rstate, jax.tree.map(jnp.asarray, batch_np(2)))
    pstate, pm = tr.make_train_step()(pstate, to_torch(batch_np(2)))
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-5
    trees_close(decoder_params_to_numpy(pstate.params), rstate.params,
                1e-4, 1e-3, "continued")


def test_params_round_trip_through_numpy():
    ref_cfg, _ = configs()
    _, cfg = configs(param_dtype="bfloat16")
    tree = jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                        noisy_params(ref_cfg))
    got = decoder_params_to_numpy(decoder_params_from_numpy(tree, cfg,
                                                            device="cpu"))
    trees_close(got, tree, 0, 0, "round trip")


# --------------------------------------------------------------------------
# the port's counterparts of tests/test_trainer_serve.py


def make_setup(steps=60, **run_kw):
    cfg = ModelConfig(**{**FIELDS, "qkv_bias": False, "qk_norm": False})
    run = RunConfig(lr=3e-3, warmup_steps=10, total_steps=steps, **run_kw)
    trainer = Trainer(DecoderLM(cfg, run, device="cpu"), run)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=8, temperature=0.25)
    return cfg, trainer, pipeline.SyntheticDataset(dcfg), dcfg


def test_training_reduces_loss():
    cfg, trainer, ds, dcfg = make_setup()
    pf = pipeline.Prefetcher(ds)
    try:
        _, hist = trainer.fit(trainer.init_state(0), pf, steps=60,
                              log_every=5)
    finally:
        pf.close()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first - 0.5, f"no learning: {first} -> {last}"
    assert last < np.log(dcfg.vocab_size), "below uniform baseline"
    assert last > pipeline.loss_floor(dcfg) - 0.05, "beat the entropy floor"


def test_grad_accumulation_matches_single_batch():
    cfg, _, ds, _ = make_setup()
    batch = to_torch(ds.batch(0))
    out = []
    for k in (1, 4):
        run = RunConfig(lr=1e-2, microbatches=k, warmup_steps=0,
                        total_steps=10)
        tr = Trainer(DecoderLM(cfg, run, device="cpu"), run)
        state, _ = tr.make_train_step()(tr.init_state(0), batch)
        out.append(decoder_params_to_numpy(state.params))
    trees_close(out[1], out[0], 1e-4, 1e-3, "accumulation")


def test_int8_ef_training_converges():
    cfg, trainer, ds, _ = make_setup(grad_compression="int8_ef")
    pf = pipeline.Prefetcher(ds)
    try:
        _, hist = trainer.fit(trainer.init_state(0), pf, steps=60,
                              log_every=5)
    finally:
        pf.close()
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.4


def test_checkpoint_restart_resumes_identically(tmp_path):
    cfg, trainer, ds, _ = make_setup()
    step_fn = trainer.make_train_step()
    state = trainer.init_state(0)
    for i in range(5):
        state, _ = step_fn(state, to_torch(ds.batch(i)))
    ck = Checkpointer(str(tmp_path))
    ck.save(5, state, blocking=False)
    ck.wait()
    cont = state
    for i in range(5, 8):
        cont, m_direct = step_fn(cont, to_torch(ds.batch(i)))
    restored, step = ck.restore(trainer.init_state(0), device="cpu")
    assert step == 5 and int(restored.opt.step) == 5
    for i in range(5, 8):
        restored, m_replay = step_fn(restored, to_torch(ds.batch(i)))
    assert float(m_direct["loss"]) == float(m_replay["loss"])
    for a, b in zip(flat(decoder_params_to_numpy(cont.params)).values(),
                    flat(decoder_params_to_numpy(restored.params)).values()):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_keeps_bf16_bits_and_refuses_a_mesh(tmp_path):
    cfg = get_config("yi-9b", smoke=True).replace(param_dtype="bfloat16",
                                                  activation_dtype="bfloat16")
    run = RunConfig(adam_dtype="bfloat16", master_weights=True)
    tr = Trainer(get_model(cfg, run, device="cpu"), run)
    state = tr.init_state(1)
    state, _ = tr.make_train_step()(state, to_torch(batch_np()))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, state)
    ck.save(2, state)
    assert ck.list_steps() == [2] and ck.latest_step() == 2
    got, step = ck.restore(tr.init_state(2), device="cpu")
    assert step == 2
    want_leaves = {k: v for k, v in _leaves(state).items()}
    for k, v in _leaves(got).items():
        assert v.dtype == want_leaves[k].dtype, k
        assert torch.equal(v, want_leaves[k]), k
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ck.restore(state, shardings={}, device="cpu")


def _leaves(state):
    from repro_torch.train.checkpoint import flatten_with_paths
    return flatten_with_paths(state)


def test_trainer_refuses_moe_and_hybrid_configs():
    for arch in ("mixtral-8x22b", "recurrentgemma-2b"):
        model = get_model(get_config(arch, smoke=True), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Trainer(model, RunConfig())


def test_cli_smoke_writes_a_checkpoint_that_resume_picks_up(tmp_path,
                                                            capsys):
    args = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--seq-len",
            "16", "--global-batch", "4", "--log-every", "2", "--ckpt-dir",
            str(tmp_path)]
    hist = train_main(args + ["--steps", "4"])
    assert [h["step"] for h in hist] == [2, 4]
    assert Checkpointer(str(tmp_path)).latest_step() == 4
    hist = train_main(args + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert [h["step"] for h in hist] == [6]
    assert Checkpointer(str(tmp_path)).latest_step() == 6
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_state_from_numpy_keeps_bf16_moments_and_master():
    ref_cfg, cfg = configs(param_dtype="bfloat16")
    tree = noisy_params(ref_cfg)
    rng = np.random.default_rng(2)
    moments = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        jnp.bfloat16), tree)
    master = jax.tree.map(lambda p: np.asarray(p, np.float32), tree)
    state = train_state_from_numpy(
        {"params": tree, "step": np.int32(7), "m": moments, "v": moments,
         "master": master, "ef": master}, cfg, device="cpu")
    assert int(state.opt.step) == 7
    assert state.params["embed"].dtype == torch.bfloat16
    assert state.opt.v["layers"][1]["ffn"]["w_up"].dtype == torch.bfloat16
    assert state.opt.master["embed"].dtype == torch.float32
    trees_close(decoder_params_to_numpy(state.opt.m), moments, 0, 0, "m")
    trees_close(decoder_params_to_numpy(state.ef), master, 0, 0, "ef")
