"""The port's dense ``DecoderLM`` against the JAX package's.

The reference model is initialised with ``jax.random`` and its parameter
tree carried across with ``repro_torch.convert.decoder_params_from_numpy``;
both get the same tokens (numpy, from a seed).  ``forward``, ``prefill``
and a few ``decode_step`` logits must agree at 2e-3 absolute, the
tolerance ``tests/test_models_smoke.py`` gives prefill/decode against
forward (fp32 smoke configs), and the MoE load-balance loss at 1e-6.
Covered: the four dense smoke configs (qwen3 has qk-norm, qwen1.5 QKV
bias), yi-9b's with an 8-token sliding window, decoded past the window so
the ring cache wraps, and the two MoE smoke configs (mixtral: top-2 of 4
experts with an 8-token window; kimi: a leading dense layer and a shared
expert).  The hybrid family's ``RGLRUModel`` is held in
``tests/test_torch_rglru.py``; its configs and parameter count are held
here with the others.  The port runs
with ``kernel_backend="cuda"``: on CPU tensors the kernel wrappers take
their plain versions.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import get_config as ref_get_config  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro.models.transformer import DecoderLM as RefDecoderLM  # noqa: E402
from repro_torch.convert import decoder_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    ARCH_IDS, DECODER_FAMILIES, PORTED_ARCH_IDS, get_config, get_model)
from repro_torch.models.transformer import DecoderLM  # noqa: E402

ATOL = 2e-3
# the decoder architectures (the hybrid's model is tests/test_torch_rglru.py's)
DECODER_ARCH_IDS = [arch for arch in PORTED_ARCH_IDS
                    if get_config(arch).family in DECODER_FAMILIES]
CASES = {arch: {} for arch in DECODER_ARCH_IDS}
CASES["yi-9b-window8"] = {"sliding_window": 8}


def build(case):
    arch = case.replace("-window8", "")
    ref_cfg = ref_get_config(arch, smoke=True).replace(**CASES[case])
    cfg = get_config(arch, smoke=True).replace(**CASES[case])
    ref = RefDecoderLM(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    model = DecoderLM(cfg, device="cpu")
    return ref, ref_params, model, decoder_params_from_numpy(tree, cfg,
                                                             device="cpu")


def close(got, want, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= ATOL, f"{what}: max |diff| {err}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_prefill_decode_match_reference(case):
    ref, ref_params, model, params = build(case)
    cfg = model.cfg
    rng = np.random.default_rng(sorted(CASES).index(case))
    B, S, steps = 2, 12, 6
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    max_len = S + steps + 1

    want, want_aux = ref.forward(ref_params, jnp.asarray(tokens))
    got, aux = model.forward(params, torch.as_tensor(tokens))
    close(got, want, f"{case} forward")
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    if cfg.moe is None:
        assert float(aux) == 0.0

    want_last, ref_caches = ref.prefill(ref_params, jnp.asarray(tokens),
                                        max_len=max_len)
    got_last, caches = model.prefill(params, torch.as_tensor(tokens),
                                     max_len=max_len)
    close(got_last, want_last, f"{case} prefill")
    assert caches["pos"] == S
    assert caches["layers"]["k"].shape[2] == model.cache_capacity(max_len)

    feed = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    for i in range(steps):
        want_step, ref_caches = ref.decode_step(
            ref_params, jnp.asarray(feed[i]), ref_caches)
        got_step, caches = model.decode_step(params, torch.as_tensor(feed[i]),
                                             caches)
        close(got_step, want_step, f"{case} decode step {i}")
    if cfg.sliding_window is not None:
        # the ring wrapped: every slot holds one of the last `window`
        # positions
        kv_pos = caches["layers"]["kv_pos"].tolist()
        assert sorted(kv_pos) == list(range(S + steps - 8, S + steps))
        np.testing.assert_array_equal(np.asarray(ref_caches["layers"]
                                                 ["kv_pos"][0]), kv_pos)


def test_param_count_matches_reference():
    for arch in PORTED_ARCH_IDS:
        for smoke in (False, True):
            want = ref_get_model(ref_get_config(arch, smoke=smoke)) \
                .param_count()
            assert get_config(arch, smoke=smoke).param_count() == want
    # yi-9b at full size: 48 x 173,023,232 + 2 x 64000 x 4096 + 4096
    assert get_config("yi-9b").param_count() == 8_829_407_232
    # mixtral-8x22b: 56 x 2,504,060,928 + 2 x 32768 x 6144 + 6144
    assert get_config("mixtral-8x22b").param_count() == 140_630_071_296


def test_active_param_count_matches_reference():
    for arch in ("mixtral-8x22b", "kimi-k2-1t-a32b", "yi-9b"):
        for smoke in (False, True):
            want = RefDecoderLM(ref_get_config(arch, smoke=smoke)) \
                .active_param_count()
            model = get_model(get_config(arch, smoke=smoke), device="cpu")
            assert model.active_param_count() == want, (arch, smoke)


def test_configs_are_the_reference_configs():
    for arch in PORTED_ARCH_IDS:
        for smoke in (False, True):
            ref = ref_get_config(arch, smoke=smoke)
            got = get_config(arch, smoke=smoke)
            # nested configs (MoEConfig) are classes of each package:
            # compare their fields
            assert dataclasses.asdict(got) == dataclasses.asdict(ref), arch


def test_unported_archs_and_families_raise():
    assert len(ARCH_IDS) == 10
    for arch in set(ARCH_IDS) - set(PORTED_ARCH_IDS):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    cfg = get_config("yi-9b", smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(cfg.replace(family="vlm", vlm=object()), device="cpu")
    hybrid = get_config("recurrentgemma-2b", smoke=True)
    with pytest.raises(NotImplementedError, match="DecoderLM serves"):
        DecoderLM(hybrid, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder parameters"):
        decoder_params_from_numpy({}, hybrid, device="cpu")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_init_draws_the_reference_distributions():
    """Same std rules as the reference's init helpers: embed std 1,
    dense 1/sqrt(fan_in), truncated at 2 std; norms 1, biases 0."""
    cfg = get_config("qwen1.5-32b", smoke=True).replace(vocab_size=4096)
    params = DecoderLM(cfg, device="cpu").init(seed=3)
    emb = params["embed"]
    assert float(emb.abs().max()) <= 2.0
    assert abs(float(emb.std()) - 0.8796) < 0.02   # std of N(0,1) cut at 2
    wo = params["layers"][0]["attn"]["wo"]
    fan_in = wo.shape[0]
    assert float(wo.abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-7
    attn = params["layers"][1]["attn"]
    assert float(attn["bq"].abs().max()) == 0.0
    assert torch.equal(params["final_norm"]["scale"],
                       torch.ones(cfg.d_model))
    again = DecoderLM(cfg, device="cpu").init(seed=3)
    assert torch.equal(again["layers"][1]["ffn"]["w_up"],
                       params["layers"][1]["ffn"]["w_up"])


def test_rope_is_the_reference_rope():
    from repro.models import layers as RL

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 2, 3, 16)).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.broadcast_to(pos, (2, 7)),
                         10_000.0)
    got = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


def test_convert_carries_bf16_parameters_exactly():
    cfg = get_config("yi-9b", smoke=True).replace(param_dtype="bfloat16")
    ref = RefDecoderLM(ref_get_config("yi-9b", smoke=True)
                       .replace(param_dtype="bfloat16"))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params = decoder_params_from_numpy(tree, cfg, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            got = layer["attn"][name]
            want = tree["layers"]["attn"][name][i].astype(np.float32)
            assert got.dtype == torch.bfloat16 and got.is_contiguous()
            np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    with pytest.raises(ValueError, match="layers"):
        decoder_params_from_numpy(tree, cfg.replace(n_layers=3),
                                  device="cpu")


def test_convert_carries_moe_layer_groups_and_a_float32_router():
    """kimi's smoke tree in bf16: a dense_layers group of one layer, the
    experts' (L, E, ...) leaves unstacked per layer, the router kept in
    float32 as the reference keeps it."""
    arch = "kimi-k2-1t-a32b"
    cfg = get_config(arch, smoke=True).replace(param_dtype="bfloat16")
    ref = RefDecoderLM(ref_get_config(arch, smoke=True)
                       .replace(param_dtype="bfloat16"))
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    params = decoder_params_from_numpy(tree, cfg, device="cpu")
    assert len(params["dense_layers"]) == 1 and len(params["layers"]) == 2
    for i, layer in enumerate(params["layers"]):
        router = layer["moe"]["router"]
        assert router.dtype == torch.float32
        np.testing.assert_array_equal(router.numpy(),
                                      tree["layers"]["moe"]["router"][i])
        for name, got in layer["moe"]["experts"].items():
            want = tree["layers"]["moe"]["experts"][name][i]
            assert got.dtype == torch.bfloat16 and got.is_contiguous()
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
        assert layer["moe"]["shared"]["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["dense_layers"][0]["ffn"]["w_down"].float().numpy(),
        tree["dense_layers"]["ffn"]["w_down"][0].astype(np.float32))
    model = get_model(cfg, device="cpu")
    caches = model.init_cache(2, 16)
    assert caches["dense_layers"]["k"].shape[0] == 1
    assert caches["layers"]["k"].shape[0] == 2
