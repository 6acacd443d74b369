"""The port's ``ServeEngine`` and serve CLI against the JAX package's.

Mirrors ``tests/test_trainer_serve.py``'s serving tests: the reference's
tiny dense config, the MoE smoke configs and the hybrid
(recurrentgemma-2b) smoke config, their parameters carried
across with ``repro_torch.convert``, the same prompts (numpy, from a
seed).  Greedy outputs must equal the JAX engine's token for token (fp32,
where the two models' logits agree to ~1e-6), EOS must stop a request
early, and the CLI must run on the CPU when asked to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.models.registry import get_config as ref_get_config  # noqa: E402
from repro.models.transformer import DecoderLM as RefDecoderLM  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro.serve.engine import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro.models.registry import get_model as ref_get_model  # noqa: E402
from repro_torch.convert import (decoder_params_from_numpy,  # noqa: E402
                                 hybrid_params_from_numpy)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TINY = dict(arch_id="tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
            param_dtype="float32", activation_dtype="float32")


def both_models():
    ref = RefDecoderLM(RefModelConfig(**TINY))
    ref_params = ref.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    params = decoder_params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                       cfg, device="cpu")
    return ref, ref_params, DecoderLM(cfg, device="cpu"), params


def test_greedy_outputs_equal_the_reference_engine():
    ref, ref_params, model, params = both_models()
    prompts = np.random.default_rng(1).integers(0, 64, (3, 8)).astype(
        np.int32)
    ref_eng = RefServeEngine(ref, ref_params, max_batch=2, max_len=32)
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=5) for p in prompts]
    ref_eng.run(ref_reqs)
    eng = ServeEngine(model, params, max_batch=2, max_len=32)
    reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(r.done and len(r.output) == 5 for r in reqs)
    assert eng.stats.tokens_out == 15 and eng.stats.waves == 2
    # manual greedy for request 0, as the reference test does
    last, caches = model.prefill(params, torch.as_tensor(prompts[:1]),
                                 max_len=32)
    outs = []
    for _ in range(5):
        nxt = torch.argmax(last, -1)[:, None]
        outs.append(int(nxt[0, 0]))
        last, caches = model.decode_step(params, nxt, caches)
    assert outs == reqs[0].output


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "mixtral-8x22b"])
def test_moe_greedy_outputs_equal_the_reference_engine(arch):
    """Two waves of an MoE smoke model; mixtral's 8-token window wraps
    its ring cache during decode."""
    ref = RefDecoderLM(ref_get_config(arch, smoke=True))
    ref_params = ref.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    params = decoder_params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                       cfg, device="cpu")
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 10)).astype(np.int32)
    ref_eng = RefServeEngine(ref, ref_params, max_batch=2, max_len=24)
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=6) for p in prompts]
    ref_eng.run(ref_reqs)
    eng = ServeEngine(DecoderLM(cfg, device="cpu"), params, max_batch=2,
                      max_len=24)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert eng.stats.tokens_out == 18 and eng.stats.waves == 2


def test_hybrid_greedy_outputs_equal_the_reference_engine():
    """Two waves of the recurrentgemma-2b smoke model (1 unit of
    (rec, rec, attn) and 2 tail rec blocks); 10 prompt tokens and 6 new
    ones pass its 8-token local window, so the ring cache wraps."""
    arch = "recurrentgemma-2b"
    ref = ref_get_model(ref_get_config(arch, smoke=True))
    ref_params = ref.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    params = hybrid_params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      cfg, device="cpu")
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 10)).astype(np.int32)
    ref_eng = RefServeEngine(ref, ref_params, max_batch=2, max_len=24)
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=6) for p in prompts]
    ref_eng.run(ref_reqs)
    model = get_model(cfg, device="cpu")
    eng = ServeEngine(model, params, max_batch=2, max_len=24)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert eng.stats.tokens_out == 18 and eng.stats.waves == 2
    assert model.cache_capacity(24) == cfg.local_window == 8


def test_eos_stops_early():
    _, _, model, params = both_models()
    prompt = np.zeros((4,), np.int32)
    last, _ = model.prefill(params, torch.as_tensor(prompt)[None],
                            max_len=16)
    eos = int(torch.argmax(last, -1)[0])
    eng = ServeEngine(model, params, max_batch=1, max_len=16)
    r = Request(prompt=prompt, max_new_tokens=8, eos_id=eos)
    eng.run([r])
    assert r.output == [] and r.done
    # a budget of 3 stops after 3 tokens; an EOS that never comes does not
    r = Request(prompt=prompt, max_new_tokens=3, eos_id=64)
    eng.run([r])
    assert len(r.output) == 3 and r.output[0] == eos


def test_temperature_sampling_is_seeded():
    _, _, model, params = both_models()
    prompts = np.random.default_rng(2).integers(0, 64, (2, 6)).astype(
        np.int32)
    outs = []
    for _ in range(2):
        eng = ServeEngine(model, params, max_batch=2, max_len=16,
                          temperature=1.0, seed=7)
        reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < 64 for o in outs[0] for t in o)


def test_unequal_prompts_in_a_wave_raise():
    _, _, model, params = both_models()
    eng = ServeEngine(model, params, max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="equal prompt lengths"):
        eng.run([Request(prompt=np.zeros(3, np.int32)),
                 Request(prompt=np.zeros(4, np.int32))])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_cli_runs_on_the_cpu(backend, capsys):
    stats = serve_main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--prompt-len", "8",
                        "--max-new", "4", "--max-batch", "2",
                        "--kernel-backend", backend])
    assert stats.tokens_out == 12 and stats.waves == 2
    out = capsys.readouterr().out
    assert "params=135,488" in out and f"kernels={backend}" in out


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_moe_cli_runs_on_the_cpu(backend, capsys):
    stats = serve_main(["--arch", "mixtral-8x22b", "--smoke", "--device",
                        "cpu", "--requests", "3", "--prompt-len", "12",
                        "--max-new", "4", "--max-batch", "2",
                        "--kernel-backend", backend])
    assert stats.tokens_out == 12 and stats.waves == 2
    out = capsys.readouterr().out
    assert "params=287,552" in out and f"kernels={backend}" in out


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_hybrid_cli_runs_on_the_cpu(backend, capsys):
    stats = serve_main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                        "cpu", "--requests", "3", "--prompt-len", "12",
                        "--max-new", "4", "--max-batch", "2",
                        "--kernel-backend", backend])
    assert stats.tokens_out == 12 and stats.waves == 2
    out = capsys.readouterr().out
    assert "params=250,560" in out and f"kernels={backend}" in out
