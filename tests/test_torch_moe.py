"""The port's MoE layer against the JAX package's.

The reference's MoE parameters (``repro.models.moe.moe_init``) are
carried across as numpy arrays, the tokens are numpy from a seed, and the
port's ``_route``, ``_dispatch``, ``moe_ffn_ref`` and ``moe_ffn_dispatch``
are held to the reference's: the chosen experts exactly (so that a flip
reads as a flip, not as a large value error), y at 2e-5 and the aux loss
at 1e-6 in float32, y at 5e-2 in bfloat16 (``tests/test_kernels.py``'s
tolerances).  Covered: the mixtral and kimi smoke configs (kimi has a
shared expert), and explicit small capacities that drop records, whose
keep mask and buffer positions must be the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as RM  # noqa: E402
from repro.models.registry import get_config as ref_get_config  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402

ARCHS = ["kimi-k2-1t-a32b", "mixtral-8x22b"]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def both(arch, dtype="float32", seed=0):
    """(ref cfg, ref params, port cfg, port params) in ``dtype``, the
    router float32 in both."""
    ref_cfg = ref_get_config(arch, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(arch, smoke=True).replace(param_dtype=dtype)
    ref_p = RM.moe_init(jax.random.PRNGKey(seed), ref_cfg,
                        jnp.dtype(dtype))

    def carry(t):
        if isinstance(t, dict):
            return {k: carry(v) for k, v in t.items()}
        a = np.asarray(t)
        return torch.as_tensor(a.astype(np.float32)).to(
            torch.float32 if a.dtype == np.float32 else DTYPES[dtype][0])

    return ref_cfg, ref_p, cfg, carry(ref_p)


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def as_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    ref_cfg, ref_p, cfg, p = both(arch)
    x = tokens(cfg, 3, 16, 1).reshape(-1, cfg.d_model)
    w_ref, i_ref, aux_ref = RM._route(ref_p["router"], jnp.asarray(x),
                                      ref_cfg)
    w, i, aux = M._route(p["router"], torch.as_tensor(x), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
    assert abs(float(aux) - float(aux_ref)) <= 1e-6
    assert w.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path", ["moe_ffn_ref", "moe_ffn_dispatch"])
def test_moe_ffn_matches_reference_float32(arch, path):
    ref_cfg, ref_p, cfg, p = both(arch)
    x = tokens(cfg, 2, 12, 2)
    want, aux_ref = getattr(RM, path)(ref_p, jnp.asarray(x), ref_cfg)
    _, top_i, _ = M._route(p["router"], torch.as_tensor(x).reshape(
        -1, cfg.d_model), cfg)
    _, ref_i, _ = RM._route(ref_p["router"],
                            jnp.asarray(x).reshape(-1, cfg.d_model), ref_cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ref_i))
    gm.reset_launch_counts()
    got, aux = getattr(M, path)(p, torch.as_tensor(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert abs(float(aux) - float(aux_ref)) <= 1e-6
    assert gm.LAUNCHES["grouped_matmul"] == 0     # the CPU path


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_dispatch_matches_reference_bfloat16(arch):
    ref_cfg, ref_p, cfg, p = both(arch, "bfloat16")
    x = tokens(cfg, 2, 12, 3)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.as_tensor(x).bfloat16()
    want, _ = RM.moe_ffn_dispatch(ref_p, xj, ref_cfg)
    _, ref_i, _ = RM._route(ref_p["router"], xj.reshape(-1, cfg.d_model),
                            ref_cfg)
    _, top_i, _ = M._route(p["router"], xt.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ref_i))
    for backend in ("cuda", "torch"):
        got, _ = M.moe_ffn_dispatch(p, xt, cfg, backend=backend)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(as_np(got), as_np(want), atol=5e-2,
                                   rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", [1, 3])
def test_dropped_records_match_reference(arch, capacity):
    """A capacity below the routed load drops records: the keep mask,
    positions, buffers and y must be the reference's."""
    ref_cfg, ref_p, cfg, p = both(arch)
    x = tokens(cfg, 2, 8, 4)
    xf = x.reshape(-1, cfg.d_model)
    E = cfg.moe.n_experts
    top_w, top_i, _ = RM._route(ref_p["router"], jnp.asarray(xf), ref_cfg)
    buf_r, eid_r, pos_r, keep_r, _ = RM._dispatch(
        jnp.asarray(xf), top_w, top_i, E, capacity)
    buf, eid, pos, keep, _ = M._dispatch(
        torch.as_tensor(xf), torch.as_tensor(np.array(top_w)),
        torch.as_tensor(np.array(top_i)).long(), E, capacity)
    assert not bool(keep.all())                  # records were dropped
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_r))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_r))
    np.testing.assert_array_equal(eid.numpy(), np.asarray(eid_r))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(buf_r))
    want, _ = RM.moe_ffn_dispatch(ref_p, jnp.asarray(x), ref_cfg,
                                  capacity=capacity)
    got, _ = M.moe_ffn_dispatch(p, torch.as_tensor(x), cfg,
                                capacity=capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_capacity_of_the_serve_path():
    """mixtral's prefill wave (4 x 1,024 tokens), decode step (4 tokens)
    and window wave (4,160 tokens)."""
    cfg = get_config("mixtral-8x22b")
    ref_cfg = ref_get_config("mixtral-8x22b")
    for T, C in ((4096, 1280), (4, 2), (4160, 1300), (1, 1)):
        assert M._capacity(T, cfg) == RM._capacity(T, ref_cfg) == C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_shapes_and_router_dtype(dtype):
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True).replace(param_dtype=dtype)
        ref_cfg = ref_get_config(arch, smoke=True).replace(param_dtype=dtype)
        dt = DTYPES[dtype][0]
        gen = torch.Generator().manual_seed(0)
        p = M.moe_init(gen, cfg, dt, "cpu")
        ref = jax.eval_shape(lambda: RM.moe_init(jax.random.PRNGKey(0),
                                                 ref_cfg, jnp.dtype(dtype)))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), p)
        want = jax.tree.map(
            lambda t: (tuple(t.shape),
                       str(DTYPES[str(t.dtype)][0])), ref)
        assert got == want, arch
        assert p["router"].dtype == torch.float32
        d, f = cfg.d_model, cfg.moe.d_expert
        assert float(p["experts"]["w_down"].float().abs().max()) \
            <= 2.0 / np.sqrt(f) + 1e-3
        assert float(p["experts"]["w_gate"].float().abs().max()) \
            <= 2.0 / np.sqrt(d) + 1e-3
