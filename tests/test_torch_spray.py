"""The port's plane spraying (``core/planes.py``, ``sim/spray.py``)
against the JAX package's, on the CPU.

Tolerances: the closed forms of ``planes.py`` equal (host arithmetic on
the same floats); ``_per_plane_bytes`` and ``flowlet_split`` bit for bit
(bytes and counts; seeds and flow indices whose hashes set the top bit,
and dead buckets whose flowlets re-hash); ``simulate_sprayed`` with
``per_plane_bytes`` and ``stalled`` exact and ``completion_s``,
``plane_transfer_s`` and ``latency_s`` within 1e-9 relative (the golden
limit), in chunk and flowlet mode, with skewed and dead planes, on
``MPHX(2, 8, (8, 8))`` and dragonfly-small; the ``spray.*`` counters
equal.  The closed-form checks of ``tests/test_sim.py`` hold on the
port, and a sprayed run builds its incidence's segment plans once,
whatever its plane count.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dependency: the repository's shim
    from _hypothesis_shim import given, settings, strategies as st

from repro.core import planes as ref_planes  # noqa: E402
from repro.core.dragonfly import Dragonfly as RefDragonfly  # noqa: E402
from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.sim import spray as ref_spray  # noqa: E402
from repro.sim.events import FlowSpec as RefFlowSpec  # noqa: E402
from repro.telemetry import collecting as ref_collecting  # noqa: E402
from repro_torch.core import planes  # noqa: E402
from repro_torch.core.dragonfly import Dragonfly  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.sim import fairshare, spray  # noqa: E402
from repro_torch.sim.events import FlowSpec  # noqa: E402
from repro_torch.telemetry import collecting  # noqa: E402

MPHX_KW = dict(n=2, p=8, dims=(8, 8))
DRAGONFLY_KW = dict(p=2, a=4, h=2, groups=9, name="Dragonfly (small)")
FABRICS = {"mphx-2p-8x8": (RefMPHX, MPHX, MPHX_KW),
           "dragonfly-small": (RefDragonfly, Dragonfly, DRAGONFLY_KW)}
INF = math.inf
# (granularity, n_planes, plane_skew)
SPRAYS = {
    "chunk": ("chunk", None, None),
    "chunk-skew": ("chunk", 4, [1.0, 1.5, 1.0, 2.0]),
    "chunk-dead": ("chunk", 4, [1.0, 1.5, 1.0, INF]),
    "chunk-3-dead": ("chunk", 8, [INF, 1.0, INF, 1.25, 1.0, INF, 1.0, 1.0]),
    "flowlet": ("flowlet", None, None),
    "flowlet-skew-dead": ("flowlet", 4, [1.0, INF, 1.5, INF]),
}
# seeds whose uint64 products wrap and set the top bit
SEEDS = [0, 7, 2**31 + 11, 2**63 + 5, 2**64 - 1]


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small ops in the event loop: under the test runner's parallel
    workers torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.float64).view(np.int64)


def assert_rel(got, want, tol=1e-9):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin])
    assert (err <= tol * np.abs(want[fin])).all(), float(err.max())


# ------------------------------------------------------- core/planes.py ----


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("chunk", [1, 7, 1 << 10, 1 << 17])
def test_closed_forms_match_the_reference(n, chunk):
    cfg, ref_cfg = (m.SprayConfig(n_planes=n, chunk_bytes=chunk)
                    for m in (planes, ref_planes))
    for total in (0, 1, chunk - 1, chunk, chunk + 1, 5 * chunk + 17,
                  n * chunk * 3, 10 << 20):
        if total > 4096 * chunk:
            continue
        assert planes.split_chunks(total, cfg) == \
            ref_planes.split_chunks(total, ref_cfg)
        assert planes.plane_chunk_fractions(total, cfg) == \
            ref_planes.plane_chunk_fractions(total, ref_cfg)
        for skew in (None, [1.0 + i / 4 for i in range(n)],
                     [INF] + [1.0] * (n - 1), [1.5] * (n - 1) + [INF]):
            if skew is not None and all(map(math.isinf, skew)):
                continue
            for f in ("spray_completion_time", "effective_bandwidth_gbps"):
                assert getattr(planes, f)(total, 800.0, cfg, skew) == \
                    getattr(ref_planes, f)(total, 800.0, ref_cfg, skew)
        assert planes.spray_efficiency(total, 800.0, cfg) == \
            ref_planes.spray_efficiency(total, 800.0, ref_cfg)
    assert planes.plane_failure_degradation(cfg) == \
        ref_planes.plane_failure_degradation(ref_cfg)


def test_spray_config_checks_match_the_reference():
    for kw in (dict(n_planes=0), dict(n_planes=9), dict(chunk_bytes=0)):
        with pytest.raises(ValueError) as want:
            ref_planes.SprayConfig(**kw)
        with pytest.raises(ValueError, match=str(want.value)):
            planes.SprayConfig(**kw)
    cfg = planes.SprayConfig(n_planes=2)
    with pytest.raises(ValueError, match="plane_skew length mismatch"):
        planes.spray_completion_time(1 << 20, 800.0, cfg, [1.0])
    with pytest.raises(RuntimeError, match="all planes down"):
        planes.spray_completion_time(1 << 20, 800.0, cfg, [INF, INF])


# ------------------------------------------ _per_plane_bytes, flowlets ----


def sizes_case(seed: int, F: int, scale: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sizes = rng.uniform(0.0, 1.0, F) * scale
    sizes[rng.random(F) < 0.2] = 0.0
    whole = rng.random(F) < 0.3
    sizes[whole] = np.floor(sizes[whole])
    return sizes


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("chunk", [1, 7, 1000, 1 << 17])
def test_per_plane_bytes_bit_for_bit(n, chunk):
    sizes = np.concatenate([
        [0.0, 1.0, chunk, chunk + 1, 5 * chunk + 17, 16 << 20],
        sizes_case(n * 31 + chunk, 300, min(chunk * 5000.0, 1e9))])
    got = spray._per_plane_bytes(torch.from_numpy(sizes),
                                 planes.SprayConfig(n, chunk))
    want = ref_spray._per_plane_bytes(sizes, ref_planes.SprayConfig(n, chunk))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(bits(got), bits(want))


@given(total=st.integers(0, 1 << 24), n=st.integers(1, 8),
       chunk=st.sampled_from([1, 7, 1 << 10, 1 << 17, 1 << 20]))
@settings(max_examples=20, deadline=None)
def test_per_plane_bytes_is_split_chunks(total, n, chunk):
    total = total % (chunk * 512 + 1)
    cfg = planes.SprayConfig(n_planes=n, chunk_bytes=chunk)
    got = spray._per_plane_bytes(torch.tensor([float(total)],
                                              dtype=torch.float64), cfg)
    assert got[0].tolist() == planes.split_chunks(total, cfg)


def test_mix64_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2**63, 5000, dtype=np.uint64) * 2
                        + rng.integers(0, 2, 5000, dtype=np.uint64),
                        np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1],
                                 dtype=np.uint64)])
    want = ref_spray._mix64(x)
    got = spray._mix64(torch.from_numpy(x.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert (got < 0).any() and (got >= 0).any()   # both halves of uint64
    for n in range(1, 9):
        np.testing.assert_array_equal(spray._umod(got, n).numpy(),
                                      (want % np.uint64(n)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,alive", [
    (1, None), (2, None), (4, None), (4, [True, False, True, True]),
    (8, [False, True, True, False, True, False, True, True]),
    (3, [False, False, True])])
@pytest.mark.parametrize("flowlet_bytes", [4096, 65536.0, 1000.5])
def test_flowlet_split_bit_for_bit(seed, n, alive, flowlet_bytes):
    sizes = sizes_case(seed % 1000 + n, 200, 2e6)
    want_b, want_c = ref_spray.flowlet_split(
        sizes, n, flowlet_bytes, seed=seed,
        alive=None if alive is None else np.array(alive))
    with collecting() as mx:
        got_b, got_c = spray.flowlet_split(
            torch.from_numpy(sizes), n, flowlet_bytes, seed=seed,
            alive=alive, backend="torch")
    assert got_c.dtype == torch.int64 and got_b.dtype == torch.float64
    np.testing.assert_array_equal(bits(got_b), bits(want_b))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    rehashed = mx.snapshot()["counters"].get("spray.flowlet_rehashes", 0)
    assert (rehashed > 0) == (alive is not None)
    # the kernels' backend takes the same CPU path
    b2, c2 = spray.flowlet_split(torch.from_numpy(sizes), n, flowlet_bytes,
                                 seed=seed, alive=alive, backend="cuda")
    assert torch.equal(b2, got_b) and torch.equal(c2, got_c)


def test_flowlet_hashes_set_the_top_bit():
    """The flowlet hash of these cases covers both halves of uint64, so
    the unsigned modulus and the logical shifts are exercised."""
    n_fl = 64
    flow = torch.arange(10).repeat_interleave(n_fl)
    idx = torch.arange(n_fl).repeat(10)
    for seed in SEEDS:
        h = spray._mix64(spray._mix64(flow ^ spray._s64(seed * 0x9E3779B1))
                         ^ idx)
        assert (h < 0).any() and (h >= 0).any()


def test_flowlet_split_rejects_bad_args_like_the_reference():
    sizes = np.ones(2)
    cases = [((sizes, 2, 0), {}), ((sizes, 0, 4096), {}),
             ((sizes, 2, 4096), dict(alive=np.ones(3, dtype=bool))),
             ((sizes, 2, 4096), dict(alive=np.zeros(2, dtype=bool)))]
    for args, kw in cases:
        with pytest.raises((ValueError, RuntimeError)) as want:
            ref_spray.flowlet_split(*args, **kw)
        with pytest.raises(want.type, match=str(want.value)):
            spray.flowlet_split(torch.from_numpy(args[0]), *args[1:],
                                backend="torch", **kw)
    by, cnt = spray.flowlet_split(torch.zeros(2, dtype=torch.float64), 4,
                                  4096, backend="torch")
    assert by.shape == cnt.shape == (2, 4)
    assert not by.any() and not cnt.any()


# --------------------------------------------------- simulate_sprayed ----


def workload(seed: int, n_switches: int, F: int = 40):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_switches, F)
    dst = (src + rng.integers(1, n_switches, F)) % n_switches
    size = rng.uniform(0.2, 1.0, F) * (1 << 22)
    size[:3] = [0.0, 1.0, 1 << 17]
    start = rng.uniform(0.0, 50e-6, F)
    rows = list(zip(src.tolist(), dst.tolist(), size.tolist(),
                    start.tolist()))
    return ([RefFlowSpec(*r) for r in rows], [FlowSpec(*r) for r in rows])


def sprayed_pair(fabric, spray_name, backend, seed=1, **kw):
    ref_cls, cls, topo_kw = FABRICS[fabric]
    ref_topo, topo = ref_cls(**topo_kw), cls(**topo_kw)
    granularity, n, skew = SPRAYS[spray_name]
    n = n or topo.n_planes
    ref_flows, flows = workload(seed, topo.build_graph().n_switches)
    common = dict(plane_skew=skew, granularity=granularity,
                  flowlet_bytes=65536, flowlet_seed=3, **kw)
    with ref_collecting() as ref_mx:
        want = ref_spray.simulate_sprayed(
            ref_topo, ref_flows, cfg=ref_planes.SprayConfig(n_planes=n),
            backend="numpy", **common)
    with collecting() as mx:
        got = spray.simulate_sprayed(
            topo, flows, cfg=planes.SprayConfig(n_planes=n), backend=backend,
            device="cpu", **common)
    return got, want, mx.snapshot()["counters"], \
        ref_mx.snapshot()["counters"]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("spray_name", sorted(SPRAYS))
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_simulate_sprayed_matches_the_reference(fabric, spray_name, backend):
    got, want, counters, ref_counters = sprayed_pair(fabric, spray_name,
                                                     backend)
    np.testing.assert_array_equal(bits(got.per_plane_bytes),
                                  bits(want.per_plane_bytes))
    np.testing.assert_array_equal(got.stalled.numpy(), want.stalled)
    assert_rel(got.completion_s, want.completion_s)
    assert_rel(got.plane_transfer_s, want.plane_transfer_s)
    assert_rel(got.latency_s, want.latency_s)
    assert abs(got.makespan_s - want.makespan_s) <= 1e-9 * want.makespan_s
    spray_keys = {k for k in ref_counters if k.startswith("spray.")}
    assert spray_keys and {k: counters[k] for k in spray_keys} == \
        {k: ref_counters[k] for k in spray_keys}
    assert counters["sim.runs"] == ref_counters["sim.runs"]
    assert counters["sim.epochs"] == ref_counters["sim.epochs"]
    assert got.completion_s.dtype == torch.float64


def test_simulate_sprayed_rate_cap_and_valiant_match_the_reference():
    for kw in (dict(rate_cap_gbps=100.0), dict(mode="valiant")):
        got, want, _, _ = sprayed_pair("mphx-2p-8x8", "chunk-dead", "torch",
                                       seed=5, **kw)
        np.testing.assert_array_equal(bits(got.per_plane_bytes),
                                      bits(want.per_plane_bytes))
        assert_rel(got.completion_s, want.completion_s)


def test_spray_sim_matches_planes_closed_form():
    topo = MPHX(**MPHX_KW)
    cfg = planes.SprayConfig(n_planes=2)
    size = 10 << 20
    for skew in (None, [1.0, 1.5]):
        res = spray.simulate_sprayed(topo, [FlowSpec(0, 5, size)], cfg=cfg,
                                     plane_skew=skew, device="cpu")
        expect = planes.spray_completion_time(size, topo.nic_bw_gbps, cfg,
                                              skew)
        assert float(res.completion_s[0] - res.latency_s[0]) == \
            pytest.approx(expect, rel=1e-12)


def test_spray_sim_dead_plane_resprays():
    """One dead plane: bytes re-spray over survivors (chunk overhead off
    so the re-spray accounting matches planes.py exactly)."""
    topo = MPHX(**MPHX_KW)
    cfg = planes.SprayConfig(n_planes=2, per_chunk_overhead_s=0.0)
    size = 10 << 20
    skew = [1.0, INF]
    res = spray.simulate_sprayed(topo, [FlowSpec(0, 5, size)], cfg=cfg,
                                 plane_skew=skew, device="cpu")
    expect = planes.spray_completion_time(size, topo.nic_bw_gbps, cfg, skew)
    assert float(res.completion_s[0] - res.latency_s[0]) == \
        pytest.approx(expect, rel=1e-12)
    assert float(res.per_plane_bytes[0, 1]) == 0.0
    assert float(res.per_plane_bytes[0, 0]) == size


@pytest.mark.parametrize("dead", [0, 3])
@pytest.mark.parametrize("granularity", ["chunk", "flowlet"])
def test_dead_plane_respray_conserves_bytes(dead, granularity):
    topo = MPHX(n=4, p=2, dims=(4,))
    cfg = planes.SprayConfig(n_planes=4, chunk_bytes=1 << 10,
                             per_chunk_overhead_s=0.0)
    skew = [1.0] * 4
    skew[dead] = INF
    total = 3_000_017
    res = spray.simulate_sprayed(
        topo, [FlowSpec(0, 1, total), FlowSpec(2, 3, total // 2)], cfg=cfg,
        plane_skew=skew, granularity=granularity, flowlet_bytes=4096,
        device="cpu")
    assert res.per_plane_bytes.sum(1).tolist() == pytest.approx(
        [total, total // 2])
    assert res.per_plane_bytes[:, dead].tolist() == [0.0, 0.0]
    assert res.plane_transfer_s[:, dead].tolist() == [0.0, 0.0]
    assert not bool(res.stalled.any())


def test_simulate_sprayed_rejects_bad_args_like_the_reference():
    topo, ref_topo = MPHX(**MPHX_KW), RefMPHX(**MPHX_KW)
    cases = [dict(plane_skew=[1.0]), dict(granularity="bogus"),
             dict(plane_skew=[INF, INF])]
    for kw in cases:
        with pytest.raises((ValueError, RuntimeError)) as want:
            ref_spray.simulate_sprayed(ref_topo, [RefFlowSpec(0, 5, 1e6)],
                                       **kw)
        with pytest.raises(want.type, match=str(want.value)):
            spray.simulate_sprayed(topo, [FlowSpec(0, 5, 1e6)],
                                   device="cpu", **kw)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_incidence_plans_are_built_once_a_sprayed_run(monkeypatch, backend):
    """The planes' loops share one incidence and its segment plans: a
    run sorts its columns as often with 8 planes as with 1 (the edge
    plan, and the flow plan for the kernels' backend)."""
    calls = []
    make_plan = fairshare.make_plan

    def spy(ids, n, **kw):
        calls.append(n)
        return make_plan(ids, n, **kw)

    monkeypatch.setattr(fairshare, "make_plan", spy)
    topo = MPHX(**MPHX_KW)
    _, flows = workload(2, topo.switches_per_plane)
    per_run = []
    for n in (1, 2, 8):
        calls.clear()
        spray.simulate_sprayed(topo, flows, cfg=planes.SprayConfig(n),
                               backend=backend, device="cpu")
        per_run.append(len(calls))
    assert per_run == [2 if backend == "cuda" else 1] * 3
