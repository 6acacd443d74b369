"""The port's graph routing engine and Table-2 baselines against the JAX
package's, on the CPU.

* The switch graphs of the eight baseline presets and two MPHX presets:
  edge arrays, NIC counts and CSR arrays exactly, and the topologies'
  Table-2 quantities.
* All-pairs hop distances exactly.
* ``route`` in minimal, valiant and adaptive routing at the four small
  baselines, every applicable scenario, within 1e-9 relative of the
  reference's numpy backend, and adaptive bit for bit (UGAL compares
  costs with ``<=``); the same over several destination chunks.
* Graph-vs-array minimal loads on untrunked MPHX within 1e-9.
* The incidence's ``(flow, edge, frac)`` entries exactly, the pair-level
  cache equal to the walk, with the reference's walk, hit and miss counts.
* ``load_sweep`` rows (with measured FCTs) at dragonfly-small and
  ft3-small, and the golden's ``graph/dragonfly-small/uniform`` cell.
* ``resolve_engine`` / ``make_router`` as the reference's.
"""

import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core import routing_graph as ref_rg  # noqa: E402
from repro.core.dragonfly import Dragonfly as RefDragonfly  # noqa: E402
from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.core.netsim import load_sweep as ref_load_sweep  # noqa: E402
from repro.core.netsim import make_router as ref_make_router  # noqa: E402
from repro.core.netsim import resolve_engine as ref_resolve  # noqa: E402
from repro.core.routing_vec import DemandArrays as RefDemands  # noqa: E402
from repro.experiments import sweep as ref_sweep  # noqa: E402
from repro.experiments.scenarios import SCENARIOS as REF_SCENARIOS  # noqa
from repro.sim.fairshare import flow_incidence as ref_flow_incidence  # noqa
from repro.telemetry import collecting as ref_collecting  # noqa: E402
from repro_torch.convert import demands_from_arrays  # noqa: E402
from repro_torch.core import routing_graph as rg  # noqa: E402
from repro_torch.core.dragonfly import Dragonfly  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import (load_sweep, make_router,  # noqa: E402
                                     resolve_engine)
from repro_torch.core.routing_graph import (CSRGraph, GraphRouter,  # noqa
                                            np_sum)
from repro_torch.core.routing_vec import VectorizedHyperXRouter  # noqa
from repro_torch.core.routing_vec import (neighbor_shift_demands,  # noqa
                                          uniform_demands)
from repro_torch.core.topology import SwitchGraph  # noqa: E402
from repro_torch.experiments import sweep  # noqa: E402
from repro_torch.experiments.scenarios import SCENARIOS  # noqa: E402
from repro_torch.sim.events import simulate_demands  # noqa: E402
from repro_torch.sim.fairshare import flow_incidence, max_min_rates  # noqa
from repro_torch.telemetry import collecting  # noqa: E402

CPU = torch.device("cpu")
SMALL = ["ft3-small", "mpft-2p-small", "dragonfly-small", "dfplus-small"]
BASELINES = SMALL + ["ft3-65536", "mpft-8p-65536", "dragonfly-65536",
                     "dfplus-65536"]
MPHX_PRESETS = ["mphx-2p-8x8", "mphx-2p-16x16"]
GRAPH_SCENARIOS = sorted(n for n, s in SCENARIOS.items()
                         if s.graph_builder is not None)
MODES = ("minimal", "valiant", "adaptive")
# untrunked MPHX: multiplicity-proportional ECMP equals the array
# engine's ordering ECMP (the reference's UNTRUNKED)
UNTRUNKED = [dict(n=2, p=8, dims=(8, 8)), dict(n=1, p=4, dims=(4, 3)),
             dict(n=2, p=3, dims=(3, 3, 3)), dict(n=8, p=16, dims=(16,))]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fairshare_golden.json")


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The graph engine's CPU path is thousands of small ops; under the
    test runner's parallel workers torch's thread pools oversubscribe
    the cores (a route 100x slower), so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)
                                ).view(np.int64)


def topos(preset):
    return ref_sweep.SWEEP_TOPOLOGIES[preset], sweep.SWEEP_TOPOLOGIES[preset]


def routers(preset, dst_chunk=None):
    ref_t, t = topos(preset)
    return (ref_rg.GraphRouter(ref_t, backend="numpy", dst_chunk=dst_chunk),
            GraphRouter(t, device="cpu", dst_chunk=dst_chunk))


def port_demands(ref_dem):
    return demands_from_arrays(ref_dem.src, ref_dem.dst, ref_dem.gbps,
                               device="cpu")


# ------------------------------------------------------------ structure ----


@pytest.mark.parametrize("preset", BASELINES + MPHX_PRESETS)
def test_build_graph_matches(preset):
    ref_t, t = topos(preset)
    ref_g, g = ref_t.build_graph(), t.build_graph()
    assert g.directed_edge_arrays() == ref_g.directed_edge_arrays()
    assert g.nic_counts() == ref_g.nic_counts()
    assert (g.name, g.n_switches, g.nics_per_switch, g.link_gbps,
            g.nic_nodes, g.n_edges, g.total_links(), g.total_nics) == (
        ref_g.name, ref_g.n_switches, ref_g.nics_per_switch,
        ref_g.link_gbps, ref_g.nic_nodes, ref_g.n_edges,
        ref_g.total_links(), ref_g.total_nics)
    assert g.tier == ref_g.tier
    ref_csr, csr = ref_rg.CSRGraph(ref_g), CSRGraph(g, CPU)
    np.testing.assert_array_equal(csr.src.numpy(), ref_csr.src)
    np.testing.assert_array_equal(csr.dst.numpy(), ref_csr.dst)
    np.testing.assert_array_equal(bits(csr.mult), bits(ref_csr.mult))
    np.testing.assert_array_equal(bits(csr.cap), bits(ref_csr.cap))
    np.testing.assert_array_equal(csr.nic_counts.numpy(), ref_csr.nic_counts)


@pytest.mark.parametrize("preset", BASELINES)
def test_baseline_quantities_match(preset):
    ref_t, t = topos(preset)
    assert (t.name, t.n_nics, t.n_switches, t.n_optics, t.diameter,
            t.n_planes, t.port_gbps, t.bisection_links()) == (
        ref_t.name, ref_t.n_nics, ref_t.n_switches, ref_t.n_optics,
        ref_t.diameter, ref_t.n_planes, ref_t.port_gbps,
        ref_t.bisection_links())
    assert t.avg_hops() == ref_t.avg_hops()
    assert [(lc.speed_gbps, lc.count, lc.tier, lc.optical)
            for lc in t.link_classes()] == [
        (lc.speed_gbps, lc.count, lc.tier, lc.optical)
        for lc in ref_t.link_classes()]
    assert t.feasibility() == ref_t.feasibility()


def test_dragonfly_breakout_matches():
    for factor in (1, 2, 4):
        ref_b = RefDragonfly(p=16, a=32, h=16, groups=80).breakout(factor)
        b = Dragonfly(p=16, a=32, h=16, groups=80).breakout(factor)
        assert type(b).__name__ == type(ref_b).__name__
        assert (b.name, b.n_nics, b.n_switches, b.diameter) == (
            ref_b.name, ref_b.n_nics, ref_b.n_switches, ref_b.diameter)
    with pytest.raises(ValueError, match="power of two"):
        Dragonfly().breakout(3)


@pytest.mark.parametrize("preset", SMALL + ["mpft-8p-65536"] + MPHX_PRESETS)
def test_all_pairs_hops_match(preset):
    ref_t, t = topos(preset)
    want = ref_rg.CSRGraph(ref_t.build_graph()).all_pairs_hops()
    got = GraphRouter(t, device="cpu").hops
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_switch_graph_bfs_and_disconnected_graph():
    ref_t, t = topos("dragonfly-small")
    ref_g, g = ref_t.build_graph(), t.build_graph()
    assert [g.bfs_dist(s) for s in range(g.n_switches)] == \
        [ref_g.bfs_dist(s) for s in range(ref_g.n_switches)]
    assert g.switch_diameter() == ref_g.switch_diameter()
    assert g.switch_diameter(sample=5) == ref_g.switch_diameter(sample=5)
    assert g.avg_switch_hops(sample=7) == ref_g.avg_switch_hops(sample=7)
    broken = SwitchGraph(4, 1, 100.0)
    broken.add_edge(0, 1)
    broken.add_edge(2, 3)
    with pytest.raises(ValueError, match="disconnected"):
        CSRGraph(broken, CPU).all_pairs_hops()
    with pytest.raises(ValueError, match="self-loop"):
        broken.add_edge(1, 1)


# ------------------------------------------------------------ np_sum ----


@pytest.mark.parametrize("n", [1, 5, 8, 13, 128, 129, 130, 300, 1041, 8192,
                               8193, 20000])
def test_np_sum_is_numpys_sum(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)) * 10.0 ** rng.integers(-6, 6, (5, n))
    np.testing.assert_array_equal(bits(np_sum(torch.from_numpy(x))),
                                  bits(x.sum(axis=1)))
    v = np.abs(x[0])[rng.random(n) < 0.6]
    assert float(np_sum(torch.from_numpy(v))) == float(v.sum())


# ------------------------------------------------------------ routing ----


def test_demand_builders_match():
    builders = ["graph_uniform_demands", "graph_shift_demands",
                "graph_reverse_demands", "graph_hotspot_demands",
                "graph_ring_demands"]
    for preset in SMALL + MPHX_PRESETS[:1]:
        ref_t, t = topos(preset)
        for name in builders:
            want = getattr(ref_rg, name)(ref_t, 0.7 * ref_t.nic_bw_gbps)
            got = getattr(rg, name)(t, 0.7 * t.nic_bw_gbps, device="cpu")
            np.testing.assert_array_equal(got.src.numpy(), want.src)
            np.testing.assert_array_equal(got.dst.numpy(), want.dst)
            np.testing.assert_array_equal(bits(got.gbps), bits(want.gbps))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scenario", GRAPH_SCENARIOS)
@pytest.mark.parametrize("preset", SMALL)
def test_route_matches_the_reference(preset, scenario, mode):
    ref_r, r = routers(preset)
    ref_t, t = topos(preset)
    for load in (0.5, 1.0):
        want_d = REF_SCENARIOS[scenario].build(ref_t, load * ref_t.nic_bw_gbps,
                                               graph=ref_r.graph)
        got_d = SCENARIOS[scenario].build(t, load * t.nic_bw_gbps,
                                          graph=r.graph, device="cpu")
        want = ref_r.route(want_d, mode)
        got = r.route(got_d, mode)
        np.testing.assert_allclose(got.loads.numpy(), want.loads,
                                   rtol=1e-9, atol=0)
        if mode == "adaptive":
            # UGAL's choices hang on last bits: the reference's, exactly
            np.testing.assert_array_equal(bits(got.loads), bits(want.loads))
        assert got.max_utilization() == pytest.approx(
            want.max_utilization(), rel=1e-9)
        assert got.to_dict().keys() == want.to_dict().keys()


@pytest.mark.parametrize("dst_chunk", [1, 7, 150])
def test_route_over_several_chunks_matches(dst_chunk):
    kw = dict(p=4, a=8, h=4, groups=17)
    ref_r = ref_rg.GraphRouter(RefDragonfly(**kw), backend="numpy",
                               dst_chunk=dst_chunk)
    r = GraphRouter(Dragonfly(**kw), device="cpu", dst_chunk=dst_chunk)
    dem = ref_rg.graph_hotspot_demands(RefDragonfly(**kw), 1600.0)
    for mode in MODES:
        np.testing.assert_array_equal(
            bits(r.route(port_demands(dem), mode).loads),
            bits(ref_r.route(dem, mode).loads))


@pytest.mark.parametrize("pattern", ["uniform", "neighbor_shift"])
@pytest.mark.parametrize("kw", UNTRUNKED, ids=lambda k: str(k["dims"]))
def test_graph_matches_array_engine_minimal(kw, pattern):
    topo = MPHX(**kw)
    build = uniform_demands if pattern == "uniform" \
        else neighbor_shift_demands
    d = build(topo, 1600.0, device="cpu")
    arr = VectorizedHyperXRouter(topo, device="cpu").route(d, "minimal")
    gr = GraphRouter(topo, device="cpu").route(d, "minimal")
    a, g = arr.to_dict(), gr.to_dict()
    assert max(abs(a.get(k, 0.0) - g.get(k, 0.0)) for k in set(a) | set(g)) \
        < 1e-9
    assert gr.max_utilization() == pytest.approx(arr.max_utilization(),
                                                 abs=1e-9)


def test_empty_and_self_demands():
    _, r = routers("dragonfly-small")
    d = demands_from_arrays([3, 5], [3, 5], [10.0, 20.0], device="cpu")
    for mode in MODES:
        assert float(r.route(d, mode).loads.abs().sum()) == 0.0
    f, e, fr = r.incidence(d)
    assert f.numel() == e.numel() == fr.numel() == 0
    with pytest.raises(ValueError, match="unknown mode"):
        r.route(d, "ecmp")


def test_mean_switch_hops_matches():
    for preset in SMALL + ["mpft-8p-65536"]:
        ref_r, r = routers(preset)
        assert r.mean_switch_hops() == pytest.approx(
            ref_r.mean_switch_hops(), rel=1e-12)


# ------------------------------------------------------------ incidence ----


def _sorted_ref(f, e, fr):
    o = np.lexsort((e, f))
    return f[o], e[o], fr[o]


@pytest.mark.parametrize("preset", SMALL)
def test_incidence_matches_the_reference(preset):
    ref_r, r = routers(preset)
    rng = np.random.default_rng(7)
    S = r.csr.n_switches
    src, dst = rng.integers(0, S, 200), rng.integers(0, S, 200)
    dst[:10] = src[:10]                              # self pairs
    src[150:], dst[150:] = src[:50], dst[:50]        # repeated pairs
    dem = RefDemands(src, dst, np.ones(200))
    want = _sorted_ref(*ref_r.incidence(dem))
    got = r.incidence(port_demands(dem))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(bits(got[2]), bits(want[2]))
    with pytest.raises(ValueError) as got_err:
        r.incidence(port_demands(dem), "valiant")
    with pytest.raises(ValueError) as want_err:
        ref_r.incidence(dem, "valiant")
    assert str(got_err.value) == str(want_err.value)


def _cache_counts(router):
    m = router.metrics
    return tuple(int(m.value(k)) for k in ("incidence.walks",
                                           "incidence.cache_hits",
                                           "incidence.cache_misses"))


@pytest.mark.parametrize("engine", ["graph", "array"])
def test_incidence_cache_matches_the_reference(engine):
    if engine == "graph":
        ref_t, t = topos("dragonfly-small")
        ref_r, r = ref_make_router(ref_t, backend="numpy"), \
            make_router(t, device="cpu")
        full = ref_rg.graph_uniform_demands(ref_t, 800.0)
        part = ref_rg.graph_shift_demands(ref_t, 800.0)
        modes = ["minimal"]
    else:
        kw = dict(n=2, p=8, dims=(8, 8))
        ref_r = ref_make_router(RefMPHX(**kw), backend="numpy")
        r = make_router(MPHX(**kw), device="cpu")
        from repro.core.routing_vec import neighbor_shift_demands as rs
        from repro.core.routing_vec import uniform_demands as ru
        full, part = ru(RefMPHX(**kw), 400.0), rs(RefMPHX(**kw), 800.0)
        modes = ["minimal", "valiant"]
    with ref_collecting() as ref_mx, collecting() as mx:
        for mode in modes:
            for dem in (part, full, full, part):
                want = ref_r.incidence_cached(dem, mode)
                got = r.incidence_cached(port_demands(dem), mode)
                walk = r.incidence(port_demands(dem), mode)
                ref_r.incidence(dem, mode)
                for g, w in zip(got, walk):
                    assert torch.equal(g, w)
                np.testing.assert_array_equal(got[0].numpy(), want[0])
                np.testing.assert_array_equal(got[1].numpy(), want[1])
                np.testing.assert_array_equal(bits(got[2]), bits(want[2]))
                assert _cache_counts(r) == _cache_counts(ref_r)
        r.reset_incidence_cache()
        ref_r.reset_incidence_cache()
        flow_incidence(r, port_demands(part), cached=True)
        ref_flow_incidence(ref_r, part, cached=True)
        assert _cache_counts(r) == _cache_counts(ref_r)
        assert mx.snapshot()["counters"] == ref_mx.snapshot()["counters"]
    assert r.incidence_calls == ref_r.incidence_calls > 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r.incidence_calls = 0
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert r.metrics.value("incidence.walks") == 0


# ------------------------------------------------------- load sweeps ----


@pytest.mark.parametrize("mode", ["minimal", "valiant", "adaptive"])
@pytest.mark.parametrize("preset", ["dragonfly-small", "ft3-small"])
def test_load_sweep_rows_match(preset, mode):
    ref_t, t = topos(preset)
    simulate = mode == "minimal"
    sc, ref_sc = SCENARIOS["hotspot"], REF_SCENARIOS["hotspot"]
    want = ref_load_sweep(ref_t, lambda tt, o: ref_sc.build(tt, o),
                          mode=mode, backend="numpy", simulate=simulate,
                          flow_time_s=200e-6, sim_backend="numpy")
    got = load_sweep(t, lambda tt, o: sc.build(tt, o, device="cpu"),
                     mode=mode, simulate=simulate, flow_time_s=200e-6,
                     sim_backend="torch", device="cpu")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float) and v != 0:
                assert abs(g[k] - v) <= 1e-9 * abs(v), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)
        assert ("fct_p99_us" in g) == simulate


def test_load_sweep_refuses_to_simulate_graph_valiant():
    _, t = topos("dragonfly-small")
    with pytest.raises(ValueError, match="no static per-flow incidence"):
        load_sweep(t, lambda tt, o: SCENARIOS["uniform"].build(
            tt, o, device="cpu"), mode="valiant", simulate=True,
            load_fractions=(0.5,), device="cpu")


@pytest.mark.parametrize("backend", ("torch", "cuda"))
def test_golden_graph_cell(backend):
    """``graph/dragonfly-small/uniform`` of the golden at both loads:
    exact incidence sizes, rates and link loads within 1e-9 of the scale,
    FCT columns within 1e-9 relative (the golden's jit-path limits)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    cell = golden["cells"]["graph/dragonfly-small/uniform"]
    assert cell["mode"] == "minimal"
    _, t = topos("dragonfly-small")
    router = make_router(t, device="cpu")
    for load_key, want in cell["loads"].items():
        dem = rg.graph_uniform_demands(t, float(load_key) * t.nic_bw_gbps,
                                       graph=router.graph, device="cpu")
        inc = flow_incidence(router, dem, "minimal", backend=backend)
        assert (inc.n_flows, inc.n_edges, inc.nnz) == (
            want["n_flows"], want["n_edges"], want["nnz"])
        caps = dem.gbps
        scale = max(float(caps.max()), 1.0)
        rates = max_min_rates(inc, caps, backend=backend, device="cpu")
        np.testing.assert_allclose(rates.numpy(), want["rates_gbps"],
                                   rtol=0, atol=1e-9 * scale)
        golden_loads = np.zeros(inc.n_edges)
        for e, v in want["link_loads_gbps_nonzero"].items():
            golden_loads[int(e)] = v
        np.testing.assert_allclose(inc.loads(rates, backend).numpy(),
                                   golden_loads, rtol=0, atol=1e-9 * scale)
        row = simulate_demands(router, dem, golden["flow_time_s"],
                               backend=backend, inc=inc)
        for k, v in want["fct"].items():
            if isinstance(v, float) and v != 0:
                assert abs(row[k] - v) <= 1e-9 * abs(v) + 1e-12, (k, row[k])
            else:
                assert row[k] == v, (k, row[k], v)


# ------------------------------------------------------------ engines ----


@pytest.mark.parametrize("preset", SMALL + MPHX_PRESETS[:1])
def test_resolve_engine_and_make_router_match(preset):
    ref_t, t = topos(preset)
    for engine in ("auto", "array", "graph", "ecmp"):
        try:
            want = ref_resolve(ref_t, engine)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                resolve_engine(t, engine)
            assert str(got.value) == str(e)
            continue
        assert resolve_engine(t, engine) == want
        router = make_router(t, engine, device="cpu")
        assert isinstance(router, GraphRouter if want == "graph"
                          else VectorizedHyperXRouter)
        assert router.device == CPU
