"""The port's event loop against the JAX package's.

The staggered golden trace of ``tests/golden/fairshare_golden.json`` with
the exact epoch count (as ``tests/test_fairshare_golden.py`` holds the
reference to it), ``simulate_demands`` rows against the reference's
jitted loop (``backend="jax"``) at 1e-9 relative with integers exact, and
the stalled-flow and uncontended cases and staggered starts over random
flows on 1-D and 3-D fabrics, in minimal and valiant routing, against
the reference's numpy loop.  ``simulate_flows`` and
``simulate_flow_batches`` with tagged flows on the array and the graph
engine, the ``per_tag`` row and the ``sim.*`` counters against the
reference's numpy loop, and the metrics registry's semantics.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.core.netsim import make_router as ref_make_router  # noqa: E402
from repro.core.routing_vec import (  # noqa: E402
    neighbor_shift_demands as ref_shift, uniform_demands as ref_uniform)
from repro.sim.events import (  # noqa: E402
    path_latency as ref_path_latency, simulate_demands as ref_sim_demands,
    simulate_incidence as ref_sim_incidence)
from repro.sim.fairshare import FlowIncidence as RefIncidence  # noqa: E402
from repro_torch.convert import incidence_from_arrays  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import make_router  # noqa: E402
from repro_torch.core.routing_vec import (  # noqa: E402
    neighbor_shift_demands, uniform_demands)
from repro_torch.sim.events import (  # noqa: E402
    path_latency, simulate_demands, simulate_incidence)
from repro_torch.sim.fairshare import flow_incidence  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fairshare_golden.json")
BACKENDS = ("torch", "cuda")
TOPOS = {"mphx-2p-8x8": dict(n=2, p=8, dims=(8, 8)),
         "trunked": dict(n=4, p=8, dims=(9, 4), links_per_dim=(8, 8))}
SCENARIOS = {"uniform": (ref_uniform, uniform_demands),
             "neighbor_shift": (ref_shift, neighbor_shift_demands)}


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def as_port(ref_inc):
    return incidence_from_arrays(ref_inc.flow, ref_inc.edge, ref_inc.frac,
                                 ref_inc.n_flows, ref_inc.capacity,
                                 device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_staggered_trace_matches_golden(backend):
    with open(GOLDEN) as f:
        rec = json.load(f)["staggered"]
    topo = MPHX(n=2, p=8, dims=(8, 8))
    router = make_router(topo, device="cpu")
    inc = flow_incidence(router, neighbor_shift_demands(topo, 800.0,
                                                        device="cpu"))
    size = np.asarray(rec["size_bytes"])
    res = simulate_incidence(inc, size, np.asarray(rec["rate_caps_gbps"]),
                             start_s=np.asarray(rec["start_s"]),
                             backend=backend, device="cpu")
    makespan = rec["makespan_s"]
    tight = 1e-12
    # exact epoch count: arrival batching and dead-flow stalling are the
    # reference's, not merely its totals
    assert res.n_epochs == rec["n_epochs"]
    np.testing.assert_allclose(res.finish_s.numpy(), rec["finish_s"],
                               rtol=0, atol=tight * makespan)
    np.testing.assert_allclose(res.fct_s.numpy(), rec["fct_s"], rtol=0,
                               atol=tight * makespan)
    assert abs(res.makespan_s - makespan) <= tight * makespan
    golden_bytes = np.zeros(inc.n_edges)
    for e, v in rec["edge_bytes_nonzero"].items():
        golden_bytes[int(e)] = v
    np.testing.assert_allclose(res.edge_bytes.numpy(), golden_bytes,
                               rtol=tight, atol=tight * size.sum())


# staggered-start cases: (topology, mode, seed); 1-D and 3-D fabrics
STAGGERED_TOPOS = {"1d": dict(n=2, p=4, dims=(8,)),
                   "3d": dict(n=1, p=4, dims=(4, 3, 5))}
STAGGERED = [(t, m, seed) for t in sorted(STAGGERED_TOPOS)
             for m in ("minimal", "valiant") for seed in range(2)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("topo_name,mode,seed", STAGGERED)
def test_staggered_starts_match_the_reference_loop(topo_name, mode, seed,
                                                   backend):
    """Random (src, dst) pairs (some repeated), sizes, rate caps and start
    times from a numpy seed, routed on both packages' routers, through
    the reference's numpy event loop and the port's: the exact epoch
    count, finish times within 1e-9 relative, edge bytes within 1e-9 of
    the bytes sent."""
    from repro.core.routing_vec import DemandArrays as RefDemands
    from repro.sim.fairshare import flow_incidence as ref_flow_incidence
    from repro_torch.convert import demands_from_arrays

    kw = STAGGERED_TOPOS[topo_name]
    rng = np.random.default_rng(100 + seed)
    S = RefMPHX(**kw).switches_per_plane
    F = 48
    src = rng.integers(0, S, F)
    dst = (src + rng.integers(1, S, F)) % S
    gbps = np.ones(F)
    size = rng.uniform(1e4, 2e6, F)
    caps = rng.uniform(20.0, 400.0, F)
    start = np.where(rng.random(F) < 0.3, 0.0, rng.uniform(0.0, 2e-4, F))
    ref_inc = ref_flow_incidence(
        ref_make_router(RefMPHX(**kw), backend="numpy"),
        RefDemands(src, dst, gbps), mode)
    want = ref_sim_incidence(ref_inc, size, caps, start_s=start,
                             backend="numpy")
    inc = flow_incidence(make_router(MPHX(**kw), device="cpu"),
                         demands_from_arrays(src, dst, gbps, device="cpu"),
                         mode)
    np.testing.assert_array_equal(inc.edge.numpy(), ref_inc.edge)
    got = simulate_incidence(inc, size, caps, start_s=start,
                             backend=backend, device="cpu")
    assert got.n_epochs == want.n_epochs
    assert want.n_epochs > 2
    np.testing.assert_allclose(got.finish_s.numpy(), want.finish_s,
                               rtol=1e-9, atol=0)
    assert abs(got.makespan_s - want.makespan_s) <= 1e-9 * want.makespan_s
    np.testing.assert_allclose(got.edge_bytes.numpy(), want.edge_bytes,
                               rtol=0, atol=1e-9 * size.sum())


def assert_rows_match(got: dict, want: dict):
    for k, v in want.items():
        w = got[k]
        if isinstance(v, float) and v != 0:
            assert abs(w - v) <= 1e-9 * abs(v), (k, w, v)
        else:
            assert w == v, (k, w, v)


@pytest.mark.parametrize("load", (0.5, 1.2))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_simulate_demands_matches_jit_reference(topo_name, scenario, load):
    kw = TOPOS[topo_name]
    ref_topo, topo = RefMPHX(**kw), MPHX(**kw)
    ref_build, build = SCENARIOS[scenario]
    offered = load * topo.nic_bw_gbps
    want = ref_sim_demands(ref_make_router(ref_topo, backend="numpy"),
                           ref_build(ref_topo, offered), 200e-6,
                           backend="jax")
    for backend in BACKENDS:
        got = simulate_demands(make_router(topo, device="cpu"),
                               build(topo, offered, device="cpu"), 200e-6,
                               backend=backend)
        assert_rows_match(got, want)
        assert got["sim_nnz"] > 0 and got["sim_waterfill_rounds"] >= 1


def stalled_incidence():
    """Flows 0 and 1 cross a zero-capacity edge; flow 2 arrives later."""
    return RefIncidence(flow=np.array([0, 0, 1, 2]),
                        edge=np.array([0, 1, 1, 2]),
                        frac=np.array([1.0, 1.0, 0.5, 1.0]), n_flows=3,
                        capacity=np.array([4.0, 0.0, 2.0]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_dead_flows_stall_like_the_reference(backend):
    ref_inc = stalled_incidence()
    size, caps = np.array([1e6, 2e6, 5e5]), np.array([3.0, 3.0, 1.0])
    start = np.array([0.0, 0.0, 1e-3])
    want = ref_sim_incidence(ref_inc, size, caps, start_s=start,
                             backend="numpy")
    got = simulate_incidence(as_port(ref_inc), size, caps, start_s=start,
                             backend=backend, device="cpu")
    assert got.n_epochs == want.n_epochs
    np.testing.assert_array_equal(got.stalled.numpy(), want.stalled)
    np.testing.assert_allclose(got.finish_s.numpy(), want.finish_s,
                               rtol=1e-12)
    np.testing.assert_allclose(got.edge_bytes.numpy(), want.edge_bytes,
                               rtol=1e-12)
    assert got.makespan_s == pytest.approx(want.makespan_s, rel=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_uncontended_flow_is_the_closed_form(backend):
    ref_inc = RefIncidence(flow=np.array([0, 0]), edge=np.array([1, 3]),
                           frac=np.array([1.0, 0.5]), n_flows=1,
                           capacity=np.array([9.0, 4.0, 9.0, 1.0]))
    inc = as_port(ref_inc)
    lat = path_latency(inc, backend=backend)
    np.testing.assert_allclose(lat.numpy(), ref_path_latency(ref_inc),
                               rtol=1e-15)
    res = simulate_incidence(inc, 1e6, 10.0, backend=backend, device="cpu")
    # bottleneck min(4/1, 1/0.5) = 2 Gbps
    want = 1e6 / (2.0 * 1e9 / 8) + float(lat[0])
    assert float(res.fct_s[0]) == pytest.approx(want, rel=1e-12)
    assert float(res.slowdown(10.0)[0]) == pytest.approx(1.0, rel=1e-12)
    assert res.fct_percentiles() == {f"p{q}": float(res.fct_s[0])
                                     for q in (50, 95, 99)}


def test_empty_flow_set():
    inc = incidence_from_arrays([], [], [], 0, np.ones(3), device="cpu")
    res = simulate_incidence(inc, np.zeros(0), 1.0, device="cpu")
    assert res.n_epochs == 0 and res.makespan_s == 0.0
    assert res.edge_bytes.shape == (3,)
    assert res.fct_percentiles() == {"p50": None, "p95": None, "p99": None}


def test_negative_sizes_rejected():
    inc = incidence_from_arrays([0], [0], [1.0], 1, [1.0], device="cpu")
    with pytest.raises(ValueError, match="sizes must be >= 0"):
        simulate_incidence(inc, -1.0, 1.0, device="cpu")


# ------------------------------------------- flow lists, batches, tags ----

from repro.core.dragonfly import Dragonfly as RefDragonfly  # noqa: E402
from repro.sim import events as ref_events  # noqa: E402
from repro.telemetry import metrics as ref_metrics  # noqa: E402
from repro_torch.core.dragonfly import Dragonfly  # noqa: E402
from repro_torch.sim import events  # noqa: E402
from repro_torch.telemetry import metrics  # noqa: E402

FABRICS = {"mphx-2p-8x8": (RefMPHX, MPHX, dict(n=2, p=8, dims=(8, 8))),
           "dragonfly-small": (RefDragonfly, Dragonfly,
                               dict(p=2, a=4, h=2, groups=9))}


def random_flows(S: int, F: int, seed: int, spec):
    """F flows over S switches (repeated pairs, staggered starts, tags
    from three tenants) as ``spec`` objects (either package's)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, S, F)
    dst = (src + rng.integers(1, S, F)) % S
    pairs = rng.integers(0, F, F // 3)
    src[F - F // 3:], dst[F - F // 3:] = src[pairs], dst[pairs]
    size = rng.uniform(1e4, 2e6, F)
    start = np.where(rng.random(F) < 0.5, 0.0, rng.uniform(0, 1e-4, F))
    tags = [("tenant", int(t)) for t in rng.integers(0, 3, F)]
    return [spec(int(s_), int(d), float(z), float(t0), tag)
            for s_, d, z, t0, tag in zip(src, dst, size, start, tags)]


def assert_results_match(got, want):
    assert got.n_epochs == want.n_epochs
    np.testing.assert_allclose(got.finish_s.numpy(), want.finish_s,
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.fct_s.numpy(), want.fct_s, rtol=1e-9,
                               atol=0)
    assert list(got.tags) == list(want.tags)
    for g, w in zip(got.flow_records(), want.flow_records()):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float) and v != 0:
                assert abs(g[k] - v) <= 1e-9 * abs(v), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_simulate_flows_matches_the_reference(fabric, backend):
    ref_cls, cls, kw = FABRICS[fabric]
    ref_router = ref_make_router(ref_cls(**kw), backend="numpy")
    router = make_router(cls(**kw), device="cpu")
    S = router.graph.n_switches if hasattr(router, "graph") \
        else router.topo.switches_per_plane
    want = ref_events.simulate_flows(
        ref_router, random_flows(S, 40, 3, ref_events.FlowSpec),
        backend="numpy")
    got = events.simulate_flows(router, random_flows(S, 40, 3,
                                                     events.FlowSpec),
                                backend=backend)
    assert_results_match(got, want)
    assert want.n_epochs > 2
    np.testing.assert_array_equal(got.tag_mask(("tenant", 1)),
                                  want.tag_mask(("tenant", 1)))


@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_simulate_flow_batches_matches_the_reference(fabric):
    ref_cls, cls, kw = FABRICS[fabric]
    ref_router = ref_make_router(ref_cls(**kw), backend="numpy")
    router = make_router(cls(**kw), device="cpu")
    S = router.graph.n_switches if hasattr(router, "graph") \
        else router.topo.switches_per_plane

    def batches(spec):
        a, b = random_flows(S, 12, 5, spec), random_flows(S, 9, 6, spec)
        return [a, [], b, a, b[:4]]

    want = ref_events.simulate_flow_batches(
        ref_router, batches(ref_events.FlowSpec), gap_s=2e-6,
        rate_cap_gbps=200.0)
    got = events.simulate_flow_batches(router, batches(events.FlowSpec),
                                       gap_s=2e-6, rate_cap_gbps=200.0,
                                       backend="torch")
    np.testing.assert_allclose(got.batch_start_s, want.batch_start_s,
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.batch_finish_s, want.batch_finish_s,
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.batch_span_s(), want.batch_span_s(),
                               rtol=1e-9, atol=1e-18)
    assert got.makespan_s == pytest.approx(want.makespan_s, rel=1e-9)
    assert got.results[1] is None and want.results[1] is None
    for g, w in zip(got.results, want.results):
        if w is not None:
            assert_results_match(g, w)
    # the repeated batches ride the pair cache: the reference's walks
    for key in ("incidence.walks", "incidence.cache_hits",
                "incidence.cache_misses"):
        assert router.metrics.value(key) == ref_router.metrics.value(key)
    assert router.metrics.value("incidence.walks") == 2


def test_simulate_demands_per_tag_matches_the_reference():
    kw = TOPOS["mphx-2p-8x8"]
    ref_router = ref_make_router(RefMPHX(**kw), backend="numpy")
    router = make_router(MPHX(**kw), device="cpu")
    ref_dem = ref_shift(RefMPHX(**kw), 1200.0)
    dem = neighbor_shift_demands(MPHX(**kw), 1200.0, device="cpu")
    tags = ["a" if i % 3 else ("b", i % 2) for i in range(ref_dem.n)]
    want = ref_sim_demands(ref_router, ref_dem, 200e-6, backend="numpy",
                           tags=tags)
    got = simulate_demands(router, dem, 200e-6, backend="torch", tags=tags)
    assert got["per_tag"].keys() == want["per_tag"].keys()
    for tag, w in want["per_tag"].items():
        assert_rows_match(got["per_tag"][tag], w)
    assert "per_tag" not in simulate_demands(router, dem, 200e-6)
    with pytest.raises(ValueError, match=f"expected {dem.n} tags, got "
                       f"{dem.n + 1}"):
        simulate_demands(router, dem, 200e-6, tags=tags + ["x"])
    res = simulate_incidence(flow_incidence(router, dem), 1e6, 100.0,
                             device="cpu")
    with pytest.raises(ValueError, match="without flow tags"):
        res.tag_mask("a")
    assert [r["tag"] for r in res.flow_records()] == [None] * dem.n


def test_sim_counters_match_the_reference():
    kw = TOPOS["mphx-2p-8x8"]
    ref_router = ref_make_router(RefMPHX(**kw), backend="numpy")
    router = make_router(MPHX(**kw), device="cpu")
    with ref_metrics.collecting() as want, metrics.collecting() as got:
        for load in (0.5, 1.2):
            ref_sim_demands(ref_router, ref_uniform(RefMPHX(**kw),
                                                    load * 1600.0),
                            200e-6, backend="numpy")
            simulate_demands(router, uniform_demands(MPHX(**kw),
                                                     load * 1600.0,
                                                     device="cpu"),
                             200e-6, backend="torch")
    for k in ("sim.runs", "sim.flows", "sim.epochs", "incidence.walks"):
        assert got.value(k) == want.value(k) > 0, k
    assert got.snapshot()["timers"]["sim.wall_s"]["count"] == 2
    # nothing collects outside the scope
    assert metrics.get_metrics() is metrics.NULL_METRICS


def test_metrics_registry_semantics_match_the_reference():
    def drive(mod):
        reg = mod.MetricsRegistry()
        reg.inc("a")
        reg.inc("a", 2.5)
        reg.set_counter("b", 7)
        reg.gauge("g", "x")
        reg.gauge("g", 3)
        for sec in (0.25, 0.125, 0.5):
            reg.observe("t", sec)
        other = mod.MetricsRegistry()
        other.inc("a", 1)
        other.gauge("h", 1.5)
        other.observe("t", 1.0)
        reg.merge(other, prefix="p.")
        reg.merge(other)
        null = mod.NullRegistry()
        null.inc("a")
        null.observe("t", 1.0)
        null.merge(reg)
        with null.timer("t"):
            pass
        with reg.timer("w"):
            pass
        snap = reg.snapshot()
        snap["timers"]["w"] = {k: v for k, v in snap["timers"]["w"].items()
                               if k == "count"}
        with mod.collecting() as outer:
            mod.get_metrics().inc("c")
            with mod.collecting(reg) as inner:
                mod.get_metrics().inc("c", 4)
                assert inner is reg
            mod.get_metrics().inc("c")
        assert mod.get_metrics() is mod.NULL_METRICS
        return (snap, reg.value("a"), reg.value("missing"), reg.value("c"),
                outer.value("c"), null.snapshot(), null.value("a"),
                null.enabled, reg.enabled)

    assert drive(metrics) == drive(ref_metrics)
