"""The port's valiant and adaptive routing, the five synthetic demand
builders, the scenario registry and ``load_sweep`` in all three modes,
against the JAX package's (its numpy backend), on the CPU.

Tolerances: demand arrays equal; ``route_valiant`` loads within 1e-12 of
the largest load; the valiant incidence's ``flow`` and ``edge`` columns
equal (the same COO order) and ``frac`` within 1e-15; ``route_adaptive``
loads bit for bit equal (its jitter is the reference's numpy draw and
every load update adds in the reference's order), at the default and at
other ``granularity`` / ``sub_batches``; ``skip_reason`` equal;
``load_sweep`` rows with floats at 1e-9 relative and the rest exactly.
The fixed-order sum (``ordered_sum``) equals ``np.bincount`` and
``np.add.at`` bit for bit on the CPU with either backend.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core import routing_vec as ref_rv  # noqa: E402
from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.core.netsim import load_sweep as ref_load_sweep  # noqa: E402
from repro.experiments import scenarios as ref_scenarios  # noqa: E402
from repro.experiments import sweep as ref_sweep  # noqa: E402
from repro_torch.core import routing_vec as rv  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import load_sweep, make_router  # noqa: E402
from repro_torch.experiments import scenarios  # noqa: E402
from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES  # noqa: E402

TOPOS = {
    "mphx-2p-8x8": dict(n=2, p=8, dims=(8, 8)),
    "3d": dict(n=1, p=4, dims=(4, 3, 5)),
    # dim 2 trunks 8 links over its 3 neighbours, as mphx-4p-86x9 does
    "trunked": dict(n=4, p=8, dims=(9, 4), links_per_dim=(8, 8)),
    "1d": dict(n=2, p=4, dims=(8,)),
}
BUILDERS = ("uniform_demands", "neighbor_shift_demands",
            "bit_complement_demands", "transpose_demands", "hotspot_demands")
# transpose needs a square grid: mphx-2p-8x8 only
CELLS = [(t, b) for t in sorted(TOPOS) for b in BUILDERS
         if b != "transpose_demands" or t == "mphx-2p-8x8"]
LOAD = 0.7


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def setup(topo_name, builder, load=LOAD):
    kw = TOPOS[topo_name]
    ref_topo, topo = RefMPHX(**kw), MPHX(**kw)
    offered = load * topo.nic_bw_gbps
    return (ref_rv.VectorizedHyperXRouter(ref_topo, backend="numpy"),
            getattr(ref_rv, builder)(ref_topo, offered),
            make_router(topo, device="cpu"),
            getattr(rv, builder)(topo, offered, device="cpu"))


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_demand_builders_match(topo_name, builder):
    kw = TOPOS[topo_name]
    ref_topo, topo = RefMPHX(**kw), MPHX(**kw)
    if (topo_name, builder) not in CELLS:
        with pytest.raises(ValueError, match="transpose undefined"):
            getattr(ref_rv, builder)(ref_topo, 800.0)
        with pytest.raises(ValueError, match="transpose undefined"):
            getattr(rv, builder)(topo, 800.0, device="cpu")
        return
    want = getattr(ref_rv, builder)(ref_topo, 800.0)
    got = getattr(rv, builder)(topo, 800.0, device="cpu")
    assert got.src.dtype == got.dst.dtype == torch.int64
    assert got.gbps.dtype == torch.float64
    np.testing.assert_array_equal(got.src.numpy(), want.src)
    np.testing.assert_array_equal(got.dst.numpy(), want.dst)
    np.testing.assert_array_equal(got.gbps.numpy(), want.gbps)


def test_hotspot_keeps_repeated_pairs():
    topo = MPHX(**TOPOS["1d"])
    dem = rv.hotspot_demands(topo, 800.0, hot=3, hot_fraction=0.25,
                             device="cpu")
    want = ref_rv.hotspot_demands(RefMPHX(**TOPOS["1d"]), 800.0, hot=3,
                                  hot_fraction=0.25)
    np.testing.assert_array_equal(dem.gbps.numpy(), want.gbps)
    pairs = list(zip(dem.src.tolist(), dem.dst.tolist()))
    assert len(pairs) - len(set(pairs)) == topo.switches_per_plane - 1


@pytest.mark.parametrize("topo_name,builder", CELLS)
def test_route_valiant_loads_match(topo_name, builder):
    ref_router, ref_dem, router, dem = setup(topo_name, builder)
    want = np.asarray(ref_router.route(ref_dem, "valiant").loads)
    got = router.route(dem, "valiant")
    np.testing.assert_allclose(got.loads.numpy(), want, rtol=0,
                               atol=1e-12 * want.max())
    assert abs(got.max_utilization()
               - ref_router.route(ref_dem, "valiant").max_utilization()) \
        <= 1e-12 * max(got.max_utilization(), 1.0)


@pytest.mark.parametrize("topo_name,builder", CELLS)
def test_valiant_incidence_has_the_reference_order(topo_name, builder):
    ref_router, ref_dem, router, dem = setup(topo_name, builder)
    rf, re, rfr = ref_router.incidence(ref_dem, "valiant")
    for backend in ("cuda", "torch"):
        f, e, fr = router.incidence(dem, "valiant", backend=backend)
        assert f.dtype == e.dtype == torch.int64
        assert fr.dtype == torch.float64
        np.testing.assert_array_equal(f.numpy(), rf)
        np.testing.assert_array_equal(e.numpy(), re)
        np.testing.assert_allclose(fr.numpy(), rfr, rtol=0, atol=1e-15)


@pytest.mark.parametrize("backend", ("cuda", "torch"))
@pytest.mark.parametrize("topo_name,builder", CELLS)
def test_route_adaptive_bit_equal(topo_name, builder, backend):
    ref_router, ref_dem, router, dem = setup(topo_name, builder)
    want = ref_router.route(ref_dem, "adaptive")
    got = router.route(dem, "adaptive", backend=backend)
    np.testing.assert_array_equal(bits(got.loads.numpy()), bits(want.loads))
    assert got.max_utilization() == want.max_utilization()


@pytest.mark.parametrize("granularity,sub_batches",
                         [(1, 1), (3, 5), (16, 3), (2, 64)])
@pytest.mark.parametrize("topo_name", ["mphx-2p-8x8", "1d", "3d"])
def test_route_adaptive_bit_equal_other_rounds(topo_name, granularity,
                                               sub_batches):
    """Other quantum rounds and group counts, on hotspot traffic (its
    repeated pairs and incast ties); 64 groups on the 1-D fabric leave
    fewer demands than groups."""
    ref_router, ref_dem, router, dem = setup(topo_name, "hotspot_demands",
                                             1.1)
    want = ref_router.route_adaptive(ref_dem, granularity, sub_batches)
    got = router.route_adaptive(dem, granularity, sub_batches)
    np.testing.assert_array_equal(bits(got.loads.numpy()), bits(want.loads))


def test_route_adaptive_of_no_demands():
    _, _, router, dem = setup("mphx-2p-8x8", "uniform_demands")
    empty = rv.DemandArrays(dem.src[:0], dem.dst[:0], dem.gbps[:0])
    assert float(router.route(empty, "adaptive").loads.abs().sum()) == 0.0


def test_valiant_refuses_self_demands():
    _, _, router, dem = setup("mphx-2p-8x8", "uniform_demands")
    self_dem = rv.DemandArrays(dem.src[:3], dem.src[:3], dem.gbps[:3])
    with pytest.raises(ValueError, match="src != dst"):
        router.route(self_dem, "valiant")
    with pytest.raises(ValueError, match="src != dst"):
        router.incidence(self_dem, "valiant")


def test_unknown_modes_raise():
    _, _, router, dem = setup("mphx-2p-8x8", "uniform_demands")
    with pytest.raises(ValueError, match="unknown mode"):
        router.route(dem, "bogus")
    with pytest.raises(ValueError, match="no static per-flow incidence"):
        router.incidence(dem, "adaptive")
    with pytest.raises(ValueError, match="unknown fairshare backend"):
        router.route(dem, "adaptive", backend="auto")


@pytest.mark.parametrize("backend", ("cuda", "torch"))
@pytest.mark.parametrize("seed", range(3))
def test_ordered_sum_equals_numpy_on_the_cpu(seed, backend):
    """The fixed-order sum on CPU tensors: ``np.bincount``'s and
    ``np.add.at``'s bits (each bin adds its entries in entry order)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    ids = rng.integers(0, n, 20_000)
    vals = rng.standard_normal(20_000) * 10.0 ** rng.integers(-3, 4, 20_000)
    got = rv.ordered_sum(torch.from_numpy(vals), torch.from_numpy(ids), n,
                         backend).numpy()
    np.testing.assert_array_equal(bits(got), bits(
        np.bincount(ids, weights=vals, minlength=n)))
    at = np.zeros(n)
    np.add.at(at, ids, vals)
    np.testing.assert_array_equal(bits(got), bits(at))


@pytest.mark.parametrize("scenario", sorted(ref_scenarios.SCENARIOS))
def test_scenario_registry_matches(scenario):
    ref, port = ref_scenarios.SCENARIOS[scenario], \
        scenarios.get_scenario(scenario)
    assert (port.name, port.kind, port.default_mode, port.requires_reason) \
        == (ref.name, ref.kind, ref.default_mode, ref.requires_reason)
    assert (port.graph_builder is None) == (ref.graph_builder is None)
    # every preset of the reference, the graph-engine baselines too
    assert list(SWEEP_TOPOLOGIES) == list(ref_sweep.SWEEP_TOPOLOGIES)
    for preset in SWEEP_TOPOLOGIES:
        assert SWEEP_TOPOLOGIES[preset].name == \
            ref_sweep.SWEEP_TOPOLOGIES[preset].name
        assert port.skip_reason(SWEEP_TOPOLOGIES[preset]) == \
            ref.skip_reason(ref_sweep.SWEEP_TOPOLOGIES[preset]), preset
        assert port.applicable(SWEEP_TOPOLOGIES[preset]) == \
            ref.applicable(ref_sweep.SWEEP_TOPOLOGIES[preset])


def test_available_scenarios_match():
    assert scenarios.available_scenarios() == \
        ref_scenarios.available_scenarios()
    assert [s.kind for s in scenarios.SCENARIOS.values()] == \
        [s.kind for s in ref_scenarios.SCENARIOS.values()]
    for preset in ("mphx-2p-8x8", "mphx-4p-86x9", "mphx-8p-256",
                   "dragonfly-small", "ft3-65536"):
        assert scenarios.available_scenarios(SWEEP_TOPOLOGIES[preset]) == \
            ref_scenarios.available_scenarios(
                ref_sweep.SWEEP_TOPOLOGIES[preset])


def assert_rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float) and v != 0:
                assert abs(g[k] - v) <= 1e-9 * abs(v), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("mode", ("minimal", "valiant", "adaptive"))
@pytest.mark.parametrize("builder", ("uniform_demands",
                                     "neighbor_shift_demands",
                                     "hotspot_demands"))
@pytest.mark.parametrize("topo_name", ["mphx-2p-8x8", "1d"])
def test_load_sweep_rows_match(topo_name, builder, mode):
    """Six load levels (adaptive re-routes each); measured FCT columns
    with the static spreads."""
    kw = TOPOS[topo_name]
    ref_topo, topo = RefMPHX(**kw), MPHX(**kw)
    simulate = mode != "adaptive"
    want = ref_load_sweep(
        ref_topo, getattr(ref_rv, builder), mode=mode, backend="numpy",
        simulate=simulate, flow_time_s=200e-6, sim_backend="numpy")
    got = load_sweep(
        topo, lambda t, o: getattr(rv, builder)(t, o, device="cpu"),
        mode=mode, simulate=simulate, flow_time_s=200e-6,
        sim_backend="torch", device="cpu")
    assert_rows_match(got, want)
    assert len(got) == 6


def test_load_sweep_refuses_to_simulate_adaptive_before_routing():
    topo = MPHX(**TOPOS["mphx-2p-8x8"])

    def never(t, o):
        raise AssertionError("routed before refusing")

    with pytest.raises(ValueError, match="adaptive re-routes under load") \
            as got:
        load_sweep(topo, never, mode="adaptive", simulate=True,
                   router=make_router(topo, device="cpu"))
    with pytest.raises(ValueError) as want:
        ref_load_sweep(RefMPHX(**TOPOS["mphx-2p-8x8"]), never,
                       mode="adaptive", simulate=True, backend="numpy")
    assert str(got.value) == str(want.value)


def test_load_sweep_passes_its_backend_to_the_router():
    """``sim_backend`` reaches the router's route and incidence calls
    (``None``: each call's default, ``cuda``)."""
    topo = MPHX(**TOPOS["1d"])
    router = make_router(topo, device="cpu")
    seen = []
    route, incidence = router.route, router.incidence

    def spy_route(demands, mode, granularity=8, backend=None):
        seen.append(("route", backend))
        return route(demands, mode, granularity, backend)

    def spy_incidence(demands, mode, backend=None):
        seen.append(("incidence", backend))
        return incidence(demands, mode, backend)

    router.route, router.incidence = spy_route, spy_incidence
    build = lambda t, o: rv.uniform_demands(t, o, device="cpu")  # noqa
    load_sweep(topo, build, mode="adaptive", load_fractions=(0.5, 1.0),
               router=router, sim_backend="torch")
    load_sweep(topo, build, mode="valiant", load_fractions=(0.5,),
               router=router, simulate=True, flow_time_s=200e-6)
    assert seen == [("route", "torch"), ("route", "torch"), ("route", None),
                    ("incidence", None)]
