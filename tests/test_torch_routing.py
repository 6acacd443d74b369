"""The port's MPHX and minimal router against the JAX package's.

(Valiant and adaptive routing: ``tests/test_torch_routing_modes.py``.)

Same topology parameters on both sides; the reference routes with its
numpy backend.  Demand arrays and edge capacities must be equal, the
incidence's ``flow`` and ``edge`` columns equal (the same COO order, which
is the summation order downstream) with ``frac`` within 1e-15, and the
``route_minimal`` loads within 1e-12 of the largest load.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.core.routing_vec import (  # noqa: E402
    VectorizedHyperXRouter as RefRouter,
    neighbor_shift_demands as ref_shift, uniform_demands as ref_uniform)
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import make_router  # noqa: E402
from repro_torch.core.routing_vec import (  # noqa: E402
    neighbor_shift_demands, uniform_demands)

TOPOS = {
    "mphx-2p-8x8": dict(n=2, p=8, dims=(8, 8)),
    "3d": dict(n=1, p=4, dims=(4, 3, 5)),
    # dim 2 trunks 8 links over its 3 neighbours, as mphx-4p-86x9 does
    "trunked": dict(n=4, p=8, dims=(9, 4), links_per_dim=(8, 8)),
}
SCENARIOS = {"uniform": (ref_uniform, uniform_demands),
             "neighbor_shift": (ref_shift, neighbor_shift_demands)}


def setup(topo_name, scenario, load=0.7):
    kw = TOPOS[topo_name]
    ref_topo, topo = RefMPHX(**kw), MPHX(**kw)
    ref_build, build = SCENARIOS[scenario]
    offered = load * topo.nic_bw_gbps
    return (RefRouter(ref_topo, backend="numpy"), ref_build(ref_topo, offered),
            make_router(topo, device="cpu"),
            build(topo, offered, device="cpu"))


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_topology_quantities_match(topo_name):
    ref, port = RefMPHX(**TOPOS[topo_name]), MPHX(**TOPOS[topo_name])
    for attr in ("name", "n_nics", "n_switches", "n_optics", "diameter",
                 "port_gbps", "switches_per_plane", "radix_used"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.avg_hops() == ref.avg_hops()
    assert port.bisection_links() == ref.bisection_links()
    assert port.feasibility() == ref.feasibility()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_demands_and_capacity_equal(topo_name, scenario):
    ref_router, ref_dem, router, dem = setup(topo_name, scenario)
    np.testing.assert_array_equal(dem.src.numpy(), ref_dem.src)
    np.testing.assert_array_equal(dem.dst.numpy(), ref_dem.dst)
    np.testing.assert_array_equal(dem.gbps.numpy(), ref_dem.gbps)
    np.testing.assert_array_equal(router.edge_capacity().numpy(),
                                  ref_router.edge_capacity())
    assert router.mean_switch_hops() == ref_router.mean_switch_hops()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_incidence_has_the_reference_order(topo_name, scenario):
    ref_router, ref_dem, router, dem = setup(topo_name, scenario)
    rf, re, rfr = ref_router.incidence(ref_dem, "minimal")
    f, e, fr = router.incidence(dem, "minimal")
    assert f.dtype == e.dtype == torch.int64 and fr.dtype == torch.float64
    np.testing.assert_array_equal(f.numpy(), rf)
    np.testing.assert_array_equal(e.numpy(), re)
    np.testing.assert_allclose(fr.numpy(), rfr, rtol=0, atol=1e-15)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_route_minimal_loads_match(topo_name, scenario):
    ref_router, ref_dem, router, dem = setup(topo_name, scenario)
    ref_ll = ref_router.route(ref_dem, "minimal")
    ll = router.route(dem, "minimal")
    want = np.asarray(ref_ll.loads)
    np.testing.assert_allclose(ll.loads.numpy(), want, rtol=0,
                               atol=1e-12 * want.max())
    assert abs(ll.max_utilization() - ref_ll.max_utilization()) <= 1e-12
    np.testing.assert_allclose(ll.utilization_array().numpy(),
                               ref_ll.utilization_array(), rtol=0,
                               atol=1e-12)


def test_load_sweep_defaults_match_the_reference():
    """Every parameter the port's ``load_sweep`` shares with the
    reference's has the reference's default (``net``, each package's own
    ``NetParams``, by its fields).  So a call without ``mode`` routes
    adaptively, as the reference does, and returns the reference's rows
    (floats at 1e-9 relative, the rest exactly; the adaptive loads
    themselves are bit-equal, ``tests/test_torch_routing_modes.py``)."""
    import dataclasses
    import inspect

    from repro.core.netsim import load_sweep as ref_load_sweep
    from repro_torch.core.netsim import load_sweep

    ref = inspect.signature(ref_load_sweep).parameters
    port = inspect.signature(load_sweep).parameters
    shared = set(ref) & set(port)
    assert {"mode", "load_fractions", "msg_bytes", "net", "router",
            "simulate", "flow_time_s", "sim_backend"} <= shared
    for name in sorted(shared):
        want, got = ref[name].default, port[name].default
        if name == "net":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, name
    kw = TOPOS["mphx-2p-8x8"]
    topo = MPHX(**kw)
    want = ref_load_sweep(RefMPHX(**kw), ref_shift, backend="numpy")
    got = load_sweep(topo, lambda t, g: neighbor_shift_demands(
        t, g, device="cpu"), router=make_router(topo, device="cpu"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float) and v != 0:
                assert abs(g[k] - v) <= 1e-9 * abs(v), k
            else:
                assert g[k] == v, k
    # adaptive re-routes every level: the rows do not scale linearly
    minimal = ref_load_sweep(RefMPHX(**kw), ref_shift, mode="minimal",
                             backend="numpy")
    assert [r["max_util"] for r in got] != [r["max_util"] for r in minimal]
