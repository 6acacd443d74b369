"""The port's water-filling against the JAX package's solvers.

``repro_torch.sim.fairshare.max_min_rates`` on the CPU (``backend="torch"``,
the plain versions, and ``backend="cuda"``, whose wrappers take the plain
versions for CPU tensors) against the reference's ``numpy``, ``jax`` and
``pallas`` backends (Pallas in interpret mode, on the small cells only, as
``tests/test_fairshare_golden.py`` runs it), against
``tests/golden/fairshare_golden.json`` (its three array cells, the
valiant ``hotspot_valiant`` among them, with their measured-FCT rows at
1e-9 relative), all at ``1e-9 * scale``.
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
from repro.sim.fairshare import (  # noqa: E402
    FlowIncidence as RefIncidence, flow_incidence as ref_flow_incidence,
    max_min_rates as ref_max_min_rates)
from repro_torch.convert import incidence_from_arrays  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import make_router  # noqa: E402
from repro_torch.core.routing_vec import (  # noqa: E402
    hotspot_demands, neighbor_shift_demands, uniform_demands)
from repro_torch.kernels.segment_fairshare import make_plan  # noqa: E402
from repro_torch.sim.events import simulate_demands  # noqa: E402
from repro_torch.sim.fairshare import (  # noqa: E402
    SolveProblem, _compress_edges, flow_incidence, max_min_rates)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fairshare_golden.json")
BACKENDS = ("torch", "cuda")
TOPOS = {"mphx-2p-8x8": dict(n=2, p=8, dims=(8, 8)),
         "trunked": dict(n=4, p=8, dims=(9, 4), links_per_dim=(8, 8))}
SCENARIOS = {"uniform": (ref_uniform, uniform_demands),
             "neighbor_shift": (ref_shift, neighbor_shift_demands)}
LOADS = (0.5, 1.2)
# interpret-mode Pallas is cheap only on the small flow sets
PALLAS_CELLS = {("mphx-2p-8x8", "neighbor_shift"), ("trunked",
                                                    "neighbor_shift")}


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def cell(topo_name, scenario, load):
    kw = TOPOS[topo_name]
    ref_topo, topo = RefMPHX(**kw), MPHX(**kw)
    ref_build, build = SCENARIOS[scenario]
    offered = load * topo.nic_bw_gbps
    ref_router = ref_make_router(ref_topo, backend="numpy")
    ref_dem = ref_build(ref_topo, offered)
    router = make_router(topo, device="cpu")
    dem = build(topo, offered, device="cpu")
    return (ref_flow_incidence(ref_router, ref_dem), ref_dem.gbps,
            flow_incidence(router, dem), dem.gbps)


def as_port(ref_inc):
    return incidence_from_arrays(ref_inc.flow, ref_inc.edge, ref_inc.frac,
                                 ref_inc.n_flows, ref_inc.capacity,
                                 device="cpu")


@pytest.mark.parametrize("load", LOADS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_cells_match_reference_backends(topo_name, scenario, load):
    ref_inc, ref_caps, inc, caps = cell(topo_name, scenario, load)
    scale = max(float(ref_caps.max()), 1.0)
    refs = {b: ref_max_min_rates(ref_inc, ref_caps, backend=b)
            for b in ("numpy", "jax")}
    if (topo_name, scenario) in PALLAS_CELLS:
        refs["pallas"] = ref_max_min_rates(ref_inc, ref_caps,
                                           backend="pallas")
    for backend in BACKENDS:
        got = max_min_rates(inc, caps, backend=backend, device="cpu")
        assert got.dtype == torch.float64
        for name, want in refs.items():
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-9 * scale,
                                       err_msg=f"{backend} vs {name}")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_incidence_reductions_match_reference(topo_name, scenario):
    ref_inc, ref_caps, inc, caps = cell(topo_name, scenario, 0.7)
    for backend in BACKENDS:
        np.testing.assert_array_equal(
            inc.bottleneck_gbps(backend).numpy(), ref_inc.bottleneck_gbps())
        np.testing.assert_allclose(inc.switch_hops(backend).numpy(),
                                   ref_inc.switch_hops(), rtol=1e-15)
        want = ref_inc.loads(ref_caps)
        np.testing.assert_allclose(inc.loads(caps, backend).numpy(), want,
                                   rtol=0, atol=1e-12 * want.max())


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


# the golden's array cells: builder and routing mode
GOLDEN_CELLS = {"uniform": (uniform_demands, "minimal"),
                "neighbor_shift": (neighbor_shift_demands, "minimal"),
                "hotspot_valiant": (hotspot_demands, "valiant")}


@pytest.mark.parametrize("scenario", sorted(GOLDEN_CELLS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_cells(golden, scenario, backend):
    """Each array cell of the golden at both loads: exact incidence
    sizes, rates and link loads at ``1e-9 * scale``, and the measured-FCT
    row through the event loop (floats at 1e-9 relative, integers
    exact)."""
    cell_rec = golden["cells"][f"array/mphx-2p-8x8/{scenario}"]
    build, mode = GOLDEN_CELLS[scenario]
    assert cell_rec["mode"] == mode
    topo = MPHX(**TOPOS["mphx-2p-8x8"])
    router = make_router(topo, device="cpu")
    for load_key, want in cell_rec["loads"].items():
        dem = build(topo, float(load_key) * topo.nic_bw_gbps, device="cpu")
        inc = flow_incidence(router, dem, mode, backend)
        assert (inc.n_flows, inc.n_edges, inc.nnz) == (
            want["n_flows"], want["n_edges"], want["nnz"])
        scale = max(float(dem.gbps.max()), 1.0)
        rates = max_min_rates(inc, dem.gbps, backend=backend, device="cpu")
        np.testing.assert_allclose(rates.numpy(), want["rates_gbps"], rtol=0,
                                   atol=1e-9 * scale)
        golden_loads = np.zeros(inc.n_edges)
        for e, v in want["link_loads_gbps_nonzero"].items():
            golden_loads[int(e)] = v
        np.testing.assert_allclose(inc.loads(rates, backend).numpy(),
                                   golden_loads, rtol=0, atol=1e-9 * scale)
        row = simulate_demands(router, dem, golden["flow_time_s"], mode=mode,
                               backend=backend, inc=inc)
        for k, v in want["fct"].items():
            if isinstance(v, float) and v != 0:
                assert abs(row[k] - v) <= 1e-9 * abs(v), (k, row[k], v)
            else:
                assert row[k] == v, (k, row[k], v)


def random_incidence(seed: int, fixed_shape: bool = False):
    """A random coalesced incidence, finite caps and an active mask (the
    generator of ``tests/test_fairshare_props.py``)."""
    rng = np.random.default_rng(seed)
    if fixed_shape:
        F, E, nnz = 8, 12, 16
    else:
        F, E = int(rng.integers(1, 13)), int(rng.integers(1, 17))
        nnz = int(rng.integers(0, min(F * E, 24) + 1))
    pairs = rng.choice(F * E, size=min(nnz, F * E), replace=False)
    flow, edge = pairs // E, pairs % E
    order = np.argsort(flow, kind="stable")
    inc = RefIncidence(flow=flow[order].astype(np.int64),
                       edge=edge[order].astype(np.int64),
                       frac=rng.uniform(0.1, 2.0, flow.size), n_flows=F,
                       capacity=rng.uniform(0.5, 10.0, E))
    caps = rng.uniform(0.1, 5.0, F)
    active = rng.random(F) < 0.8
    active[0] = True
    return inc, caps, active


@pytest.mark.parametrize("seed", range(12))
def test_random_incidences_match_numpy(seed):
    ref_inc, caps, active = random_incidence(seed)
    want = ref_max_min_rates(ref_inc, caps, active=active, backend="numpy")
    scale = max(float(caps.max()), float(ref_inc.capacity.max()), 1.0)
    for backend in BACKENDS:
        got = max_min_rates(as_port(ref_inc), caps, active=active,
                            backend=backend, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-9 * scale)


@pytest.mark.parametrize("ref_backend", ["jax", "pallas"])
@pytest.mark.parametrize("seed", range(3))
def test_random_incidences_match_jit_backends(ref_backend, seed):
    ref_inc, caps, active = random_incidence(seed, fixed_shape=True)
    want = ref_max_min_rates(ref_inc, caps, active=active,
                             backend=ref_backend)
    got = max_min_rates(as_port(ref_inc), caps, active=active,
                        backend="cuda", device="cpu")
    scale = max(float(caps.max()), 1.0)
    assert np.abs(got.numpy() - want).max() <= 1e-9 * scale


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_flow_takes_min_of_cap_and_bottleneck(backend):
    ref_inc = RefIncidence(flow=np.array([0, 0]), edge=np.array([1, 3]),
                           frac=np.array([1.0, 0.5]), n_flows=1,
                           capacity=np.array([9.0, 4.0, 9.0, 1.0]))
    inc = as_port(ref_inc)
    # bottleneck: min(4.0/1.0, 1.0/0.5) = 2.0
    assert float(inc.bottleneck_gbps(backend)[0]) == 2.0
    assert float(inc.bottleneck_gbps(backend)[0]) == \
        ref_inc.bottleneck_gbps()[0]
    for cap, want in ((10.0, 2.0), (1.5, 1.5)):
        r = max_min_rates(inc, np.array([cap]), backend=backend,
                          device="cpu")
        assert abs(float(r[0]) - want) <= 1e-9


@pytest.mark.parametrize("backend", BACKENDS)
def test_edge_cases(backend):
    # no flows
    empty = incidence_from_arrays([], [], [], 0, np.ones(4), device="cpu")
    assert max_min_rates(empty, np.zeros(0), backend=backend,
                         device="cpu").shape == (0,)
    # flows but no edges (E == 0): every flow fills to its cap
    ref_inc = RefIncidence(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0), 3, np.zeros(0))
    caps = np.array([1.0, 2.5, 0.5])
    got = max_min_rates(as_port(ref_inc), caps, backend=backend,
                        device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), ref_max_min_rates(ref_inc, caps, backend="numpy"))
    # infinite caps are rejected
    one = incidence_from_arrays([0], [0], [1.0], 2, [1.0], device="cpu")
    with pytest.raises(ValueError, match="finite"):
        max_min_rates(one, np.array([1.0, np.inf]), backend=backend,
                      device="cpu")


def test_compress_edges_matches_reference():
    ref_inc, _, _ = random_incidence(123)
    used, edge_c, cap_c = _compress_edges(as_port(ref_inc))
    from repro.sim.fairshare import _compress_edges as ref_compress
    r_used, r_edge_c, r_cap_c = ref_compress(ref_inc)
    np.testing.assert_array_equal(used.numpy(), r_used)
    np.testing.assert_array_equal(edge_c.numpy(), r_edge_c)
    np.testing.assert_array_equal(cap_c.numpy(), r_cap_c)


@pytest.mark.parametrize("seed", [123, 7])
def test_solve_plans_match_a_fresh_sort(seed):
    """The solver's edge plan, derived from the incidence's one sort of
    its edge column, equals a plan sorted afresh from the compressed
    column; ``loads`` reuses the incidence's plan."""
    inc = as_port(random_incidence(seed)[0])
    prob = SolveProblem.build(inc, "cuda")
    fresh = make_plan(prob.edge, prob.n_edges)
    assert prob.edge_plan.ids is prob.edge
    assert prob.edge_plan.num_segments == prob.n_edges
    assert torch.equal(prob.edge_plan.offsets, fresh.offsets)
    assert torch.equal(prob.edge_plan.perm, fresh.perm)
    assert inc.edge_plan() is inc.edge_plan()
    assert torch.equal(inc.edge_plan().perm, fresh.perm)
    assert SolveProblem.build(inc, "torch").edge_plan is None
