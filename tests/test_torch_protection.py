"""The port's fast-reroute protection (``repro_torch.routing.protection``)
against the JAX package's numpy one, on the CPU.

* ``REROUTE_MODES``, ``validate_reroute_mode`` and the constructor's
  checks, with the same messages.
* ``ProtectedRouter`` at 4 and 8 layers and at ``rho=0.5``, on
  mphx-2p-8x8 and dragonfly-small: the undirected edge count,
  ``protect_layer``, ``layer_mask``, every ``layer_hops`` (``-1`` where a
  layer cannot reach), ``connected_layers``, ``layer_edge_counts``,
  ``backup_next_hops`` and ``protection_coverage`` exactly.
* ``local_reroute_loads`` for ``link:0.05``, ``link:0.1,seed:2``,
  ``switch:0.03,seed:1`` and ``link:0.15,seed:4`` (the case that diverts
  into protection layers), and with a redirect budget of 0: loads,
  surviving capacities, injected, delivered, stalled, diverted,
  ``layer_gbps`` and ``n_pulls`` bit for bit.
* ``route_layered`` loads bit for bit; ``FlowIncidence.edge_share`` bit
  for bit; the masked BFS against the reference's ``_masked_hops``.
* The diverted pulls keep no segment blocks in the router's cache.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core.routing_graph import GraphRouter as RefGraphRouter  # noqa
from repro.experiments import sweep as ref_sweep  # noqa: E402
from repro.experiments.scenarios import SCENARIOS as REF_SCENARIOS  # noqa
from repro.routing import protection as ref_prot  # noqa: E402
from repro.sim.failures import degrade_graph as ref_degrade  # noqa: E402
from repro.sim.failures import parse_failure_spec as ref_parse  # noqa
from repro.sim.fairshare import flow_incidence as ref_flow_incidence  # noqa
from repro_torch.convert import demands_from_arrays  # noqa: E402
from repro_torch.core.routing_graph import GraphRouter  # noqa: E402
from repro_torch.experiments import sweep  # noqa: E402
from repro_torch.experiments.scenarios import SCENARIOS  # noqa: E402
from repro_torch.routing import protection  # noqa: E402
from repro_torch.sim.failures import degrade_graph, parse_failure_spec  # noqa
from repro_torch.sim.fairshare import flow_incidence  # noqa: E402

FABRICS = ["mphx-2p-8x8", "dragonfly-small"]
# (layers, rho, seed)
LAYERINGS = [(4, 1.0, 0), (8, 1.0, 0), (4, 0.5, 3)]
REROUTE_SPECS = ["link:0.05", "link:0.1,seed:2", "switch:0.03,seed:1",
                 "link:0.15,seed:4"]


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The pulls are many small ops; under the test runner's parallel
    workers torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64)
                                ).view(np.int64)


def routers(fabric, layers=4, rho=1.0, seed=0):
    ref_t = ref_sweep.SWEEP_TOPOLOGIES[fabric]
    t = sweep.SWEEP_TOPOLOGIES[fabric]
    return (ref_prot.ProtectedRouter(ref_t, n_layers=layers, rho=rho,
                                     seed=seed, backend="numpy"),
            protection.ProtectedRouter(t, n_layers=layers, rho=rho,
                                       seed=seed, device="cpu"))


def uniform(fabric, ref_r, r, load=0.5):
    ref_t = ref_sweep.SWEEP_TOPOLOGIES[fabric]
    t = sweep.SWEEP_TOPOLOGIES[fabric]
    want = REF_SCENARIOS["uniform"].build(ref_t, load * ref_t.nic_bw_gbps,
                                          graph=ref_r.graph)
    got = SCENARIOS["uniform"].build(t, load * t.nic_bw_gbps, graph=r.graph,
                                     device="cpu")
    np.testing.assert_array_equal(bits(got.gbps), bits(want.gbps))
    return want, got


# ------------------------------------------------------------ validation ----


def test_reroute_modes_and_validation_match():
    assert protection.REROUTE_MODES == ref_prot.REROUTE_MODES
    for m in protection.REROUTE_MODES:
        assert protection.validate_reroute_mode(m) == m
    for bad in ("bogus", "", "Local"):
        with pytest.raises(ValueError) as want:
            ref_prot.validate_reroute_mode(bad)
        with pytest.raises(ValueError) as got:
            protection.validate_reroute_mode(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(n_layers=1), dict(rho=0.0),
                                dict(rho=1.5)])
def test_constructor_rejects_bad_params_like_the_reference(kw):
    with pytest.raises(ValueError) as want:
        ref_prot.ProtectedRouter(ref_sweep.SWEEP_TOPOLOGIES["mphx-2p-8x8"],
                                 **kw)
    with pytest.raises(ValueError) as got:
        protection.ProtectedRouter(sweep.SWEEP_TOPOLOGIES["mphx-2p-8x8"],
                                   device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_accepts_topology_graph_and_router():
    t = sweep.SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    g = t.build_graph()
    r = GraphRouter(g, device="cpu")
    for src in (g, r):
        p = protection.ProtectedRouter(src, n_layers=3, device="cpu")
        assert p.csr.n_edges == p.layer_mask.shape[1]
    # a router brings its own device and is shared, not copied
    assert protection.ProtectedRouter(r, n_layers=3).router is r
    with pytest.raises(ValueError):
        protection.ProtectedRouter(g, backend="numpy", device="cpu")


# ----------------------------------------------------------- the tables ----


@pytest.mark.parametrize("layers,rho,seed", LAYERINGS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_protection_tables_match(fabric, layers, rho, seed):
    ref_r, r = routers(fabric, layers, rho, seed)
    assert r.n_uedges == ref_r.n_uedges
    assert r.dst_chunk == ref_r.dst_chunk
    np.testing.assert_array_equal(r.protect_layer.numpy(),
                                  ref_r.protect_layer)
    np.testing.assert_array_equal(r.layer_mask.numpy(), ref_r.layer_mask)
    for l in range(layers):
        np.testing.assert_array_equal(r.layer_hops(l).numpy(),
                                      ref_r.layer_hops(l))
    assert r.connected_layers() == ref_r.connected_layers()
    np.testing.assert_array_equal(r.layer_edge_counts().numpy(),
                                  ref_r.layer_edge_counts())
    np.testing.assert_array_equal(r.backup_next_hops().numpy(),
                                  ref_r.backup_next_hops())
    assert r.protection_coverage() == ref_r.protection_coverage()
    if rho < 1.0:
        assert r.protection_coverage() < 1.0


@pytest.mark.parametrize("dst_chunk", [1, 5])
def test_backup_table_over_small_chunks_matches(dst_chunk):
    ref_t = ref_sweep.SWEEP_TOPOLOGIES["dragonfly-small"]
    t = sweep.SWEEP_TOPOLOGIES["dragonfly-small"]
    ref_r = ref_prot.ProtectedRouter(ref_t, n_layers=4, rho=0.5, seed=1,
                                     backend="numpy", dst_chunk=dst_chunk)
    r = protection.ProtectedRouter(t, n_layers=4, rho=0.5, seed=1,
                                   dst_chunk=dst_chunk, device="cpu")
    np.testing.assert_array_equal(r.backup_next_hops().numpy(),
                                  ref_r.backup_next_hops())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_hops_match_the_reference(seed):
    ref_r, r = routers("dragonfly-small")
    keep = np.random.default_rng(seed).random(r.csr.n_edges) < 0.3
    want = ref_prot._masked_hops(ref_r.csr, keep)
    got = r.csr.masked_hops(torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any()


# ------------------------------------------------------- local reroute ----


def reroute_pair(fabric, spec, layers=4, max_redirects=None):
    ref_r, r = routers(fabric, layers)
    want_d, got_d = uniform(fabric, ref_r, r)
    want = ref_r.local_reroute_loads(
        want_d, ref_degrade(ref_r.graph, ref_parse(spec)),
        max_redirects=max_redirects)
    got = r.local_reroute_loads(
        got_d, degrade_graph(r.graph, parse_failure_spec(spec)),
        max_redirects=max_redirects)
    return want, got, r


def assert_same_reroute(got, want):
    np.testing.assert_array_equal(bits(got.loads), bits(want.loads))
    np.testing.assert_array_equal(bits(got.cap_deg), bits(want.cap_deg))
    for k in ("injected_gbps", "delivered_gbps", "stalled_gbps",
              "diverted_gbps"):
        assert bits(getattr(got, k)) == bits(getattr(want, k)), k
    np.testing.assert_array_equal(bits(got.layer_gbps),
                                  bits(want.layer_gbps))
    assert got.n_pulls == want.n_pulls
    assert got.info() == want.info()
    assert got.saturation_throughput() == want.saturation_throughput()


@pytest.mark.parametrize("spec", REROUTE_SPECS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_local_reroute_matches_bit_for_bit(fabric, spec):
    want, got, r = reroute_pair(fabric, spec)
    assert_same_reroute(got, want)
    assert got.conservation_residual < 1e-9
    # no load lands on a failed element
    surv, _, _ = r._degraded_state(
        degrade_graph(r.graph, parse_failure_spec(spec)))
    assert bool((got.loads[surv <= 0] == 0).all())
    if fabric == "mphx-2p-8x8" and spec == "link:0.15,seed:4":
        assert got.diverted_gbps > 0      # the case that diverts


@pytest.mark.parametrize("max_redirects", [0, 1])
def test_local_reroute_redirect_budget_matches(max_redirects):
    want, got, _ = reroute_pair("mphx-2p-8x8", "link:0.15,seed:4", 8,
                                max_redirects)
    assert_same_reroute(got, want)


def test_diverted_pulls_keep_no_blocks(monkeypatch):
    """A diverted pull over its live columns builds its blocks for the
    call: the router's cache keeps the chunk widths alone."""
    calls = []
    block = GraphRouter._block

    def spy(self, col, C, cache=True):
        calls.append((C, cache))
        return block(self, col, C, cache)

    monkeypatch.setattr(GraphRouter, "_block", spy)
    _, got, r = reroute_pair("mphx-2p-8x8", "link:0.15,seed:4")
    assert got.diverted_gbps > 0
    n_dests = r.csr.n_switches
    chunks = {min(r.dst_chunk, n_dests - lo)
              for lo in range(0, n_dests, r.dst_chunk)}
    assert {C for _, C in r.router._blocks} == chunks
    narrowed = {C for C, cache in calls if not cache}
    assert narrowed and not narrowed & chunks


# ---------------------------------------------------- layered multipath ----


@pytest.mark.parametrize("layers,rho,seed", LAYERINGS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_route_layered_matches_bit_for_bit(fabric, layers, rho, seed):
    ref_r, r = routers(fabric, layers, rho, seed)
    want_d, got_d = uniform(fabric, ref_r, r)
    for flow_seed in (0, 5):
        want = ref_r.route_layered(want_d, seed=flow_seed)
        got = r.route_layered(got_d, seed=flow_seed)
        np.testing.assert_array_equal(bits(got.loads), bits(want.loads))


# ------------------------------------------------------------ edge_share ----


@pytest.mark.parametrize("spec", ["link:0.05", "switch:0.03,seed:1"])
@pytest.mark.parametrize("fabric", FABRICS)
def test_edge_share_matches_bit_for_bit(fabric, spec):
    ref_t = ref_sweep.SWEEP_TOPOLOGIES[fabric]
    t = sweep.SWEEP_TOPOLOGIES[fabric]
    ref_r = RefGraphRouter(ref_t, backend="numpy")
    r = GraphRouter(t, device="cpu")
    dem = REF_SCENARIOS["uniform"].build(ref_t, ref_t.nic_bw_gbps,
                                         graph=ref_r.graph)
    want_inc = ref_flow_incidence(ref_r, dem, "minimal")
    got_inc = flow_incidence(r, demands_from_arrays(
        dem.src, dem.dst, dem.gbps, device="cpu"), "minimal")
    dg = ref_degrade(ref_r.graph, ref_parse(spec))
    edges = np.array([e for e, (u, v) in enumerate(zip(
        ref_r.csr.src.tolist(), ref_r.csr.dst.tolist()))
        if (min(u, v), max(u, v)) in set(dg.fully_failed_edges)
        or u in dg.failed_switches or v in dg.failed_switches],
        dtype=np.int64)
    for sel in (edges, np.arange(0, ref_r.csr.n_edges, 3)):
        want = want_inc.edge_share(sel)
        got = got_inc.edge_share(torch.from_numpy(sel))
        np.testing.assert_array_equal(bits(got), bits(want))
    assert float(got.max()) <= 1.0
