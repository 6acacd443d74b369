"""The port's measured collectives (``sim/collective_sim.py``), the
collective scenarios' chunk schedules and their pieces
(``core/collectives.plane_chunk_count``, ``routing_vec.ring_demands``)
against the JAX package's, on the CPU.

Tolerances: ``plane_chunk_count``, ``ring_demands``, the ring order and
the step flows equal; the collective scenarios' demand rates bit for
bit; ``simulate_collective``'s rows key for key, floats within 1e-9
relative and the rest exactly (its rounding is the reference's), for the
three kinds on ``MPHX(2, 8, (8, 8))`` and dragonfly-small, with the
``spray.*`` counters equal; every measured row within 0.9-5x of its
alpha-beta closed form (``tests/test_sim.py``'s bracket).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core import routing_vec as ref_rv  # noqa: E402
from repro.core.collectives import (  # noqa: E402
    plane_chunk_count as ref_plane_chunk_count)
from repro.core.netsim import make_router as ref_make_router  # noqa: E402
from repro.experiments import scenarios as ref_scenarios  # noqa: E402
from repro.experiments import sweep as ref_sweep  # noqa: E402
from repro.sim import collective_sim as ref_cs  # noqa: E402
from repro.telemetry import collecting as ref_collecting  # noqa: E402
from repro_torch.core import routing_vec as rv  # noqa: E402
from repro_torch.core.collectives import plane_chunk_count  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import make_router  # noqa: E402
from repro_torch.experiments import scenarios  # noqa: E402
from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES  # noqa: E402
from repro_torch.sim import collective_sim as cs  # noqa: E402
from repro_torch.telemetry import collecting  # noqa: E402

FABRICS = ["mphx-2p-8x8", "dragonfly-small"]
KINDS = list(ref_cs.SIM_COLLECTIVES)
COLLECTIVES = [n for n, s in ref_scenarios.SCENARIOS.items()
               if s.kind == "collective"]


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The graph engine's CPU path is thousands of small ops: under the
    test runner's parallel workers torch's thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_row_matches(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float) and v != 0:
            assert abs(got[k] - v) <= 1e-9 * abs(v), (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


def test_plane_chunk_count_matches_the_reference():
    for size in range(1, 600):
        for n in range(1, 9):
            assert plane_chunk_count(size, n) == \
                ref_plane_chunk_count(size, n), (size, n)


@pytest.mark.parametrize("kw", [dict(n=2, p=8, dims=(8, 8)),
                                dict(n=1, p=4, dims=(4, 3, 5)),
                                dict(n=2, p=4, dims=(8,))])
def test_ring_demands_match_the_reference(kw):
    from repro.core.hyperx import MPHX as RefMPHX

    got = rv.ring_demands(MPHX(**kw), 700.0, device="cpu")
    want = ref_rv.ring_demands(RefMPHX(**kw), 700.0)
    assert got.gbps.dtype == torch.float64
    for a in ("src", "dst", "gbps"):
        np.testing.assert_array_equal(getattr(got, a).numpy(),
                                      getattr(want, a))


@pytest.mark.parametrize("fabric", FABRICS + ["ft3-small", "mpft-2p-small"])
def test_ring_participants_and_step_flows_match(fabric):
    topo, ref_topo = SWEEP_TOPOLOGIES[fabric], \
        ref_sweep.SWEEP_TOPOLOGIES[fabric]
    ring = cs.ring_participants(topo)
    want = ref_cs.ring_participants(ref_topo)
    np.testing.assert_array_equal(ring, want)
    assert [(f.src, f.dst, f.size_bytes) for f in cs._step_flows(ring, 5.5)] \
        == [(f.src, f.dst, f.size_bytes)
            for f in ref_cs._step_flows(want, 5.5)]
    got = cs._alltoall_flows(topo, ring, 1 << 20, 3)
    ref = ref_cs._alltoall_flows(ref_topo, want, 1 << 20, 3)
    assert [(f.src, f.dst, f.size_bytes) for f in got] == \
        [(f.src, f.dst, f.size_bytes) for f in ref]


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("fabric", ["mphx-2p-8x8", "mphx-2p-16x16",
                                    "dragonfly-small", "mpft-2p-small"])
def test_collective_scenarios_match_the_reference(fabric, name):
    topo, ref_topo = SWEEP_TOPOLOGIES[fabric], \
        ref_sweep.SWEEP_TOPOLOGIES[fabric]
    sc, ref = scenarios.get_scenario(name), ref_scenarios.get_scenario(name)
    assert (sc.kind, sc.default_mode, sc.description) == \
        (ref.kind, ref.default_mode, ref.description)
    graph = None if isinstance(topo, MPHX) else topo.build_graph()
    ref_graph = None if graph is None else ref_topo.build_graph()
    for load in (0.25, 1.0):
        got = sc.build(topo, load * topo.nic_bw_gbps, graph=graph,
                       device="cpu")
        want = ref.build(ref_topo, load * ref_topo.nic_bw_gbps,
                         graph=ref_graph)
        np.testing.assert_array_equal(got.src.numpy(), want.src)
        np.testing.assert_array_equal(got.dst.numpy(), want.dst)
        np.testing.assert_array_equal(got.gbps.numpy().view(np.int64),
                                      np.asarray(want.gbps).view(np.int64))
    for n in range(1, 9):
        for payload in (1, 1000, 1 << 17, (1 << 20) // 64, 1 << 20):
            assert scenarios._spray_imbalance(n, payload) == \
                ref_scenarios._spray_imbalance(n, payload)
    assert scenarios._ring_size(topo) == ref_scenarios._ring_size(ref_topo)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_simulate_collective_rows_match_the_reference(fabric, kind, backend):
    topo, ref_topo = SWEEP_TOPOLOGIES[fabric], \
        ref_sweep.SWEEP_TOPOLOGIES[fabric]
    ref_router = ref_make_router(ref_topo, backend="numpy")
    router = make_router(topo, device="cpu")
    for payload in (1 << 20, 3 * 2**20 + 7):
        with ref_collecting() as ref_mx:
            want = ref_cs.simulate_collective(ref_topo, kind, payload,
                                              router=ref_router)
        with collecting() as mx:
            got = cs.simulate_collective(topo, kind, payload, router=router,
                                         backend=backend)
        assert_row_matches(got, want)
        counters = mx.snapshot()["counters"]
        ref_counters = ref_mx.snapshot()["counters"]
        spray_keys = [k for k in ref_counters if k.startswith("spray.")]
        assert spray_keys == ["spray.plane_sims"]
        assert {k: counters[k] for k in spray_keys} == \
            {k: ref_counters[k] for k in spray_keys}
        assert 0.9 <= got["measured_over_analytic"] <= 5.0, got


def test_simulate_collective_builds_its_router_on_the_device():
    topo = MPHX(n=2, p=8, dims=(8, 8))
    row = cs.simulate_collective(topo, "allgather_ring", 1 << 20,
                                 device="cpu")
    want = ref_cs.simulate_collective(
        ref_sweep.SWEEP_TOPOLOGIES["mphx-2p-8x8"], "allgather_ring", 1 << 20)
    assert_row_matches(row, want)


def test_collective_sim_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective 'bcast'"):
        cs.simulate_collective(MPHX(n=2, p=8, dims=(8, 8)), "bcast", 1 << 20,
                               device="cpu")
    assert cs.SIM_COLLECTIVES == ref_cs.SIM_COLLECTIVES
