"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions, and the slice through them.

Every test here carries the ``cuda`` marker and skips, from the ``cuda``
fixture, where ``torch.cuda.is_available()`` is false.  This file imports
neither ``jax`` nor the JAX package, so it runs on a machine with a card
and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpu.py

Tolerances: sum within ``1e-12 * max|value| * NNZ`` of ``index_add_``
(which adds in no fixed order) and bit for bit equal to its ordered twin
``segment_sum_ordered_ref`` at every lanes count, min exact, two kernel
runs bitwise equal; suite rows at 1e-9 relative with integers exact.
The epoch journal's utilization sums through the kernel within 1e-9 of
the plain path's and the CPU's, with one sum launch for the selection
and one a journaled epoch, and recording bit for bit inert on either
backend.
Sprayed runs (chunk and flowlet split, skewed and dead planes) through
the kernels: per-plane bytes bit for bit and completions within 1e-9 of
the plain path's and the CPU's.
Fast-reroute protection through the kernels (the first-downhill table's
segment min, the pulls' ordered sums): tables and local-reroute loads
bit for bit equal to the plain path's and the CPU's; the failures
suite's rows equal across the three; each recovery phase's wall closed
by one device synchronize.
The adaptive router's load update through the sum kernel bit for bit
equal to the plain path's (the ordered twin) and repeatable; the
valiant incidence coalesced on the card equal to the CPU's, ``frac``
within 1e-15.
RMSNorm and attention: 2e-5 for float32 and 5e-2 for bfloat16
(``tests/test_kernels.py``'s tolerances; the attention kernel keeps its
softmax weights in fp32 where the plain version rounds them to v's
dtype), two kernel runs bitwise equal; the
tensor-core attention kernel (bfloat16, Sq > 1) also gives
``mask_probe``'s exact answer within 2^-8 of each value (one bf16
rounding), and reads empty ring slots holding NaN as zeros; so does the
split-KV decode kernel (Sq = 1, both dtypes), whose launches
``LAUNCHES["flash_attention_decode"]`` counts.
Grouped matmuls: float32 at 2e-5; bfloat16 per output row within 2e-2 of
the row's max |out| (the kernel and the plain version both sum bf16
products in fp32, in another order, and round once), rows the ragged
kernel masks exactly 0, two kernel runs bitwise equal; so at every K
split S of the ``mma`` route, whose S = 1 is the unsplit kernel's bits.  The RG-LRU scan:
bit for bit equal to ``lru_scan_ref`` at every shape, with either width
of moves, with other blocks and rings compiled in, and in a CUDA graph,
two kernel runs bitwise equal.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import make_router  # noqa: E402
from repro_torch.core.routing_vec import (  # noqa: E402
    hotspot_demands, neighbor_shift_demands, uniform_demands)
from repro_torch.experiments.simsuite import run_sim_suite  # noqa: E402
from repro_torch.experiments.scenarios import (  # noqa: E402
    SCENARIOS, get_scenario)
from repro_torch.experiments.sweep import (  # noqa: E402
    SWEEP_TOPOLOGIES, run_sweep_suite)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import rg_lru  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.segment_fairshare import (  # noqa: E402
    LANES, LAUNCHES, make_plan, reset_launch_counts, segment_min,
    segment_min_ref, segment_sum, segment_sum_ordered_ref, segment_sum_ref)
from repro_torch.kernels.segment_fairshare.ops import (  # noqa: E402
    LIBRARY as SEGMENT_LIBRARY)
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.core.planes import SprayConfig  # noqa: E402
from repro_torch.sim.events import FlowSpec, simulate_incidence  # noqa
from repro_torch.sim.spray import flowlet_split, simulate_sprayed  # noqa
from repro_torch.routing.protection import ProtectedRouter  # noqa: E402
from repro_torch.sim import failures  # noqa: E402
from repro_torch.experiments.simsuite import run_failures_suite  # noqa
from repro_torch.sim.fairshare import (SolveProblem,  # noqa: E402
                                       flow_incidence)
from repro_torch.telemetry import (LinkSeriesPolicy,  # noqa: E402
                                   TraceRecorder, recording, validate_trace)

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fairshare_golden.json")
# (nnz, num_segments, highest id + 1); ids past the end are dropped
CASES = {"nnz0": (0, 5, 5), "nnz1": (1, 3, 3), "duplicates": (1000, 37, 37),
         "not-multiple-of-1024": (1025, 2000, 2000),
         "one-segment": (3000, 1, 1), "ids-past-the-end": (2049, 64, 67),
         "zero-segments": (10, 0, 1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_pair(vals, ids, n_seg, plan=None):
    for kern, ref in ((segment_sum, segment_sum_ref),
                      (segment_min, segment_min_ref)):
        got, again = kern(vals, ids, n_seg, plan=plan), \
            kern(vals, ids, n_seg, plan=plan)
        want = ref(vals, ids, n_seg)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if kern is segment_min:
            assert torch.equal(got, want)
        else:
            vmax = float(vals.abs().max()) if vals.numel() else 0.0
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=0,
                                       atol=1e-12 * vmax * vals.numel())


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain(cuda, name):
    nnz, n_seg, hi = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    vals = torch.from_numpy(rng.standard_normal(nnz)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, hi, nnz)).to(cuda)
    reset_launch_counts()
    check_pair(vals, ids, n_seg)
    launched = 2 if n_seg else 0
    assert LAUNCHES == {"segment_sum": launched, "segment_min": launched}
    srt = torch.sort(ids).values
    check_pair(vals, srt, n_seg, make_plan(srt, n_seg, presorted=True))


def test_kernels_at_incidence_shapes(cuda):
    topo = MPHX(n=2, p=8, dims=(8, 8))
    inc = flow_incidence(make_router(topo, device=cuda),
                         uniform_demands(topo, 800.0, device=cuda))
    prob = SolveProblem.build(inc, "cuda")
    check_pair(inc.frac, prob.edge, prob.n_edges, prob.edge_plan)
    check_pair(inc.frac, inc.flow, inc.n_flows, prob.flow_plan)


def test_plan_on_another_device_raises(cuda):
    vals = torch.ones(4, dtype=torch.float64, device=cuda)
    ids = torch.zeros(4, dtype=torch.int64, device=cuda)
    plan = make_plan(ids, 2)
    on_cpu = dataclasses.replace(plan, offsets=plan.offsets.cpu())
    with pytest.raises(ValueError, match="plan tensors"):
        segment_sum(vals, ids, 2, plan=on_cpu)


def test_suite_through_kernels_matches_plain_and_cpu(cuda, tmp_path):
    kw = dict(topo_names=["mphx-2p-8x8"],
              scenario_names=["uniform", "neighbor_shift"],
              load_fractions=(0.5, 0.9))
    reset_launch_counts()
    runs = {"cuda": run_sim_suite(str(tmp_path / "a"), sim_backend="cuda",
                                  device=cuda, **kw)}
    assert LAUNCHES["segment_sum"] > 0 and LAUNCHES["segment_min"] > 0
    runs["torch"] = run_sim_suite(str(tmp_path / "b"), sim_backend="torch",
                                  device=cuda, **kw)
    runs["cpu"] = run_sim_suite(str(tmp_path / "c"), sim_backend="torch",
                                device="cpu", **kw)
    for other in ("torch", "cpu"):
        for a, b in zip(runs["cuda"]["rows"], runs[other]["rows"]):
            for k, v in a.items():
                if k in ("sim_wall_s", "max_abs_util_diff"):
                    continue
                if isinstance(v, float) and v != 0:
                    assert abs(b[k] - v) <= 1e-9 * abs(v), (other, k)
                else:
                    assert b[k] == v, (other, k)


def test_staggered_golden_on_gpu(cuda):
    with open(GOLDEN) as f:
        rec = json.load(f)["staggered"]
    topo = MPHX(n=2, p=8, dims=(8, 8))
    inc = flow_incidence(make_router(topo, device=cuda),
                         neighbor_shift_demands(topo, 800.0, device=cuda))
    res = simulate_incidence(inc, rec["size_bytes"], rec["rate_caps_gbps"],
                             start_s=rec["start_s"], backend="cuda",
                             device=cuda)
    assert res.n_epochs == rec["n_epochs"]
    makespan = rec["makespan_s"]
    np.testing.assert_allclose(res.finish_s.cpu().numpy(), rec["finish_s"],
                               rtol=0, atol=1e-9 * makespan)
    assert abs(res.makespan_s - makespan) <= 1e-9 * makespan


def traced_staggered(device, backend, policy=None):
    """The golden staggered trace under a flight recorder: ``(recorder,
    result, segment_sum launches)``; ``policy`` None runs unrecorded."""
    with open(GOLDEN) as f:
        rec = json.load(f)["staggered"]
    topo = MPHX(n=2, p=8, dims=(8, 8))
    inc = flow_incidence(make_router(topo, device=device),
                         neighbor_shift_demands(topo, 800.0, device=device))

    def run():
        return simulate_incidence(inc, rec["size_bytes"],
                                  rec["rate_caps_gbps"],
                                  start_s=rec["start_s"], backend=backend,
                                  device=device)

    reset_launch_counts()
    if policy is None:
        return None, run(), LAUNCHES["segment_sum"]
    tracer = TraceRecorder(link_policy=policy)
    with recording(tracer):
        res = run()
    return tracer, res, LAUNCHES["segment_sum"]


@pytest.mark.parametrize("max_epochs", [4096, 16])
def test_epoch_journal_kernel_matches_plain_and_cpu(cuda, max_epochs):
    """The journal's utilization sums through the kernel against the
    plain path on the card and the CPU's journal; beside the unrecorded
    run's launches, one sum for the link selection and one a journaled
    epoch (none past ``max_epochs``)."""
    pol = LinkSeriesPolicy(max_epochs=max_epochs)
    runs = {"cuda": traced_staggered(cuda, "cuda", pol),
            "torch": traced_staggered(cuda, "torch", pol),
            "cpu": traced_staggered("cpu", "torch", pol)}
    _, plain, launches = traced_staggered(cuda, "cuda")
    tracer, res, traced_launches = runs["cuda"]
    rows = min(res.n_epochs, max_epochs)
    assert traced_launches - launches == 1 + rows
    j = tracer.journals[0]
    assert len(j["t_s"]) == rows
    assert j["dropped_epochs"] == res.n_epochs - rows
    scale = res.makespan_s
    for other in ("torch", "cpu"):
        o = runs[other][0].journals[0]
        assert [(e["ph"], e["name"]) for e in tracer.events] ==             [(e["ph"], e["name"]) for e in runs[other][0].events]
        for key in ("edge_ids", "active_flows", "dropped_epochs"):
            assert j[key] == o[key], (other, key)
        for key in ("t_s", "dt_s"):
            np.testing.assert_allclose(j[key], o[key], rtol=0,
                                       atol=1e-9 * scale)
        np.testing.assert_allclose(np.asarray(j["util"]),
                                   np.asarray(o["util"]), rtol=0, atol=1e-9)
    assert validate_trace(tracer.to_json()) == []


@pytest.mark.parametrize("backend", ("cuda", "torch"))
@pytest.mark.parametrize("topo_name", ["mphx-2p-8x8", "mphx-2p-16x16"])
def test_link_selection_on_the_card_matches_the_cpu(cuda, topo_name,
                                                    backend):
    """Uniform loads tie exactly on many edges; the card's selection
    ranks them by id as the CPU's does (entry-order sums)."""
    topo = SWEEP_TOPOLOGIES[topo_name]
    picks = []
    for dev in (cuda, "cpu"):
        dem = uniform_demands(topo, 800.0, device=dev)
        inc = flow_incidence(make_router(topo, device=dev), dem)
        picks.append(LinkSeriesPolicy().select(inc, dem.gbps, backend))
    np.testing.assert_array_equal(picks[0], picks[1])


@pytest.mark.parametrize("backend", ("cuda", "torch"))
def test_recording_is_inert_on_the_card(cuda, backend):
    _, plain, _ = traced_staggered(cuda, backend)
    for pol in (LinkSeriesPolicy(), LinkSeriesPolicy(max_epochs=3)):
        _, res, _ = traced_staggered(cuda, backend, pol)
        for name in ("finish_s", "fct_s", "edge_bytes"):
            a, b = getattr(res, name), getattr(plain, name)
            assert torch.equal(a.view(torch.int64), b.view(torch.int64)), \
                name
        assert (res.n_epochs, res.waterfill_rounds) == \
            (plain.n_epochs, plain.waterfill_rounds)


# CASES, and segment counts that leave the last warp part-filled at
# lanes below 32 (groups before and past the last segment in one warp)
LANE_CASES = {**CASES, "part-warp-101": (300, 101, 101),
              "part-warp-333": (3000, 333, 333),
              "part-warp-77": (150, 77, 77)}


def lane_case(name, cuda):
    nnz, n_seg, hi = LANE_CASES[name]
    rng = np.random.default_rng(sorted(LANE_CASES).index(name))
    vals = torch.from_numpy(rng.standard_normal(nnz)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, hi, nnz)).to(cuda)
    srt = torch.sort(ids).values
    return vals, ((ids, False), (srt, True)), n_seg


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_segment_sum_kernel_equals_ordered_twin(cuda, name, lanes):
    """The sum kernel, forced to each lanes count through its plan, gives
    its ordered twin's bits, permuted and presorted."""
    vals, columns, n_seg = lane_case(name, cuda)
    for ids, presorted in columns:
        plan = dataclasses.replace(
            make_plan(ids, n_seg, presorted=presorted), lanes=lanes)
        got = segment_sum(vals, ids, n_seg, plan=plan)
        want = segment_sum_ordered_ref(vals, plan)
        torch.cuda.synchronize()
        assert got.shape == (n_seg,)
        assert torch.equal(got, want), (name, lanes, presorted)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_segment_min_kernel_equals_plain_at_each_lanes(cuda, name, lanes):
    vals, columns, n_seg = lane_case(name, cuda)
    for ids, presorted in columns:
        plan = dataclasses.replace(
            make_plan(ids, n_seg, presorted=presorted), lanes=lanes)
        got = segment_min(vals, ids, n_seg, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, segment_min_ref(vals, ids, n_seg)), \
            (name, lanes, presorted)


def test_segment_entry_points_refuse_other_lanes(cuda):
    """A lanes count with no kernel instance launches nothing and returns
    cudaErrorInvalidValue (1)."""
    vals = torch.ones(8, dtype=torch.float64, device=cuda)
    plan = make_plan(torch.zeros(8, dtype=torch.int64, device=cuda), 2,
                     presorted=True)
    out = torch.full((2,), -1.0, dtype=torch.float64, device=cuda)
    for entry in ("segment_sum_f64", "segment_min_f64"):
        for lanes in (0, 3, 64):
            rc = SEGMENT_LIBRARY.function(entry)(
                vals.data_ptr(), None, plan.offsets.data_ptr(), 2, lanes,
                cuda.index or 0, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert rc == 1, (entry, lanes)
    torch.cuda.synchronize()
    assert bool((out == -1.0).all())


@pytest.mark.parametrize("kernel", ["segment_sum", "segment_min"])
def test_segment_kernels_in_cuda_graph(cuda, kernel):
    """20 calls captured in one CUDA graph and replayed give the bits of
    20 eager calls; capturing counts the 20 launches once."""
    topo = MPHX(n=2, p=8, dims=(8, 8))
    inc = flow_incidence(make_router(topo, device=cuda),
                         uniform_demands(topo, 800.0, device=cuda))
    prob = SolveProblem.build(inc, "cuda")
    fn = {"segment_sum": segment_sum, "segment_min": segment_min}[kernel]
    gen = torch.Generator(device=cuda).manual_seed(11)
    xs = torch.rand(20, inc.nnz, dtype=torch.float64, device=cuda,
                    generator=gen)
    cols = [(prob.edge, prob.n_edges, prob.edge_plan),
            (inc.flow, inc.n_flows, prob.flow_plan)]

    def calls():
        outs = []
        for i in range(20):
            ids, n_seg, plan = cols[i % 2]
            outs.append(fn(xs[i], ids, n_seg, plan=plan))
        return outs

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    reset_launch_counts()
    with torch.cuda.graph(graph):
        outs = calls()
    assert LAUNCHES[kernel] == 20
    for o in outs:
        o.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == 20
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


ROUTING_TOPOS = {"2d": dict(n=2, p=8, dims=(8, 8)),
                 "3d": dict(n=1, p=4, dims=(4, 3, 5)),
                 "1d": dict(n=2, p=4, dims=(8,))}


@pytest.mark.parametrize("build", [uniform_demands, hotspot_demands],
                         ids=["uniform", "hotspot"])
@pytest.mark.parametrize("topo_name", sorted(ROUTING_TOPOS))
def test_adaptive_route_kernel_equals_ordered_twin(cuda, topo_name, build):
    """The adaptive router on the card: its load update through the
    segment-sum kernel (one launch a sub-batch and round) gives the bits
    of the plain path (the kernel's ordered twin), twice, and the bits of
    the CPU's router (which equal the reference's)."""
    topo = MPHX(**ROUTING_TOPOS[topo_name])
    dem = build(topo, 1100.0, device=cuda)
    router = make_router(topo, device=cuda)
    reset_launch_counts()
    first = router.route(dem, "adaptive").loads
    assert LAUNCHES["segment_sum"] == 8 * 8
    again = router.route(dem, "adaptive", backend="cuda").loads
    plain = router.route(dem, "adaptive", backend="torch").loads
    assert LAUNCHES["segment_sum"] == 2 * 8 * 8
    cpu = make_router(topo, device="cpu").route(
        build(topo, 1100.0, device="cpu"), "adaptive").loads
    for other in (again, plain, cpu):
        assert torch.equal(first.cpu().view(torch.int64),
                           other.cpu().view(torch.int64))
    assert float(first.sum()) > 0


@pytest.mark.parametrize("topo_name", sorted(ROUTING_TOPOS))
def test_valiant_incidence_on_the_card_matches_the_cpu(cuda, topo_name):
    """The valiant incidence's coalescing on the card (kernel and ordered
    twin, bitwise equal): the CPU's columns, ``frac`` within 1e-15."""
    topo = MPHX(**ROUTING_TOPOS[topo_name])
    want = make_router(topo, device="cpu").incidence(
        hotspot_demands(topo, 800.0, device="cpu"), "valiant")
    dem = hotspot_demands(topo, 800.0, device=cuda)
    router = make_router(topo, device=cuda)
    reset_launch_counts()
    got = router.incidence(dem, "valiant")
    assert LAUNCHES["segment_sum"] == 1
    plain = router.incidence(dem, "valiant", backend="torch")
    assert LAUNCHES["segment_sum"] == 1
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].numpy(),
                               rtol=0, atol=1e-15)


GRAPH_PRESETS = ["ft3-small", "mpft-2p-small", "dragonfly-small",
                 "dfplus-small"]


@pytest.mark.parametrize("mode", ["minimal", "valiant", "adaptive"])
@pytest.mark.parametrize("scenario", ["uniform", "hotspot",
                                      "bit_complement"])
@pytest.mark.parametrize("preset", GRAPH_PRESETS)
def test_graph_route_kernel_equals_plain_and_cpu(cuda, preset, scenario,
                                                 mode):
    """The graph engine on the card: every ordered sum at one lane a
    segment, so the kernel path, the plain path (the ordered twin and
    ``segment_min_ref``) and the CPU's router give the same bits, twice;
    the plain path launches no kernel."""
    topo = SWEEP_TOPOLOGIES[preset]
    sc = get_scenario(scenario)
    router = make_router(topo, device=cuda)
    dem = sc.build(topo, 1100.0, graph=router.graph, device=cuda)
    reset_launch_counts()
    first = router.route(dem, mode).loads
    assert LAUNCHES["segment_sum"] > 0
    assert (LAUNCHES["segment_min"] > 0) == (mode == "adaptive")
    again = router.route(dem, mode, backend="cuda").loads
    launched = dict(LAUNCHES)
    plain = router.route(dem, mode, backend="torch").loads
    assert LAUNCHES == launched
    cpu_router = make_router(topo, device="cpu")
    cpu = cpu_router.route(sc.build(topo, 1100.0, graph=cpu_router.graph,
                                    device="cpu"), mode).loads
    for other in (again, plain, cpu):
        assert torch.equal(first.cpu().view(torch.int64),
                           other.cpu().view(torch.int64))
    assert float(first.sum()) > 0


@pytest.mark.parametrize("preset", ["ft3-small", "dragonfly-small"])
def test_segment_kernels_at_the_graph_row_scatter_shapes(cuda, preset):
    """#1 and #2 at the graph engine's (E, C) block shapes: the pull's
    scatter by ``dst`` (carried-in values first in each bin), the
    denominators and the bottleneck max by ``src``.  At one lane a
    segment the sum is ``index_add_``'s sequential bits on the CPU (and
    the twin's on the card); at the default lanes the kernel equals its
    twin.  The max through negation equals ``scatter_reduce_`` amax,
    empty bins -inf."""
    topo = SWEEP_TOPOLOGIES[preset]
    router = make_router(topo, device=cuda)
    S, E = router.csr.n_switches, router.csr.n_edges
    rng = np.random.default_rng(11)
    for C in (1, 7, 30):
        n = S * C
        for col in ("dst", "src"):
            ids, plan = router._block(col, C)
            assert plan.lanes == 1 and plan.ids is ids
            vals = torch.from_numpy(rng.random(ids.numel())
                                    * 10.0 ** rng.integers(-3, 3,
                                                           ids.numel())
                                    ).to(cuda)
            got = segment_sum(vals, ids, n, plan=plan)
            cpu = segment_sum_ref(vals.cpu(), ids.cpu(), n)
            assert torch.equal(got.cpu().view(torch.int64),
                               cpu.view(torch.int64))
            assert torch.equal(got, segment_sum_ordered_ref(vals, plan))
            wide = make_plan(ids, n)
            assert torch.equal(segment_sum(vals, ids, n, plan=wide),
                               segment_sum_ordered_ref(vals, wide))
            if col == "src":
                mask = torch.from_numpy(rng.random(E * C) < 0.4).to(cuda)
                cand = torch.where(mask, vals, -torch.inf)
                got_max = router._row_max(cand.view(E, C), "cuda")
                want = torch.full((n,), -torch.inf, dtype=torch.float64)
                want.scatter_reduce_(0, ids.cpu(), cand.cpu(), "amax")
                assert torch.equal(got_max.reshape(-1).cpu(), want)
                assert torch.equal(got_max,
                                   router._row_max(cand.view(E, C), "torch"))


@pytest.mark.parametrize("preset", GRAPH_PRESETS)
def test_graph_incidence_on_the_card_matches_the_cpu(cuda, preset):
    topo = SWEEP_TOPOLOGIES[preset]
    sc = get_scenario("hotspot")
    router = make_router(topo, device=cuda)
    got = router.incidence(sc.build(topo, 800.0, graph=router.graph,
                                    device=cuda))
    plain = router.incidence(sc.build(topo, 800.0, graph=router.graph,
                                      device=cuda), backend="torch")
    cpu_router = make_router(topo, device="cpu")
    want = cpu_router.incidence(sc.build(topo, 800.0,
                                         graph=cpu_router.graph,
                                         device="cpu"))
    for a, b, c in zip(got, plain, want):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), c)


def test_default_sim_suite_through_kernels_matches_plain(cuda, tmp_path):
    """``--suite sim``'s defaults (mphx-2p-8x8, dragonfly-small) on the
    card, the measured collectives included: kernel and plain rows equal
    (floats at 1e-9 relative)."""
    rows = {}
    for backend in ("cuda", "torch"):
        payload = run_sim_suite(str(tmp_path / backend), sim_backend=backend,
                                device=cuda)
        rows[backend] = [r for r in payload["rows"] if not r.get("skipped")]
    assert {r["engine"] for r in rows["cuda"]} == {"array", "graph"}
    assert len(rows["cuda"]) == len(rows["torch"]) == 18
    assert sum(r["kind"] == "collective" for r in rows["cuda"]) == 6
    for a, b in zip(rows["cuda"], rows["torch"]):
        for k, v in a.items():
            if k in ("sim_wall_s", "max_abs_util_diff"):
                continue
            if isinstance(v, float) and v != 0:
                assert abs(b[k] - v) <= 1e-9 * abs(v), (k, v, b[k])
            else:
                assert b[k] == v, (k, v, b[k])


# (granularity, n_planes, plane_skew) of the sprayed runs on the card
SPRAYS = {"chunk": ("chunk", 4, None),
          "chunk-skew-dead": ("chunk", 4, [1.0, 1.5, 1.0, float("inf")]),
          "flowlet-dead": ("flowlet", 4, [1.0, 1.0, 1.0, float("inf")])}


def spray_workload(n_switches: int, F: int = 200, seed: int = 7):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_switches, F)
    dst = (src + rng.integers(1, n_switches, F)) % n_switches
    size = rng.uniform(0.2, 1.0, F) * (1 << 24)
    start = rng.uniform(0.0, 200e-6, F)
    return [FlowSpec(int(a), int(b), float(c), float(d))
            for a, b, c, d in zip(src, dst, size, start)]


@pytest.mark.parametrize("spray_name", sorted(SPRAYS))
@pytest.mark.parametrize("fabric", ["mphx-2p-8x8", "dragonfly-small"])
def test_simulate_sprayed_kernel_matches_plain_and_cpu(cuda, fabric,
                                                        spray_name):
    """A sprayed run through the kernels, on the plain path on the card
    and on the CPU: per-plane bytes and stalls bit for bit, completions
    within 1e-9 relative; the sum kernel launched (a sprayed run takes
    no bottleneck, so no min)."""
    topo = SWEEP_TOPOLOGIES[fabric]
    granularity, n, skew = SPRAYS[spray_name]
    flows = spray_workload(topo.build_graph().n_switches)
    runs = {}
    for name, dev, backend in (("cuda", cuda, "cuda"), ("torch", cuda,
                                                        "torch"),
                               ("cpu", "cpu", "torch")):
        reset_launch_counts()
        runs[name] = simulate_sprayed(
            topo, flows, cfg=SprayConfig(n_planes=n), plane_skew=skew,
            granularity=granularity, flowlet_bytes=1 << 16, backend=backend,
            device=dev)
        if name == "cuda":
            assert LAUNCHES["segment_sum"] > 0
    a = runs["cuda"]
    assert a.completion_s.is_cuda
    for other in ("torch", "cpu"):
        b = runs[other]
        assert torch.equal(a.per_plane_bytes.cpu().view(torch.int64),
                           b.per_plane_bytes.cpu().view(torch.int64))
        assert torch.equal(a.stalled.cpu(), b.stalled.cpu())
        want = b.completion_s.cpu()
        np.testing.assert_allclose(a.completion_s.cpu().numpy(),
                                   want.numpy(), rtol=1e-9, atol=0)


def test_incidence_on_its_card_keeps_its_plans(cuda):
    """An entry point's ``device`` resolves a bare ``cuda`` to the current
    card's index, so ``inc.to`` of an incidence on that card is the
    incidence itself, with the plans it built, and the planes of a
    sprayed run and the loads of a sweep sort its columns once."""
    topo = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    inc = flow_incidence(make_router(topo, device="cuda"),
                         neighbor_shift_demands(topo, 800.0, device="cuda"))
    plan = inc.flow_plan("cuda")
    for dev in (None, "cuda", cuda, torch.device(
            "cuda", torch.cuda.current_device())):
        assert resolve_device(dev) == inc.device
        assert inc.to(resolve_device(dev)) is inc
    assert inc.to(resolve_device("cuda")).flow_plan("cuda") is plan
    assert inc.to("cpu") is not inc


@pytest.mark.parametrize("seed", [0, 2**63 + 5])
def test_flowlet_split_on_the_card_is_the_cpus(cuda, seed):
    """The flowlet hash in int64 on the card and the bins' one-lane sum
    through the kernel and its twin: the CPU's bits."""
    sizes = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 4e6, 500))
    alive = [True, False, True, True]
    want = flowlet_split(sizes, 4, 4096, seed=seed, alive=alive,
                         backend="torch")
    reset_launch_counts()
    for backend in ("cuda", "torch"):
        got = flowlet_split(sizes.to(cuda), 4, 4096, seed=seed, alive=alive,
                            backend=backend)
        assert torch.equal(got[0].cpu().view(torch.int64),
                           want[0].view(torch.int64))
        assert torch.equal(got[1].cpu(), want[1])
    assert LAUNCHES["segment_sum"] == 1


def test_sweep_suite_through_kernels_matches_plain(cuda, tmp_path):
    """``--suite sweep`` on the card: kernel and plain paths give the
    same rows (floats at 1e-9 relative, adaptive's bit for bit), and the
    CPU's rows (the same tolerances; adaptive's ``max_util`` bit for
    bit).  Each scenario's adaptive loads at full injection: the CPU's
    bits."""
    kw = dict(topo_names=["mphx-2p-8x8"], load_fractions=(0.5, 1.0),
              simulate=True)
    reset_launch_counts()
    runs = {"cuda": run_sweep_suite(str(tmp_path / "a"), sim_backend="cuda",
                                    device=cuda, **kw)}
    assert LAUNCHES["segment_sum"] > 0 and LAUNCHES["segment_min"] > 0
    runs["torch"] = run_sweep_suite(str(tmp_path / "b"), sim_backend="torch",
                                    device=cuda, **kw)
    runs["cpu"] = run_sweep_suite(str(tmp_path / "c"), sim_backend="torch",
                                  device="cpu", **kw)
    for other in ("torch", "cpu"):
        assert len(runs["cuda"]["rows"]) == len(runs[other]["rows"])
        for a, b in zip(runs["cuda"]["rows"], runs[other]["rows"]):
            for k, v in a.items():
                if k in ("sweep_wall_s", "device", "device_name"):
                    continue
                if a.get("mode") == "adaptive" and (other == "torch"
                                                    or k == "max_util"):
                    assert b[k] == v, (other, k)
                elif isinstance(v, float) and v != 0:
                    assert abs(b[k] - v) <= 1e-9 * abs(v), (other, k)
                else:
                    assert b[k] == v, (other, k)
    topo = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    router = {d: make_router(topo, device=d) for d in (cuda, "cpu")}
    for name in SCENARIOS:
        sc = get_scenario(name)
        got, want = (router[d].route(sc.build(topo, topo.nic_bw_gbps,
                                              device=d), "adaptive").loads
                     for d in (cuda, "cpu"))
        assert torch.equal(got.cpu().view(torch.int64),
                           want.view(torch.int64)), name


TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


def check_twice(kernel, plain, *args, **kw):
    """Kernel == plain within TOL of the dtype; two runs bitwise equal."""
    got, again = kernel(*args, **kw), kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = TOL[got.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)


# RMSNorm row widths: every route (narrow below 1,024, the register route
# at the models' widths, the loop where no even split exists: 8,200) and
# ragged edges; row counts from one row to a ragged 4,097
RMSNORM_WIDTHS = [1, 7, 128, 1000, 1024, 2560, 4096, 5120, 6144, 7168, 8192,
                  8200]
RMSNORM_ROWS = [1, 3, 4, 8, 4097]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 16), (7, 64), (33, 1000), (5, 13),
                                 (4096, 4096), (9, 8192)]
                         + [(n, d) for d in RMSNORM_WIDTHS
                            for n in RMSNORM_ROWS])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, n, d):
    gen = torch.Generator(device=cuda).manual_seed(n * d)
    x = torch.randn(n, d, device=cuda, generator=gen).to(dtype)
    scale = torch.randn(d, device=cuda, generator=gen).to(dtype)
    rn.reset_launch_counts()
    check_twice(rn.rmsnorm, rn.rmsnorm_ref, x, scale, 1e-6)
    assert rn.LAUNCHES["rmsnorm"] == 2


@pytest.mark.parametrize("pad", [0, 3, 8])
def test_rmsnorm_kernel_reads_strided_rows(cuda, pad):
    """Rows of a wider buffer (a prefill batch's last positions), with
    vector loads (pad 0, 8) and without (pad 3)."""
    gen = torch.Generator(device=cuda).manual_seed(pad)
    big = torch.randn(6, 4096 + pad, device=cuda, generator=gen)
    x = big.bfloat16()[:, :4096]
    s = torch.randn(4096, device=cuda, generator=gen).bfloat16()
    check_twice(rn.rmsnorm, rn.rmsnorm_ref, x, s, 1e-6)
    assert rn.rmsnorm(x, s).is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", RMSNORM_WIDTHS)
def test_rmsnorm_kernel_unaligned_and_strided_views(cuda, dtype, d):
    """``x[:, 1:]`` of a (N, D + 1) buffer (rows and pointer off 16 bytes:
    scalar loads) and every other row of a (2N, D) buffer (a row stride
    of 2D: vector loads where D allows) against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    s = torch.randn(d, device=cuda, generator=gen).to(dtype)
    buf = torch.randn(5, d + 1, device=cuda, generator=gen).to(dtype)
    check_twice(rn.rmsnorm, rn.rmsnorm_ref, buf[:, 1:], s, 1e-6)
    rows = torch.randn(10, d, device=cuda, generator=gen).to(dtype)[::2]
    check_twice(rn.rmsnorm, rn.rmsnorm_ref, rows, s, 1e-6)


@pytest.mark.parametrize("d", [128, 2560, 4096, 6144, 8200])
def test_rmsnorm_kernel_in_cuda_graph(cuda, d):
    """20 calls captured in one CUDA graph and replayed give the bits of
    20 eager calls; capturing counts the 20 launches once."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    xs = torch.randn(20, 4, d, device=cuda, generator=gen).bfloat16()
    s = torch.randn(d, device=cuda, generator=gen).bfloat16()
    eager = [rn.rmsnorm(xs[i], s, 1e-6) for i in range(20)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rn.rmsnorm(xs[0], s, 1e-6)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    rn.reset_launch_counts()
    with torch.cuda.graph(graph):
        outs = [rn.rmsnorm(xs[i], s, 1e-6) for i in range(20)]
    assert rn.LAUNCHES["rmsnorm"] == 20
    for o in outs:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rmsnorm"] == 20
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


def test_rmsnorm_kernel_on_side_stream(cuda):
    """On a side stream the launch is ordered after that stream's work:
    x is written on the side stream behind a ~10 ms spin, so a kernel on
    any other stream would read it unwritten."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    src = torch.randn(4096, 4096, device=cuda, generator=gen).bfloat16()
    s = torch.randn(4096, device=cuda, generator=gen).bfloat16()
    want = rn.rmsnorm_ref(src, s, 1e-6)
    x = torch.zeros_like(src)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        x.copy_(src)
        got = rn.rmsnorm(x, s, 1e-6)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, rn.rmsnorm(src, s, 1e-6))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=5e-2,
                               rtol=5e-2)


def test_rmsnorm_launches_counted_exactly(cuda):
    """One count per launch, none for a CPU call, an empty call or a call
    that raises."""
    x = torch.randn(4, 4096, device=cuda).bfloat16()
    s = torch.ones(4096, device=cuda).bfloat16()
    rn.reset_launch_counts()
    for _ in range(7):
        rn.rmsnorm(x, s)
    rn.rmsnorm(x.cpu(), s.cpu())
    rn.rmsnorm(x[:0], s)
    with pytest.raises(TypeError):
        rn.rmsnorm(x, s.float())
    assert rn.LAUNCHES["rmsnorm"] == 7


@pytest.mark.parametrize("name,route,vecs,d", [
    ("uneven-split", "register", 2, 4104),       # 513 vectors
    ("part-warp", "register", 8, 3072),          # 48 threads, not warps
    ("over-launch-bound", "register", 1, 8192),  # 1,024 threads
    ("vecs-not-an-instance", "register", 3, 3072),
    ("no-vecs", "register", 0, 4096),
    ("loop-with-vecs", "loop", 1, 4096),
    ("unknown-route", None, 0, 4096),
])
def test_rmsnorm_entry_point_refuses_bad_plans(cuda, name, route, vecs, d):
    """A plan that does not fit the call returns cudaErrorInvalidValue
    and launches nothing: out keeps its bits."""
    x = torch.randn(4, d, device=cuda).bfloat16()
    s = torch.ones(d, device=cuda).bfloat16()
    out = torch.full_like(x, 7.0)
    word = rn.ops.LAUNCH_WORD.pack(
        dtype=1, route=rn.ops.ROUTE_CODES[route] if route else 3, vecs=vecs,
        device=x.device.index, d=d)
    with pytest.raises(RuntimeError, match="invalid argument"):
        rn.ops.LIBRARY.call(
            "rmsnorm", "rmsnorm_forward", x.data_ptr(), s.data_ptr(),
            out.data_ptr(), 4, d, 1e-6, word,
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())


def ring_positions(cap, written, device):
    kv_pos = torch.full((cap,), -1, dtype=torch.int32)
    for p in range(written):
        kv_pos[p % cap] = p
    return kv_pos.to(device)


# B, Sq, K, G, Skv, Dh, q positions, kv positions (None: right-aligned
# contiguous), window
ATTN_CASES = {
    "prefill-gqa-ragged": (2, 100, 2, 4, 100, 64, None, None, None),
    "prefill-mha-long-rows": (1, 300, 4, 1, 300, 128, None, None, None),
    "prefill-gqa-1024-rows": (1, 256, 2, 4, 256, 128, None, None, None),
    "mqa-window": (2, 80, 1, 8, 80, 16, None, None, 8),
    "cross-ragged": (1, 33, 2, 1, 77, 128, None, None, None),
    "decode-ring-empty": (4, 1, 4, 8, 70, 128, [40], (70, 41), None),
    "decode-ring-wrapped": (2, 1, 2, 4, 64, 64, [150], (64, 151), 16),
    # recurrentgemma-2b's local attention: head dim 256 over one KV head
    # of 10 queries; a prefill long enough for the long-run tile with the
    # window binding, and decode over a wrapped ring
    "dh256-prefill-window": (1, 200, 1, 10, 200, 256, None, None, 64),
    "dh256-prefill-ragged": (2, 45, 1, 10, 45, 256, None, None, None),
    "dh256-decode-ring-wrapped": (2, 1, 1, 10, 64, 256, [150], (64, 151),
                                  64),
    # bf16 calls with Sq > 1 take the tensor-core kernel: every head dim,
    # Sq and Skv not multiples of 64, G = 6 and G = 10 (a 64-row tile
    # ends part-way through a position's group), binding windows
    "tc-cross-ragged-dh16": (2, 70, 2, 2, 130, 16, None, None, None),
    "tc-g6-window-dh32": (1, 150, 2, 6, 150, 32, None, None, 40),
    "tc-g10-ragged-dh64": (1, 130, 1, 10, 161, 64, None, None, None),
    "tc-g6-ragged-dh128": (2, 97, 2, 6, 161, 128, None, None, None),
    "tc-g10-window-dh256": (1, 300, 1, 10, 300, 256, None, None, 100),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_attention_kernel_matches_plain(cuda, dtype, name):
    B, Sq, K, G, Skv, Dh, qp, ring, window = ATTN_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    q = torch.randn(B, Sq, K, G, Dh, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(B, Skv, K, Dh, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    if ring is None:
        q_pos, kv_pos = fa.right_aligned_positions(Sq, Skv, cuda)
    else:
        q_pos = torch.tensor(qp, dtype=torch.int32, device=cuda)
        kv_pos = ring_positions(*ring, cuda)
    fa.reset_launch_counts()
    check_twice(fa.flash_attention, fa.attention_ref, q, k, v, q_pos, kv_pos,
                causal=True, window=window)
    assert fa.LAUNCHES["flash_attention"] == 2
    # the tensor-core kernel serves bf16 with Sq > 1 and nothing else, the
    # decode kernel every call with Sq = 1
    tc = dtype == torch.bfloat16 and Sq > 1
    assert fa.LAUNCHES["flash_attention_tc"] == (2 if tc else 0)
    assert fa.LAUNCHES["flash_attention_decode"] == (2 if Sq == 1 else 0)


def test_flash_attention_kernel_layout_bidirectional(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, 2, 48, 64, device=cuda, generator=gen)
    k, v = (torch.randn(1, 2, 80, 64, device=cuda, generator=gen)
            for _ in range(2))
    got = fa.flash_attention_kernel_layout(q, k, v, causal=False)
    cpu = fa.flash_attention_kernel_layout(q.cpu(), k.cpu(), v.cpu(),
                                           causal=False)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_flash_attention_kernel_layout_bidirectional_bf16(cuda):
    """The kernel layout without the causal mask on the tensor-core
    kernel: every row attends every key, so each tile is whole."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 4, 48, 64, device=cuda, generator=gen).bfloat16()
    k, v = (torch.randn(1, 2, 80, 64, device=cuda, generator=gen).bfloat16()
            for _ in range(2))
    fa.reset_launch_counts()
    got = fa.flash_attention_kernel_layout(q, k, v, causal=False)
    cpu = fa.flash_attention_kernel_layout(q.cpu(), k.cpu(), v.cpu(),
                                           causal=False)
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_tc": 1,
                           "flash_attention_decode": 0}
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               cpu.float().numpy(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_flash_attention_prefill_over_ring_slice_with_nan_slots(cuda, dtype,
                                                                dh):
    """A 90-position prefill over a 150-slot ring whose k and v are slices
    of one stacked buffer (read in place), the 60 empty slots holding NaN:
    the kernels read them as zeros (the tensor-core kernel's copies
    zero-fill them), which is what the plain version gives on zeros."""
    B, Sq, K, G, cap = 2, 90, 2, 3, 150
    gen = torch.Generator(device=cuda).manual_seed(dh)
    q = torch.randn(B, Sq, K, G, dh, device=cuda, generator=gen).to(dtype)
    buf = torch.randn(2, B, cap, K, dh, device=cuda, generator=gen).to(dtype)
    zeros = buf.clone()
    buf[:, :, Sq:] = float("nan")
    zeros[:, :, Sq:] = 0
    q_pos = torch.arange(Sq, dtype=torch.int32, device=cuda)
    kv_pos = ring_positions(cap, Sq, cuda)
    fa.reset_launch_counts()
    got = fa.flash_attention(q, buf[0], buf[1], q_pos, kv_pos)
    again = fa.flash_attention(q, buf[0], buf[1], q_pos, kv_pos)
    want = fa.attention_ref(q, zeros[0], zeros[1], q_pos, kv_pos)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    assert fa.LAUNCHES["flash_attention_tc"] == \
        (2 if dtype == torch.bfloat16 else 0)


# B, K, G, Dh, q positions, kv positions (None: arange(Sq)), window
PROBE_CASES = {
    "causal-gqa-dh128": (2, 2, 8, 128, 300, None, None),
    "window-g6-dh128": (1, 2, 6, 128, 500, None, 130),
    "ring-nan-slots-dh64": (2, 1, 4, 64, 200, (260, 200), None),
    "window-g10-dh256": (1, 1, 10, 256, 400, None, 256),
    "cross-ragged-dh16": (1, 2, 2, 16, 70, (130, 130), None),
    "window-dh32": (2, 2, 3, 32, 333, None, 64),
}


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_flash_attention_mask_probe(cuda, name):
    """``mask_probe``'s exact answer through the tensor-core kernel: the
    kernel sums exact weights of 1 in fp32 and rounds acc / l once to
    bf16, so each value lies within 2^-8 of its own size (0 exactly
    where the answer is 0).  A dropped 64-key tile or one leaked key
    moves a value by far more.  Empty ring slots hold NaN."""
    B, K, G, Dh, Sq, ring, window = PROBE_CASES[name]
    q_pos = torch.arange(Sq, dtype=torch.int32, device=cuda)
    if ring is None:
        kv_pos = q_pos.clone()
    else:
        kv_pos = ring_positions(ring[0], ring[1], cuda)
        q_pos = q_pos + (ring[1] - Sq)
    q, k, v, want = fa.mask_probe(B, K, G, Dh, q_pos, kv_pos, causal=True,
                                  window=window)
    empty = kv_pos < 0
    k[:, empty] = float("nan")
    v[:, empty] = float("nan")
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, q_pos, kv_pos, causal=True,
                             window=window)
    assert fa.LAUNCHES["flash_attention_tc"] == 1
    gap = (got.double() - want[None, :, None, None, :]).abs()
    assert bool((gap <= 2.0 ** -8 * want[None, :, None, None, :]).all()), \
        float(gap.max())


# the split-KV decode kernel: B, K, G, Dh, cache slots, positions written,
# window; the query sits at the last position written
DECODE_CASES = {
    "one-slot": (2, 2, 4, 64, 1, 1, None),
    "shorter-than-a-split": (3, 2, 6, 128, 20, 20, None),
    "ring-empty-g8": (4, 4, 8, 128, 1057, 1040, None),
    "g1-wrapped-window": (2, 4, 1, 32, 100, 250, 40),
    "g20-ring-empty": (2, 1, 20, 64, 300, 170, None),
    "g6-one-split-per-key": (1, 2, 6, 16, 33, 33, None),
    # recurrentgemma-2b's window decode: one KV head of 10 queries at head
    # dim 256 over its wrapped 2,048-slot ring, one block per split
    "recurrentgemma-window": (1, 1, 10, 256, 2048, 2312, 2048),
    # mixtral-8x22b's: 8 KV heads of 6 over its wrapped 4,096-slot ring
    "mixtral-window": (1, 8, 6, 128, 4096, 4168, 4096),
}


def decode_inputs(cuda, name, dtype, dh=None):
    B, K, G, Dh, cap, written, window = DECODE_CASES[name]
    Dh = dh or Dh
    gen = torch.Generator(device=cuda).manual_seed(len(name) + Dh)
    q = torch.randn(B, 1, K, G, Dh, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(B, cap, K, Dh, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    q_pos = torch.tensor([written - 1], dtype=torch.int32, device=cuda)
    return q, k, v, q_pos, ring_positions(cap, written, cuda), window


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_flash_attention_decode_kernel_matches_plain(cuda, dtype, name):
    """Against the plain version, two calls the same bits, one
    ``flash_attention_decode`` launch a call."""
    q, k, v, q_pos, kv_pos, window = decode_inputs(cuda, name, dtype)
    fa.reset_launch_counts()
    check_twice(fa.flash_attention, fa.attention_ref, q, k, v, q_pos, kv_pos,
                causal=True, window=window)
    assert fa.LAUNCHES == {"flash_attention": 2, "flash_attention_tc": 0,
                           "flash_attention_decode": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", list(fa.ops.HEAD_DIMS))
def test_flash_attention_decode_every_head_dim_with_nan_slots(cuda, dtype,
                                                              dh):
    """Decode over a ring of k and v slices of one stacked buffer (read in
    place), its empty slots holding NaN: the kernel's copies zero-fill
    them, which is what the plain version gives on zeros."""
    B, K, G, cap, written = 2, 2, 6, 200, 130
    gen = torch.Generator(device=cuda).manual_seed(dh)
    q = torch.randn(B, 1, K, G, dh, device=cuda, generator=gen).to(dtype)
    buf = torch.randn(2, B, cap, K, dh, device=cuda, generator=gen).to(dtype)
    zeros = buf.clone()
    buf[:, :, written:] = float("nan")
    zeros[:, :, written:] = 0
    q_pos = torch.tensor([written - 1], dtype=torch.int32, device=cuda)
    kv_pos = ring_positions(cap, written, cuda)
    fa.reset_launch_counts()
    got = fa.flash_attention(q, buf[0], buf[1], q_pos, kv_pos, window=100)
    again = fa.flash_attention(q, buf[0], buf[1], q_pos, kv_pos, window=100)
    want = fa.attention_ref(q, zeros[0], zeros[1], q_pos, kv_pos, window=100)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)
    assert fa.LAUNCHES["flash_attention_decode"] == 2


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_flash_attention_decode_mask_probe(cuda, name):
    """``mask_probe``'s exact answer through the decode kernel in bf16,
    within 2^-8 of each value, empty ring slots holding NaN."""
    B, K, G, Dh, cap, written, window = DECODE_CASES[name]
    q_pos = torch.tensor([written - 1], dtype=torch.int32, device=cuda)
    kv_pos = ring_positions(cap, written, cuda)
    q, k, v, want = fa.mask_probe(B, K, G, Dh, q_pos, kv_pos, causal=True,
                                  window=window)
    empty = kv_pos < 0
    k[:, empty] = float("nan")
    v[:, empty] = float("nan")
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, q_pos, kv_pos, causal=True,
                             window=window)
    assert fa.LAUNCHES["flash_attention_decode"] == 1
    gap = (got.double() - want[None, :, None, None, :]).abs()
    assert bool((gap <= 2.0 ** -8 * want[None, :, None, None, :]).all()), \
        float(gap.max())


def test_flash_attention_decode_row_attending_nothing_is_zero(cuda):
    """Every slot lies after the query's position: zeros, as the twin
    ``attention_decode_split_ref`` gives (the plain version's softmax
    over all -1e30 scores gives the mean of v instead)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 1, 2, 3, 64, device=cuda, generator=gen)
    k, v = (torch.randn(2, 90, 2, 64, device=cuda, generator=gen)
            for _ in range(2))
    q_pos = torch.tensor([4], dtype=torch.int32, device=cuda)
    kv_pos = torch.arange(10, 100, dtype=torch.int32, device=cuda)
    got = fa.flash_attention(q, k, v, q_pos, kv_pos)
    twin = fa.attention_decode_split_ref(q, k, v, q_pos, kv_pos, 2)
    assert torch.equal(got, torch.zeros_like(q))
    assert torch.equal(twin, torch.zeros_like(q))


# each C entry point and a call it must refuse, or (None) take: entry,
# dtype, Sq, then the decode entry's split count
ENTRY_CASES = {
    "simt-takes-float32-prefill": ("simt", torch.float32, 2, None, None),
    "simt-refuses-bf16": ("simt", torch.bfloat16, 2, None,
                          "invalid argument"),
    "simt-refuses-decode": ("simt", torch.float32, 1, None,
                            "invalid argument"),
    # the combine's shared memory: 2 * 6,144 + 1 floats pass 48 KB
    "decode-refuses-6144-splits": ("decode", torch.bfloat16, 1, 6144,
                                   "invalid argument"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_CASES))
def test_flash_attention_entry_points_refuse_other_routes(cuda, name):
    """A C entry point called directly, past the wrapper's route: the
    CUDA-core one takes float32 with Sq > 1 alone, the decode one at most
    kMaxDecodeSplits splits; a refused call raises and launches
    nothing."""
    import ctypes
    entry, dtype, sq, splits, refused = ENTRY_CASES[name]
    B, K, G, Dh, skv = 1, 1, 2, 64, 6144
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(B, sq, K, G, Dh, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(B, skv, K, Dh, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    q_pos = torch.arange(skv - sq, skv, dtype=torch.int32, device=cuda)
    kv_pos = torch.arange(skv, dtype=torch.int32, device=cuda)
    out = torch.zeros_like(q)
    dims = (ctypes.c_int64 * 20)(
        B, sq, skv, K, G, Dh, q.stride(0), q.stride(1), q.stride(3),
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
        v.stride(2), out.stride(0), out.stride(1), out.stride(3), 1, 0)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(), dims, Dh ** -0.5,
            fa.ops._DTYPE_CODES[dtype]]
    if splits is not None:
        ws = torch.empty(B * K * G * splits * (Dh + 2), device=cuda)
        args += [ws.data_ptr(), splits]
    call = lambda: fa.ops.LIBRARY.call(  # noqa: E731
        "flash_attention", fa.ops.ENTRY_POINTS[entry], *args,
        torch.cuda.current_stream().cuda_stream)
    if refused is None:
        call()
        want = fa.attention_ref(q, k, v, q_pos, kv_pos)
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        return
    with pytest.raises(RuntimeError, match=refused):
        call()
    torch.cuda.synchronize()
    assert not bool(out.any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_through_kernels_matches_plain(cuda, dtype):
    """yi-9b's smoke config (2 layers): prefill and decode logits through
    the kernels against the plain path, with 2*L+1 RMSNorm and L attention
    launches per forward pass."""
    cfg = get_config("yi-9b", smoke=True).replace(param_dtype=dtype,
                                                  activation_dtype=dtype)
    kern = get_model(cfg, device=cuda, kernel_backend="cuda")
    plain = get_model(cfg, device=cuda, kernel_backend="torch")
    params = kern.init(seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    rn.reset_launch_counts()
    fa.reset_launch_counts()
    got, caches = kern.prefill(params, tokens, max_len=48)
    assert rn.LAUNCHES["rmsnorm"] == 2 * cfg.n_layers + 1
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    want, pcaches = plain.prefill(params, tokens, max_len=48)
    tol = 2e-5 if dtype == "float32" else 5e-2
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale
    for step in range(4):
        tok = torch.argmax(want, -1)[:, None]
        got, caches = kern.decode_step(params, tok, caches)
        want, pcaches = plain.decode_step(params, tok, pcaches)
        assert float((got - want).abs().max()) <= tol * scale, step
    assert rn.LAUNCHES["rmsnorm"] == 5 * (2 * cfg.n_layers + 1)
    assert fa.LAUNCHES["flash_attention"] == 5 * cfg.n_layers


def row_close(got, want, tol):
    """Each row of ``got`` within ``tol`` of its max |want| (rows of
    ``want`` that are all 0 must be 0 in ``got`` too)."""
    g, w = got.float(), want.float()
    gap = (g - w).abs().amax(dim=-1)
    top = w.abs().amax(dim=-1)
    assert bool((gap <= tol * top).all()), float((gap / top.clamp_min(
        1e-30)).max())


def grouped_inputs(gen, x_shape, w_shape, dtype, device):
    """x standard normal, w scaled by 1/sqrt(K) as the model's init."""
    x = torch.randn(*x_shape, device=device, generator=gen)
    w = torch.randn(*w_shape, device=device, generator=gen) \
        / np.sqrt(w_shape[1])
    return x.to(dtype), w.to(dtype)


# E, M, K, N: decode rows, a single row, the prefill tile's edges, the
# window wave's 1,300 rows, and an N that is not a multiple of 8 (float32
# only: the bfloat16 kernel refuses it).  Then the wgmma route's edges
# (bf16 with M > 64): K below its 64-deep k tile, N past a 256-wide tile
# by one 8-wide column pair, one expert, M one row past its 128-row tile,
# and a K of 16 k tiles that wraps its 4-stage ring four times with a
# 40-wide K tail.
GMM_CASES = {"decode-m2": (8, 2, 256, 384), "one-row": (2, 1, 64, 64),
             "tile-edges": (3, 300, 136, 200), "rows-1300": (2, 1300, 64, 128),
             "small-m-tiles": (2, 33, 64, 72), "unaligned": (4, 50, 40, 30),
             "k-below-tile": (2, 200, 40, 256), "n-264": (2, 130, 64, 264),
             "one-expert": (1, 256, 128, 512), "m-129": (3, 129, 96, 128),
             "deep-k": (2, 192, 1000, 512)}


def gmm_launches(dtype, tile_rows, grouped=0, ragged=0, splitk=0):
    """``gm.LAUNCHES`` after ``grouped`` and ``ragged`` calls whose tiles
    have ``tile_rows`` rows: the bfloat16 ones past 64 rows on wgmma;
    ``splitk`` of them on the mma route with K split."""
    wgmma = dtype == torch.bfloat16 and tile_rows > 64
    return {"grouped_matmul": grouped, "ragged_grouped_matmul": ragged,
            "grouped_matmul_wgmma": (grouped + ragged) if wgmma else 0,
            "grouped_matmul_splitk": splitk}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GMM_CASES))
def test_grouped_matmul_kernel_matches_plain(cuda, dtype, name):
    E, M, K, N = GMM_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    x, w = grouped_inputs(gen, (E, M, K), (E, K, N), dtype, cuda)
    gm.reset_launch_counts()
    if dtype == torch.bfloat16 and N % 8:
        with pytest.raises(ValueError, match="multiples of 8"):
            gm.grouped_matmul(x, w)
        assert gm.LAUNCHES == gmm_launches(dtype, M)
        return
    got, again = gm.grouped_matmul(x, w), gm.grouped_matmul(x, w)
    want = gm.grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    split = gm.ops.call_splits(x, w) > 1
    assert gm.LAUNCHES == gmm_launches(dtype, M, grouped=2,
                                       splitk=2 if split else 0)
    assert torch.equal(got, again)
    assert got.dtype == dtype and got.shape == (E, M, N)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=2e-5, rtol=2e-5)
    else:
        row_close(got, want, 2e-2)


def test_bf16_grouped_matmul_refuses_misaligned_operands(cuda):
    """A contiguous x that starts 2 bytes past a 16-byte boundary."""
    E, M, K, N = 2, 16, 64, 64
    flat = torch.zeros(E * M * K + 1, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(E, M, K)
    w = torch.zeros(E, K, N, dtype=torch.bfloat16, device=cuda)
    gm.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        gm.grouped_matmul(x, w)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gm.ragged_grouped_matmul(x.reshape(E * M, K), w,
                                 torch.tensor([M, M], device=cuda))
    assert gm.LAUNCHES == gmm_launches(torch.bfloat16, M)


# route code, K, splits: an unknown route, and each bf16 route given a K
# that is not a multiple of 8 (TMA's row strides and the 16-byte copies
# need it); then K splits the entry point refuses: one not in 1, 2, 4, 8,
# one that does not divide the 6 K tiles of K = 384, and a split off the
# mma route
GMM_ENTRY_CASES = {"unknown-route": (3, 64, 1), "wgmma-k-12": (2, 12, 1),
                   "mma-k-12": (1, 12, 1), "mma-splits-3": (1, 384, 3),
                   "mma-splits-4-of-6-tiles": (1, 384, 4),
                   "wgmma-splits-2": (2, 384, 2),
                   "f32-splits-2": (0, 384, 2)}


@pytest.mark.parametrize("name", sorted(GMM_ENTRY_CASES))
def test_grouped_matmul_entry_point_refuses_bad_calls(cuda, name):
    """The C entry point called directly, past the wrapper's checks: a
    refused call raises, launches nothing and writes nothing."""
    import ctypes
    route, K, splits = GMM_ENTRY_CASES[name]
    E, M, N = 2, 130, 64
    dtype = torch.float32 if route == 0 else torch.bfloat16
    x = torch.ones(E, M, K, dtype=dtype, device=cuda)
    w = torch.ones(E, K, N, dtype=dtype, device=cuda)
    out = torch.zeros(E, M, N, dtype=dtype, device=cuda)
    ws = torch.zeros(max(splits, 1), E, M, N, device=cuda)
    dims = (ctypes.c_int64 * 7)(0, E, M, K, N, 0, splits)
    with pytest.raises(RuntimeError, match="invalid argument"):
        gm.ops.LIBRARY.call("grouped_matmul", "grouped_matmul_forward",
                            x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            None, ws.data_ptr(), dims, route,
                            torch.cuda.current_device(),
                            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert not bool(out.any()) and not bool(ws.any())


def test_grouped_matmul_occupancy(cuda):
    """The wgmma kernel's 197,696 bytes of shared memory leave room for
    one block on an SM; the mma kernel's 78,848 for 2 (the number the
    split plan's slots rest on: 264 on the H100's 132 SMs, where
    mixtral's decode down takes 2 K splits and its gate/up 1); the
    float32 kernel fits at least one."""
    assert gm.ops.occupancy("wgmma") == 1
    assert gm.ops.occupancy("mma") == 2
    assert gm.ops.occupancy("f32") >= 1
    idx = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    assert gm.ops.slots(idx) == 2 * sms
    if sms == 132:
        assert gm.splits_for(384, 256, gm.ops.slots(idx)) == 2
        assert gm.splits_for(1024, 96, gm.ops.slots(idx)) == 1


# group sizes, ownership block rows, K, N: the reference's four cases
# (tests/test_kernels.py), routed sizes that straddle 128-row blocks, and
# 16-row blocks (the decode tile).  Then the wgmma route's (bf16 with
# block_m > 64): 96- and 192-row blocks, whose 128-row tiles reach into
# the next ownership block (a store of those rows would overwrite it), the
# 192 one with a K that wraps the stage ring; T not a multiple of 128; an
# empty last group.
RAGGED_CASES = {"even": ([64, 64, 64, 64], 32, 32, 16),
                "empty-group": ([128, 0, 64, 64], 32, 32, 16),
                "one-group": ([256, 0, 0, 0], 32, 32, 16),
                "boundaries": ([32, 96, 64, 64], 32, 32, 16),
                "routed": ([300, 17, 0, 211], 128, 64, 96),
                "routed-16": ([45, 3, 80, 0, 22], 16, 72, 128),
                "block-96": ([100, 0, 150, 70], 96, 72, 264),
                "block-192": ([300, 50, 0, 170], 192, 600, 128),
                "t-tail": ([130, 77, 60], 128, 136, 256),
                "empty-last": ([200, 56, 0], 128, 64, 256)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_grouped_matmul_kernel_matches_plain(cuda, dtype, name):
    sizes, block_m, K, N = RAGGED_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    x, w = grouped_inputs(gen, (sum(sizes), K), (len(sizes), K, N), dtype,
                          cuda)
    gs = torch.tensor(sizes, device=cuda)
    gm.reset_launch_counts()
    got = gm.ragged_grouped_matmul(x, w, gs, block_m)
    again = gm.ragged_grouped_matmul(x, w, gs, block_m)
    want = gm.ragged_grouped_matmul_masked_ref(x, w, gs, block_m)
    torch.cuda.synchronize()
    assert gm.LAUNCHES == gmm_launches(dtype, min(block_m, x.shape[0]),
                                       ragged=2)
    assert torch.equal(got, again)
    _, inside = gm.block_owners(gs, x.shape[0], block_m)
    assert bool((got[~inside] == 0).all())
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=2e-5, rtol=2e-5)
    else:
        row_close(got[inside], want[inside], 2e-2)


# the mma route's K split, forced through the private ``_launch``: the
# grouped variant at a decode shape, and the ragged one with routed-16's
# group sizes and 16-row blocks and with an empty group (empty-group's
# sizes, 32-row blocks), all at K = 1,024 (16 K tiles, which every S
# divides)
SPLIT_CASES = {"grouped-decode": ((8, 2, 1024, 384), None, None),
               "ragged-routed-16": ((None, None, 1024, 128),
                                    [45, 3, 80, 0, 22], 16),
               "ragged-empty-group": ((None, None, 1024, 256),
                                      [128, 0, 64, 64], 32)}


def split_call(name, cuda, splits):
    """The case's inputs, a call of ``_launch`` at ``splits`` (None: the
    route's own) and its plain version (the grouped variant's, at a
    forced S, the split twin ``grouped_matmul_split_ref``); the group
    sizes and block rows (None for the grouped variant)."""
    (E, M, K, N), sizes, block_m = SPLIT_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(len(name))
    if sizes is None:
        x, w = grouped_inputs(gen, (E, M, K), (E, K, N), torch.bfloat16,
                              cuda)
        gs = None
        want = (gm.grouped_matmul_ref(x, w) if splits is None
                else gm.grouped_matmul_split_ref(x, w, splits))
    else:
        x, w = grouped_inputs(gen, (sum(sizes), K), (len(sizes), K, N),
                              torch.bfloat16, cuda)
        gs = torch.tensor(sizes, device=cuda, dtype=torch.int32)
        want = gm.ragged_grouped_matmul_masked_ref(x, w, gs, block_m)
    dims = gm.ops._dims(x, w, block_m)
    assert gm.ops.call_route(x, block_m) == "mma"

    def call(s=splits):
        out = torch.empty_like(want)
        gm.ops._launch("grouped_matmul" if gs is None
                       else "ragged_grouped_matmul", x, w, out, gs, dims,
                       "mma", splits=s)
        return out
    return x, w, gs, block_m, call, want


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_grouped_matmul_split_k_matches_plain(cuda, name, splits):
    """Each row within 2e-2 of its max of the plain version at every
    forced S (the grouped variant's: the split twin, which adds the same
    K slices in the same order, and every element within one bf16 step
    of it plus 1e-4 of its row's max), the ragged variant's foreign rows
    exactly 0, two calls the same bits, one split-and-reduce launch
    counted per call at S > 1."""
    x, w, gs, block_m, call, want = split_call(name, cuda, splits)
    gm.reset_launch_counts()
    got, again = call(), call()
    torch.cuda.synchronize()
    ragged = 0 if gs is None else 2
    assert gm.LAUNCHES == gmm_launches(
        torch.bfloat16, 1, grouped=2 - ragged, ragged=ragged,
        splitk=2 if splits > 1 else 0)
    assert torch.equal(got, again)
    if gs is None:
        row_close(got, want, 2e-2)
        ref = want.float()
        rowmax = ref.abs().amax(-1, keepdim=True)
        # one step of bf16 (8 significant bits) at |ref|
        step = 2.0 ** -7 * ref.abs()
        assert bool(((got.float() - ref).abs() <= step + 1e-4 * rowmax)
                    .all())
        return
    _, inside = gm.block_owners(gs, x.shape[0], block_m)
    assert bool((got[~inside] == 0).all())
    row_close(got[inside], want[inside], 2e-2)


def test_grouped_matmul_split_k_refused_before_any_launch(cuda):
    """A forced S that does not divide ceil(K / 64) (4 of K = 384's 6
    tiles), one not in 1, 2, 4, 8, and any S > 1 off the mma route raise
    ``ValueError`` in the wrapper: nothing launched, nothing written."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, w = grouped_inputs(gen, (2, 2, 384), (2, 384, 128), torch.bfloat16,
                          cuda)
    out = torch.zeros(2, 2, 128, dtype=torch.bfloat16, device=cuda)
    dims = gm.ops._dims(x, w, None)
    gm.reset_launch_counts()
    for route, splits in (("mma", 4), ("mma", 3), ("mma", 16),
                          ("wgmma", 2), ("f32", 2)):
        with pytest.raises(ValueError, match="K splits"):
            gm.ops._launch("grouped_matmul", x, w, out, None, dims, route,
                           splits=splits)
    torch.cuda.synchronize()
    assert gm.LAUNCHES == gmm_launches(torch.bfloat16, 2)
    assert not bool(out.any())


def test_grouped_matmul_split_1_is_the_auto_route_where_it_gives_1(cuda):
    """At a decode shape where the plan gives S = 1 (24 blocks over 4 K
    tiles), the forced S = 1 call equals the wrapper's bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, w = grouped_inputs(gen, (8, 2, 256), (8, 256, 384), torch.bfloat16,
                          cuda)
    assert gm.ops.call_splits(x, w) == 1
    out = torch.empty(8, 2, 384, dtype=torch.bfloat16, device=cuda)
    gm.ops._launch("grouped_matmul", x, w, out, None,
                   gm.ops._dims(x, w, None), "mma", splits=1)
    assert torch.equal(out, gm.grouped_matmul(x, w))


def test_grouped_matmul_split_k_in_a_cuda_graph(cuda):
    """One S = 2 call (its workspace, split kernel and reduction)
    captured in a CUDA graph and replayed twice: the eager call's bits."""
    x, w, gs, block_m, call, want = split_call("grouped-decode", cuda, 2)
    eager = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()                                  # warm-up off the default
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    row_close(eager, want, 2e-2)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_moe_decoder_through_kernels_matches_plain(cuda, arch):
    """An MoE smoke config in float32: prefill and decode logits through
    the kernels against the plain path at 2e-5 of max |logit|, with three
    grouped-matmul launches per MoE layer and forward pass.  kimi's smoke
    heads are 8 wide, below the attention kernel's narrowest (16): the
    test widens them to 16."""
    cfg = get_config(arch, smoke=True)
    if cfg.resolved_head_dim not in fa.ops.HEAD_DIMS:
        cfg = cfg.replace(head_dim=16)
    kern = get_model(cfg, device=cuda, kernel_backend="cuda")
    plain = get_model(cfg, device=cuda, kernel_backend="torch")
    params = kern.init(seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    n_moe = len(params["layers"])
    gm.reset_launch_counts()
    got, caches = kern.prefill(params, tokens, max_len=48)
    want, pcaches = plain.prefill(params, tokens, max_len=48)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale
    for step in range(4):
        tok = torch.argmax(want, -1)[:, None]
        got, caches = kern.decode_step(params, tok, caches)
        want, pcaches = plain.decode_step(params, tok, pcaches)
        assert float((got - want).abs().max()) <= 2e-5 * scale, step
    # float32: no wgmma, no split
    assert gm.LAUNCHES == {"grouped_matmul": 5 * 3 * n_moe,
                           "ragged_grouped_matmul": 0,
                           "grouped_matmul_wgmma": 0,
                           "grouped_matmul_splitk": 0}


# B, S, W: tests/test_kernels.py's lru_scan sweep, ragged widths (a block
# past W, a lone column) and lengths (a stage past S, one step),
# recurrentgemma-2b prefill's shape on the serve path and its window wave's
LRU_CASES = {"1x16x32": (1, 16, 32), "2x75x96": (2, 75, 96),
             "3x128x64": (3, 128, 64), "1x200x48": (1, 200, 48),
             "W1": (3, 40, 1), "W33": (2, 70, 33), "W2576": (2, 90, 2576),
             "S1": (2, 1, 96), "S31": (2, 31, 96), "S33": (2, 33, 96),
             "S1025": (2, 1025, 160),
             "prefill-4x1024x2560": (4, 1024, 2560),
             "window-1x2304x2560": (1, 2304, 2560)}


def lru_inputs(cuda, B, S, W, with_h0=True):
    gen = torch.Generator(device=cuda).manual_seed(B * S * W)
    a = torch.empty(B, S, W, device=cuda).uniform_(0.4, 0.999,
                                                    generator=gen)
    b = torch.randn(B, S, W, device=cuda, generator=gen)
    h0 = torch.randn(B, W, device=cuda, generator=gen) if with_h0 else None
    return a, b, h0


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zero-state"])
@pytest.mark.parametrize("name", sorted(LRU_CASES))
def test_lru_scan_kernel_matches_plain(cuda, name, with_h0):
    """y and h_last bit for bit equal to lru_scan_ref: both do a rounded
    multiply then a rounded add per step, in time order.  Two runs the
    same bits, one launch each."""
    a, b, h0 = lru_inputs(cuda, *LRU_CASES[name], with_h0)
    rg_lru.reset_launch_counts()
    y, h = rg_lru.lru_scan(a, b, h0)
    y2, h2 = rg_lru.lru_scan(a, b, h0)
    wy, wh = rg_lru.lru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert rg_lru.LAUNCHES["lru_scan"] == 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert torch.equal(h, y[:, -1])


def lru_scan_times():
    """``tools/lru_scan_times.py`` as a module (its ``plan_variant``,
    ``entry_call`` and ``build_all``)."""
    import importlib
    import sys
    tools = str(Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module("lru_scan_times")


# blocks and rings other than the kernel's own (32 threads, 4 x 16), each
# under 48 KB a block
LRU_VARIANTS = [(64, 2, 32), (128, 2, 16), (32, 4, 32), (32, 2, 64)]


@pytest.fixture(scope="module")
def lru_variants(tmp_path_factory):
    """A copy of the package compiled with each of LRU_VARIANTS, built
    at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tool = lru_scan_times()
    from grouped_matmul_times import load_package
    root = tmp_path_factory.mktemp("lru_variants")
    src = str(Path(rg_lru.__file__).resolve().parents[3])
    pkgs = {plan: load_package(tool.plan_variant(src, *plan, root=root),
                               "lru_{}x{}x{}_repro_torch".format(*plan),
                               kernel="rg_lru")
            for plan in LRU_VARIANTS}
    tool.build_all(list(pkgs.values()))
    return pkgs


@pytest.mark.parametrize("vec", [4, 1])
@pytest.mark.parametrize("plan", LRU_VARIANTS, ids=str)
@pytest.mark.parametrize("name", ["W2576", "S1025", "prefill-4x1024x2560"])
def test_lru_scan_forced_plans_keep_the_bits(cuda, lru_variants, name, plan,
                                             vec):
    """A block and ring other than the kernel's own, compiled into a copy
    of the package, gives lru_scan_ref's bits through its wrapper and with
    either width of moves forced through the launch word."""
    ops = lru_variants[plan].ops
    assert (ops.THREADS, ops.STAGES, ops.STEPS) == plan != (
        rg_lru.ops.THREADS, rg_lru.ops.STAGES, rg_lru.ops.STEPS)
    a, b, h0 = lru_inputs(cuda, *LRU_CASES[name])
    wy, wh = rg_lru.lru_scan_ref(a, b, h0)
    y, h = lru_variants[plan].lru_scan(a, b, h0)
    y1, h1 = lru_scan_times().entry_call(ops, a, b, h0, vec)
    torch.cuda.synchronize()
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert torch.equal(y1, wy) and torch.equal(h1, wh)


@pytest.mark.parametrize("name", ["W2576", "S1025", "prefill-4x1024x2560"])
def test_lru_scan_4_byte_moves_keep_the_bits(cuda, name):
    """The 4-byte moves, forced through the launch word where the plan
    takes 16-byte ones, give lru_scan_ref's bits; not counted."""
    a, b, h0 = lru_inputs(cuda, *LRU_CASES[name])
    assert rg_lru.ops.call_plan(a, b) == 4
    rg_lru.reset_launch_counts()
    y, h = lru_scan_times().entry_call(rg_lru.ops, a, b, h0, 1)
    wy, wh = rg_lru.lru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert rg_lru.LAUNCHES["lru_scan"] == 0


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_lru_scan_unaligned_inputs_move_4_bytes(cuda, offset):
    """a, b and h0 that start off 16 bytes (views into a larger buffer)
    take 4-byte moves and keep the bits; 16-byte moves refuse them."""
    B, S, W = 2, 300, 256
    gen = torch.Generator(device=cuda).manual_seed(offset)
    buf = torch.empty(2 * B * S * W + B * W + 8, device=cuda).uniform_(
        0.4, 0.999, generator=gen)
    a = buf[offset:offset + B * S * W].view(B, S, W)
    b = buf[B * S * W + 4:2 * B * S * W + 4].view(B, S, W)
    h0 = buf[2 * B * S * W + 4 + offset:][:B * W].view(B, W)
    assert rg_lru.ops.call_plan(a, b) == 1
    y, h = rg_lru.lru_scan(a, b, h0)
    wy, wh = rg_lru.lru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert torch.equal(y, wy) and torch.equal(h, wh)
    with pytest.raises(RuntimeError, match="lru_scan kernel launch failed"):
        lru_scan_times().entry_call(rg_lru.ops, a, b, h0, 4)


@pytest.mark.parametrize("vec,width", [
    (0, 64), (2, 64), (3, 64), (5, 64), (7, 64), (4, 66), (4, 33), (4, 1)])
def test_lru_scan_entry_point_refuses_bad_plans(cuda, vec, width):
    """A width of moves without an instance, or 16-byte moves where W is
    not a multiple of 4: refused with cudaErrorInvalidValue before any
    launch, and not counted."""
    a, b, h0 = lru_inputs(cuda, 2, 40, width)
    rg_lru.reset_launch_counts()
    with pytest.raises(RuntimeError, match="lru_scan kernel launch failed"):
        lru_scan_times().entry_call(rg_lru.ops, a, b, h0, vec)
    assert rg_lru.LAUNCHES["lru_scan"] == 0


@pytest.mark.parametrize("name", ["S1", "W33", "prefill-4x1024x2560"])
def test_lru_scan_kernel_in_cuda_graph(cuda, name):
    """10 scans captured in one CUDA graph and replayed give the bits of
    10 eager calls; capturing counts the 10 launches once."""
    B, S, W = LRU_CASES[name]
    ins = [lru_inputs(cuda, B + i, S, W) for i in range(10)]
    eager = [rg_lru.lru_scan(*args) for args in ins]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rg_lru.lru_scan(*ins[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    rg_lru.reset_launch_counts()
    with torch.cuda.graph(graph):
        outs = [rg_lru.lru_scan(*args) for args in ins]
    assert rg_lru.LAUNCHES["lru_scan"] == 10
    for y, h in outs:
        y.zero_()
        h.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert rg_lru.LAUNCHES["lru_scan"] == 10
    for (y, h), (wy, wh) in zip(outs, eager):
        assert torch.equal(y, wy) and torch.equal(h, wh)


def test_lru_scan_kernel_refuses_strided_inputs(cuda):
    a = torch.rand(2, 8, 32, device=cuda)
    rg_lru.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        rg_lru.lru_scan(a[:, :, :16], a[:, :, :16])
    assert rg_lru.LAUNCHES["lru_scan"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_through_kernels_matches_plain(cuda, dtype):
    """recurrentgemma-2b's smoke config (1 unit of (rec, rec, attn) and 2
    tail rec blocks, an 8-token local window): prefill of a 40-token
    prompt and decode logits through the kernels against the plain path,
    with one lru_scan launch per rec block in prefill and none in decode,
    one attention launch per attention block, 2 RMSNorm launches per
    block and the final one."""
    cfg = get_config("recurrentgemma-2b", smoke=True).replace(
        param_dtype=dtype, activation_dtype=dtype)
    kern = get_model(cfg, device=cuda, kernel_backend="cuda")
    plain = get_model(cfg, device=cuda, kernel_backend="torch")
    params = kern.init(seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    n_rec, n_attn = kern.n_blocks["rec"], kern.n_blocks["attn"]
    for mod in (rn, fa, rg_lru):
        mod.reset_launch_counts()
    got, caches = kern.prefill(params, tokens, max_len=48)
    assert rg_lru.LAUNCHES["lru_scan"] == n_rec == 4
    assert fa.LAUNCHES["flash_attention"] == n_attn == 1
    assert rn.LAUNCHES["rmsnorm"] == 2 * cfg.n_layers + 1
    want, pcaches = plain.prefill(params, tokens, max_len=48)
    tol = 2e-5 if dtype == "float32" else 5e-2
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale
    for step in range(4):
        tok = torch.argmax(want, -1)[:, None]
        got, caches = kern.decode_step(params, tok, caches)
        want, pcaches = plain.decode_step(params, tok, pcaches)
        assert float((got - want).abs().max()) <= tol * scale, step
    assert rg_lru.LAUNCHES["lru_scan"] == n_rec
    assert fa.LAUNCHES["flash_attention"] == 5 * n_attn
    assert rn.LAUNCHES["rmsnorm"] == 5 * (2 * cfg.n_layers + 1)


# ------------------------------------------------------------- failures ----


PROTECTED_FABRIC = "mphx-2p-16x16"
REROUTE_SPECS = ["link:0.15,seed:4", "switch:0.03,seed:1"]


def reroute_routers(cuda):
    topo = SWEEP_TOPOLOGIES[PROTECTED_FABRIC]
    return {name: ProtectedRouter(topo, n_layers=4, backend=backend,
                                  device=dev)
            for name, dev, backend in (("cuda", cuda, "cuda"),
                                       ("torch", cuda, "torch"),
                                       ("cpu", "cpu", "torch"))}


def same_bits(a, b) -> bool:
    return torch.equal(a.cpu().view(torch.int64), b.cpu().view(torch.int64))


def test_protection_tables_through_kernels_equal_plain_and_cpu(cuda):
    """The first-downhill table (a segment min over each (source,
    destination) block) and the backup next-hops through the min kernel,
    on the plain path and on the CPU: equal; the plain path launches
    nothing."""
    prs = reroute_routers(cuda)
    reset_launch_counts()
    tables = [prs["cuda"]._first_downhill_table(l) for l in range(1, 4)]
    assert LAUNCHES["segment_min"] > 0
    launched = dict(LAUNCHES)
    for name in ("torch", "cpu"):
        for l, want in zip(range(1, 4), tables):
            assert torch.equal(prs[name]._first_downhill_table(l).cpu(),
                               want.cpu())
    assert LAUNCHES == launched
    bnh = prs["cuda"].backup_next_hops()
    for name in ("torch", "cpu"):
        assert torch.equal(prs[name].backup_next_hops().cpu(), bnh.cpu())
        assert prs[name].protection_coverage() == \
            prs["cuda"].protection_coverage()


@pytest.mark.parametrize("spec", REROUTE_SPECS)
def test_local_reroute_through_kernels_equals_plain_and_cpu(cuda, spec):
    """``local_reroute_loads`` (pulls with their ECMP denominators and
    row scatters through the sum kernel at one lane a segment, diversions
    into protection layers) bit for bit equal to the plain path's and
    the CPU's, twice; one pull of it alone too."""
    prs = reroute_routers(cuda)
    topo = SWEEP_TOPOLOGIES[PROTECTED_FABRIC]
    out = {}
    for name, pr in prs.items():
        dev = pr.device
        dem = get_scenario("uniform").build(topo, 0.5 * topo.nic_bw_gbps,
                                            graph=pr.graph, device=dev)
        dg = failures.degrade_graph(pr.graph,
                                    failures.parse_failure_spec(spec))
        reset_launch_counts()
        out[name] = pr.local_reroute_loads(dem, dg)
        if name == "cuda":
            assert LAUNCHES["segment_sum"] > 0
            assert same_bits(pr.local_reroute_loads(dem, dg).loads,
                             out[name].loads)
            # one pull alone: delivered and loads
            surv_mult, _, alive = pr._degraded_state(dg)
            dests = torch.arange(16, device=dev)
            inject = torch.rand((256, 16), dtype=torch.float64,
                                device=dev, generator=torch.Generator(
                                    dev).manual_seed(0))
            pulls = []
            for backend in ("cuda", "torch"):
                pr.backend = backend
                loads = torch.zeros(pr.csr.n_edges, dtype=torch.float64,
                                    device=dev)
                d, st, divs = pr._pull(0, dests, inject, surv_mult > 0,
                                       surv_mult, alive, loads)
                pulls.append((d, st, divs, loads))
            pr.backend = "cuda"
            (d1, s1, v1, l1), (d2, s2, v2, l2) = pulls
            assert same_bits(d1, d2) and same_bits(l1, l2) and s1 == s2
            assert v1.keys() == v2.keys()
            assert all(same_bits(v1[k], v2[k]) for k in v1)
        else:
            assert LAUNCHES["segment_sum"] == 0
    want = out["cuda"]
    assert want.conservation_residual < 1e-9
    for name in ("torch", "cpu"):
        got = out[name]
        assert same_bits(got.loads, want.loads)
        for k in ("injected_gbps", "delivered_gbps", "stalled_gbps",
                  "diverted_gbps", "n_pulls"):
            assert getattr(got, k) == getattr(want, k), k
        assert np.array_equal(got.layer_gbps, want.layer_gbps)


def test_failures_suite_through_kernels_equals_plain_and_cpu(cuda, tmp_path):
    """``--suite failures`` at its defaults (mphx-2p-8x8, dragonfly-small;
    link:0.01, link:0.05; uniform; three reroute modes): every column
    but the walls equal on the kernels, the plain path and the CPU."""
    rows = {}
    for name, dev, backend in (("cuda", cuda, "cuda"),
                               ("torch", cuda, "torch"),
                               ("cpu", "cpu", "torch")):
        reset_launch_counts()
        payload = run_failures_suite(str(tmp_path / name),
                                     sim_backend=backend, device=dev)
        if name == "cuda":
            assert LAUNCHES["segment_sum"] > 0
            assert LAUNCHES["segment_min"] > 0
        rows[name] = payload["rows"]
    walls = ("phase_wall_s", "t_offset_s", "sim_wall_s", "time_to_90_s")
    assert len(rows["cuda"]) == 56
    for name in ("torch", "cpu"):
        assert len(rows[name]) == len(rows["cuda"])
        for a, b in zip(rows["cuda"], rows[name]):
            assert {k: v for k, v in a.items() if k not in walls} == \
                {k: v for k, v in b.items() if k not in walls}


@pytest.mark.parametrize("reroute", ["none", "local", "global"])
def test_recovery_walls_end_with_a_device_synchronize(cuda, monkeypatch,
                                                      reroute):
    """Each phase wall of ``recovery_curve`` is closed by one device
    synchronize (the clock read right after it), and there is no other:
    a wall holds its phase's device work, not only the launches.  The
    synchronizing calls torch's sync debug mode sees inside the curve
    (host reads) are counted beside."""
    import time
    import types
    import warnings

    topo = SWEEP_TOPOLOGIES[PROTECTED_FABRIC]
    pr = ProtectedRouter(topo, n_layers=4, device=cuda)
    pr.backup_next_hops()
    spec = failures.parse_failure_spec("link:0.05")

    def build(t, o, g):
        return get_scenario("uniform").build(t, o, graph=g, device=cuda)

    log = []

    def sync(device):
        log.append(("sync", torch.cuda.current_stream(device).query()))
        torch.cuda.synchronize(device)

    def clock():
        log.append(("clock", None))
        return time.perf_counter()

    monkeypatch.setattr(failures, "synchronize", sync)
    monkeypatch.setattr(failures, "time",
                        types.SimpleNamespace(perf_counter=clock))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rows = failures.recovery_curve(
                topo, build, spec, 0.5 * topo.nic_bw_gbps,
                reroute=reroute, protection=pr if reroute != "none"
                else None, device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [i for i, (kind, _) in enumerate(log) if kind == "sync"]
    assert len(syncs) == len(rows) == {"none": 3, "local": 3,
                                       "global": 4}[reroute]
    # every synchronize is followed at once by the clock that ends a wall
    assert all(log[i + 1][0] == "clock" for i in syncs)
    assert sum("synchronizing" in str(w.message) for w in caught) > 0


# ------------------------------------------- co-simulation and serving ----

COSIM_VARIANTS = [("array", "linear"), ("array", "mapped"),
                  ("graph", "linear")]


def cosim_job(arch: str, n_ranks: int):
    from repro_torch.cosim import job_from_model
    from repro_torch.experiments.cosuite import default_mesh

    cfg = get_config(arch)
    return job_from_model(cfg, **default_mesh(arch, n_ranks,
                                              cfg.moe.n_experts))


@pytest.mark.parametrize("engine,placement", COSIM_VARIANTS)
def test_simulate_step_through_kernels_equals_plain(cuda, engine,
                                                    placement):
    """One training step of kimi-k2 and mixtral on 4,096 ranks of
    mphx-2p-16x16 through the kernels (the sprayed water-filling's sums)
    equals the plain path's bit for bit, phase by phase."""
    from repro_torch.cosim import simulate_step

    topo = SWEEP_TOPOLOGIES["mphx-2p-16x16"]
    for arch in ("kimi-k2-1t-a32b", "mixtral-8x22b"):
        job = cosim_job(arch, 4096)
        res = {}
        for backend in ("cuda", "torch"):
            reset_launch_counts()
            res[backend] = simulate_step(
                topo, job, engine=engine, placement=placement,
                backend=backend,
                router=make_router(topo, engine=engine, device=cuda))
            if backend == "cuda":
                assert LAUNCHES["segment_sum"] > 0
        a, b = res["cuda"], res["torch"]
        assert a.comm_s == b.comm_s and a.comm_s > 0
        assert [(p.name, p.steps, p.n_flows, p.comm_s) for p in a.phases] \
            == [(p.name, p.steps, p.n_flows, p.comm_s) for p in b.phases]


def test_tenant_mix_through_kernels_equals_plain(cuda):
    """The serving suite's default tenants on mphx-2p-8x8 through the
    kernels (the water-filling sums; the mix computes no bottleneck, so
    no min) equal the plain path bit for bit, the isolated runs too, and
    the SLO rows."""
    from repro_torch.experiments.servesuite import tenant_specs
    from repro_torch.workload import run_tenant_mix, slo_rows

    topo = SWEEP_TOPOLOGIES["mphx-2p-8x8"]
    specs = tenant_specs(["chat", "burst", "train"])
    mixes = {}
    for backend in ("cuda", "torch"):
        reset_launch_counts()
        mixes[backend] = run_tenant_mix(topo, specs, seed=0,
                                        sim_backend=backend, device=cuda)
        if backend == "cuda":
            assert LAUNCHES["segment_sum"] > 0
    a, b = mixes["cuda"], mixes["torch"]
    assert torch.equal(a.mixed.finish_s, b.mixed.finish_s)
    assert a.mixed.n_epochs == b.mixed.n_epochs > 0
    for name in a.isolated:
        assert torch.equal(a.isolated[name].finish_s,
                           b.isolated[name].finish_s)
    assert slo_rows(a) == slo_rows(b)


def test_serving_suite_on_the_card_is_byte_identical(cuda, tmp_path):
    """Two same-seed ``--suite serving`` runs through the kernels write
    the same ``serving.json``, byte for byte."""
    from repro_torch.experiments.servesuite import run_serving_suite

    for d in ("a", "b"):
        run_serving_suite(str(tmp_path / d), seed=3, duration_ms=50.0,
                          tenant_names=["chat", "burst", "train", "web"],
                          device=cuda)
    a = (tmp_path / "a" / "serving.json").read_bytes()
    assert a == (tmp_path / "b" / "serving.json").read_bytes()
    assert json.loads(a)["params"]["n_rows"] > 0


def test_cosim_walls_end_with_a_device_synchronize(cuda, monkeypatch,
                                                   tmp_path):
    """Each row's ``sim_wall_s`` of ``--suite cosim`` is closed by one
    device synchronize (the clock read right after it), and there is no
    other; the synchronizing calls torch's sync debug mode sees in the
    suite (host reads of the event loops) are counted beside."""
    import time
    import types
    import warnings

    from repro_torch.experiments import cosuite

    log = []

    def sync(device):
        log.append(("sync", torch.cuda.current_stream(device).query()))
        torch.cuda.synchronize(device)

    def clock():
        log.append(("clock", None))
        return time.perf_counter()

    monkeypatch.setattr(cosuite, "synchronize", sync)
    monkeypatch.setattr(cosuite, "time",
                        types.SimpleNamespace(perf_counter=clock))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            payload = cosuite.run_cosim_suite(
                str(tmp_path), config_names=["mixtral-8x22b"],
                topo_names=["mphx-2p-8x8", "ft3-small"], device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rows = payload["rows"]
    syncs = [i for i, (kind, _) in enumerate(log) if kind == "sync"]
    assert len(syncs) == len(rows) == 4
    assert all(log[i + 1][0] == "clock" for i in syncs)
    assert sum("synchronizing" in str(w.message) for w in caught) > 0
