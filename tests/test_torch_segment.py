"""The port's segment reductions against the JAX package's.

The plain PyTorch versions (and the wrappers, which take them for CPU
tensors) are held against ``repro.kernels.segment_fairshare``'s
``segment_sum_ref`` / ``segment_min_ref`` and against its Pallas kernels
in interpret mode under x64.  Tolerances: sum within
``1e-12 * max|value| * NNZ`` (the summation order differs), min exact.
The segment plans the CUDA kernels read are checked here by replaying
them in Python, and the sum kernel's ordered twin
(``segment_sum_ordered_ref``, its order of additions at each lanes
count) against the references and, bit for bit, against a
left-to-right loop and its own 32-lane order; the kernels themselves run
only on a GPU (``tests/test_torch_gpu.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_fairshare import (  # noqa: E402
    segment_min as pallas_segment_min, segment_min_ref as jax_min_ref,
    segment_sum as pallas_segment_sum, segment_sum_ref as jax_sum_ref)
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import make_router  # noqa: E402
from repro_torch.core.routing_vec import (  # noqa: E402
    neighbor_shift_demands, uniform_demands)
from repro_torch.kernels.segment_fairshare import (  # noqa: E402
    LANES, LAUNCHES, lanes_for, make_plan, reset_launch_counts,
    segment_min, segment_min_ref, segment_sum, segment_sum_ordered_ref,
    segment_sum_ref)
from repro_torch.kernels.segment_fairshare.ops import (  # noqa: E402
    check_inputs)
from repro_torch.sim.fairshare import (  # noqa: E402
    SolveProblem, flow_incidence)


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


# (nnz, num_segments, lowest id, highest id + 1); ids at or past
# num_segments are dropped, as the Pallas kernel drops its padding
CASES = {
    "nnz0": (0, 5, 0, 5),
    "nnz1": (1, 1, 0, 1),
    "nnz1-empty-segments": (1, 3, 0, 3),
    "duplicates": (1000, 37, 0, 37),
    "not-multiple-of-1024": (1025, 2000, 0, 2000),
    "one-segment": (3000, 1, 0, 1),
    "ids-past-the-end": (2049, 64, 0, 67),
    "zero-segments": (10, 0, 0, 1),
}


def make_case(name):
    nnz, n_seg, lo, hi = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return rng.standard_normal(nnz), rng.integers(lo, hi, nnz), n_seg


def sum_tol(vals) -> float:
    return 1e-12 * (np.abs(vals).max() if vals.size else 0.0) * vals.size


def jax_refs(vals, ids, n_seg):
    with jax.enable_x64(True):
        v, i = jnp.asarray(vals), jnp.asarray(ids)
        return {
            "ref": (np.asarray(jax_sum_ref(v, i, n_seg)),
                    np.asarray(jax_min_ref(v, i, n_seg))),
            "pallas": (np.asarray(pallas_segment_sum(v, i, n_seg)),
                       np.asarray(pallas_segment_min(v, i, n_seg))),
        }


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("port", ["plain", "wrapper"])
def test_matches_jax_ref_and_pallas(name, port):
    vals, ids, n_seg = make_case(name)
    if port == "plain":
        fsum, fmin = segment_sum_ref, segment_min_ref
    else:
        fsum, fmin = segment_sum, segment_min
    tv, ti = torch.from_numpy(vals), torch.from_numpy(ids)
    got_sum = fsum(tv, ti, n_seg).numpy()
    got_min = fmin(tv, ti, n_seg).numpy()
    assert got_sum.shape == got_min.shape == (n_seg,)
    for which, (want_sum, want_min) in jax_refs(vals, ids, n_seg).items():
        assert want_sum.dtype == np.float64, which
        np.testing.assert_allclose(got_sum, want_sum, rtol=0,
                                   atol=sum_tol(vals), err_msg=which)
        np.testing.assert_array_equal(got_min, want_min, err_msg=which)


def replay_plan(plan, vals, reduce, identity):
    """What the CUDA kernel computes from a plan, in Python."""
    offsets = plan.offsets.numpy()
    order = (np.arange(plan.nnz) if plan.perm is None
             else plan.perm.numpy())
    out = np.full(plan.num_segments, identity)
    for s in range(plan.num_segments):
        seg = vals[order[offsets[s]:offsets[s + 1]]]
        if seg.size:
            out[s] = reduce(seg)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("presorted", [False, True])
def test_plan_replays_to_the_reference(name, presorted):
    vals, ids, n_seg = make_case(name)
    if presorted:
        order = np.argsort(ids, kind="stable")
        vals, ids = vals[order], ids[order]
    plan = make_plan(torch.from_numpy(ids), n_seg, presorted=presorted)
    assert plan.offsets.dtype == torch.int32
    assert plan.offsets.shape == (n_seg + 1,)
    assert (plan.perm is None) == presorted
    if plan.perm is not None:
        assert plan.perm.dtype == torch.int32
        # a stable permutation: entries of one segment keep their order
        perm = plan.perm.numpy()
        assert np.array_equal(np.sort(perm), np.arange(vals.size))
    tv, ti = torch.from_numpy(vals), torch.from_numpy(ids)
    np.testing.assert_allclose(
        replay_plan(plan, vals, np.sum, 0.0),
        segment_sum_ref(tv, ti, n_seg).numpy(), rtol=0, atol=sum_tol(vals))
    np.testing.assert_array_equal(
        replay_plan(plan, vals, np.min, np.inf),
        segment_min_ref(tv, ti, n_seg).numpy())


def test_presorted_plan_rejects_unsorted_ids():
    with pytest.raises(ValueError, match="not sorted"):
        make_plan(torch.tensor([0, 2, 1]), 3, presorted=True)


def test_wrapper_checks_its_inputs():
    vals = torch.zeros(4, dtype=torch.float64)
    ids = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="float64"):
        segment_sum(vals.float(), ids, 2)
    with pytest.raises(ValueError, match="one length"):
        segment_sum(vals, ids[:3], 2)
    with pytest.raises(TypeError, match="int32 or int64"):
        segment_min(vals, ids.double(), 2)
    with pytest.raises(ValueError, match="another incidence"):
        segment_sum(vals, ids, 3, plan=make_plan(ids, 2))


def test_plan_of_other_ids_is_refused():
    """A plan is read only beside the id tensor it was made from: one of
    another id vector of the same length and segment count would give
    wrong sums and minima."""
    vals = torch.arange(4, dtype=torch.float64)
    ids = torch.tensor([0, 0, 1, 1])
    other = torch.tensor([1, 1, 0, 0])
    for kern in (segment_sum, segment_min):
        with pytest.raises(ValueError, match="another incidence"):
            kern(vals, ids, 2, plan=make_plan(other, 2))
        with pytest.raises(ValueError, match="another incidence"):
            kern(vals, ids, 2, plan=make_plan(ids.clone(), 2))
        np.testing.assert_array_equal(
            kern(vals, ids, 2, plan=make_plan(ids, 2)).numpy(),
            kern(vals, ids, 2).numpy())


def test_cpu_tensors_launch_nothing():
    reset_launch_counts()
    vals, ids, n_seg = make_case("duplicates")
    segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), n_seg)
    segment_min(torch.from_numpy(vals), torch.from_numpy(ids), n_seg)
    assert LAUNCHES == {"segment_sum": 0, "segment_min": 0}


@pytest.mark.parametrize("num_segments", [1, 2, 3, 7, 64, 1000])
def test_lanes_for_is_the_smallest_power_of_two_at_the_mean(num_segments):
    for nnz in range(0, 40 * num_segments + 2,
                     max(1, num_segments // 7)):
        lanes = lanes_for(nnz, num_segments)
        mean = nnz / num_segments
        assert lanes in LANES and lanes & (lanes - 1) == 0 and lanes <= 32
        if mean <= 32:
            assert lanes >= mean, (nnz, num_segments)
            assert lanes == 1 or lanes / 2 < mean, (nnz, num_segments)
        else:
            assert lanes == 32


def test_plans_carry_their_lanes():
    ids = torch.tensor([0, 0, 0, 1, 2, 2, 2, 2, 2])
    plan = make_plan(ids, 3)
    assert plan.lanes == lanes_for(9, 3) == 4
    assert dataclasses.replace(plan, lanes=16).lanes == 16
    for bad in (0, 3, 64):
        with pytest.raises(ValueError, match="lanes must be one of"):
            dataclasses.replace(plan, lanes=bad)


@pytest.mark.parametrize("name", sorted(CASES))
def test_keep_equals_a_plan_of_the_renumbered_ids(name):
    """``SegmentPlan.keep`` drops a plan's empty segments without a new
    sort: its offsets, permutation and lanes are those of a plan sorted
    afresh from the renumbered ids, and its twin gives the kept
    segments' sums of the full plan, bit for bit."""
    vals, ids, n_seg = make_case(name)
    full = make_plan(torch.from_numpy(ids), n_seg)
    kept = torch.nonzero(full.offsets[1:] > full.offsets[:-1]).squeeze(1)
    k = kept.numpy()
    # ids past the end stay past the end, in their order
    new_ids = torch.from_numpy(np.where(ids < n_seg, np.searchsorted(k, ids),
                                        ids - n_seg + k.size))
    plan = full.keep(kept, new_ids)
    fresh = make_plan(new_ids, k.size)
    assert plan.ids is new_ids
    assert ((plan.num_segments, plan.nnz, plan.lanes)
            == (fresh.num_segments, fresh.nnz, fresh.lanes))
    assert torch.equal(plan.offsets, fresh.offsets)
    assert torch.equal(plan.perm, fresh.perm)
    tv = torch.from_numpy(vals)
    check_inputs(tv, new_ids, k.size, plan)
    wide = segment_sum_ordered_ref(
        tv, dataclasses.replace(full, lanes=plan.lanes))
    got = segment_sum_ordered_ref(tv, plan)
    assert got.numpy().tobytes() == wide[kept].numpy().tobytes()


@functools.lru_cache(maxsize=None)
def case_refs(name):
    return jax_refs(*make_case(name))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ordered_twin_at_one_lane_is_a_left_to_right_loop(name):
    vals, ids, n_seg = make_case(name)
    plan = dataclasses.replace(make_plan(torch.from_numpy(ids), n_seg),
                               lanes=1)
    want = np.zeros(n_seg)
    for s in range(n_seg):
        for v in vals[ids == s]:
            want[s] = want[s] + v
    got = segment_sum_ordered_ref(torch.from_numpy(vals), plan).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_ordered_twin_matches_jax_ref_and_pallas(name, lanes):
    vals, ids, n_seg = make_case(name)
    plan = dataclasses.replace(make_plan(torch.from_numpy(ids), n_seg),
                               lanes=lanes)
    got = segment_sum_ordered_ref(torch.from_numpy(vals), plan).numpy()
    assert got.shape == (n_seg,) and got.dtype == np.float64
    for which, (want_sum, _) in case_refs(name).items():
        np.testing.assert_allclose(got, want_sum, rtol=0,
                                   atol=sum_tol(vals), err_msg=which)


def twin_keeps_the_32_lane_bits(vals, plan) -> int:
    """Asserts twin(G) == twin(32) bit for bit for every lanes count G
    that no segment of ``plan`` is longer than; returns how many G."""
    longest = int((plan.offsets[1:] - plan.offsets[:-1]).max()) \
        if plan.num_segments else 0
    wide = segment_sum_ordered_ref(vals, plan, 32)
    held = 0
    for lanes in LANES:
        if lanes >= longest:
            got = segment_sum_ordered_ref(vals, plan, lanes)
            assert got.numpy().tobytes() == wide.numpy().tobytes(), lanes
            held += 1
    return held


@pytest.mark.parametrize("name", sorted(CASES))
def test_ordered_twin_keeps_the_32_lane_bits_where_segments_fit(name):
    vals, ids, n_seg = make_case(name)
    tv = torch.from_numpy(vals)
    plan = make_plan(torch.from_numpy(ids), n_seg)
    twin_keeps_the_32_lane_bits(tv, plan)
    # one entry a segment: every lanes count fits
    one = make_plan(torch.arange(vals.size), vals.size, presorted=True)
    assert twin_keeps_the_32_lane_bits(tv, one) == len(LANES)


@pytest.mark.parametrize("scenario", ["uniform", "neighbor_shift"])
def test_ordered_twin_keeps_the_32_lane_bits_on_the_incidence(scenario):
    """The mphx-2p-8x8 incidence's two columns, as the solver plans them:
    at the plan's lanes the twin gives the 32-lane order's bits."""
    topo = MPHX(n=2, p=8, dims=(8, 8))
    build = {"uniform": uniform_demands,
             "neighbor_shift": neighbor_shift_demands}[scenario]
    inc = flow_incidence(make_router(topo, device="cpu"),
                         build(topo, 800.0, device="cpu"))
    prob = SolveProblem.build(inc, "cuda")
    want_lanes = {"uniform": (16, 4), "neighbor_shift": (1, 1)}[scenario]
    assert (prob.edge_plan.lanes, prob.flow_plan.lanes) == want_lanes
    rand = torch.from_numpy(np.random.default_rng(3).random(inc.nnz))
    for vals in (inc.frac, rand):
        for plan in (prob.edge_plan, prob.flow_plan):
            assert twin_keeps_the_32_lane_bits(vals, plan) >= 1
            got = segment_sum_ordered_ref(vals, plan)
            assert torch.equal(got, segment_sum_ordered_ref(vals, plan, 32))


def test_checks_run_on_every_device():
    """The wrapper's checks on the CPU, where no kernel runs: values laid
    out with a stride, and a plan whose tensors the kernel could not
    read, are refused before the plain path."""
    vals = torch.arange(8, dtype=torch.float64)
    ids = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum(vals[::2], ids, 2)
    plan = make_plan(ids, 2)
    for bad in (dataclasses.replace(plan, offsets=plan.offsets.long()),
                dataclasses.replace(plan, perm=plan.perm[::1].long())):
        for kern in (segment_sum, segment_min):
            with pytest.raises(ValueError, match="plan tensors"):
                kern(vals[:4], ids, 2, plan=bad)
    assert check_inputs(vals[:4], ids, 2, plan) == torch.device("cpu")
