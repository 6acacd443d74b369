"""The port's segment reductions against the JAX package's.

The plain PyTorch versions (and the wrappers, which take them for CPU
tensors) are held against ``repro.kernels.segment_fairshare``'s
``segment_sum_ref`` / ``segment_min_ref`` and against its Pallas kernels
in interpret mode under x64.  Tolerances: sum within
``1e-12 * max|value| * NNZ`` (the summation order differs), min exact.
The segment plans the CUDA kernels read are checked here by replaying
them in Python; the kernels themselves run only on a GPU
(``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_fairshare import (  # noqa: E402
    segment_min as pallas_segment_min, segment_min_ref as jax_min_ref,
    segment_sum as pallas_segment_sum, segment_sum_ref as jax_sum_ref)
from repro_torch.kernels.segment_fairshare import (  # noqa: E402
    LAUNCHES, make_plan, reset_launch_counts, segment_min, segment_min_ref,
    segment_sum, segment_sum_ref)


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
