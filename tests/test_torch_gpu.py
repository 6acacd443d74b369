"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions, and the slice through them.

Every test here carries the ``cuda`` marker and skips, from the ``cuda``
fixture, where ``torch.cuda.is_available()`` is false.  This file imports
neither ``jax`` nor the JAX package, so it runs on a machine with a card
and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpu.py

Tolerances: sum within ``1e-12 * max|value| * NNZ`` (the kernel sums in
another order), min exact, two kernel runs bitwise equal; suite rows at
1e-9 relative with integers exact.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.core.netsim import make_router  # noqa: E402
from repro_torch.core.routing_vec import (  # noqa: E402
    neighbor_shift_demands, uniform_demands)
from repro_torch.experiments.simsuite import run_sim_suite  # noqa: E402
from repro_torch.kernels.segment_fairshare import (  # noqa: E402
    LAUNCHES, make_plan, reset_launch_counts, segment_min, segment_min_ref,
    segment_sum, segment_sum_ref)
from repro_torch.sim.events import simulate_incidence  # noqa: E402
from repro_torch.sim.fairshare import (SolveProblem,  # noqa: E402
                                       flow_incidence)

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
