"""The port's training-step co-simulation (``core/mapping.py``,
``cosim/``, ``experiments/cosuite.py``) against the JAX package's, on the
CPU.

Tolerances: floats within 1e-9 relative (every case is in fact bit for
bit, as the sums keep the reference's order), integers, strings and
error messages exact; wall-clock columns (``sim_wall_s``) are not
compared.  The reference runs at ``backend="numpy"``.

* ``mphx_levels``, ``_factorizations`` and ``best_mapping`` on
  ``tests/test_mapping.py``'s cases, and the ``ValueError`` of a job
  that fits no level (kimi-k2 at 65,536 ranks on mphx-4p-86x9, host
  arithmetic);
* ``job_from_model`` for every ported config on a grid of meshes,
  ``decompose_phase`` and ``phases_from_collectives``;
* ``phase_step_flows`` (flows, merged bytes bit for bit, steps, senders)
  and ``mphx_rank_layout`` on mphx-2p-8x8 and mphx-2p-16x16 at 64 to
  4,096 ranks, linear and mapped;
* ``simulate_step`` rows and phase rows over both methods, plane skew
  with a dead plane, stagger on and off, both placements and both
  engines on mphx-2p-8x8, ft3-small and dragonfly-small; the phase spans
  sum to ``comm_s``; the counters equal the reference's;
* ``run_cosim_suite`` at its defaults and with skip records, and the
  CLI's ``--suite cosim`` under ``--trace``.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.core.hyperx import table2_mphx_rows as ref_table2_rows  # noqa
from repro.core.netsim import NetParams as RefNetParams  # noqa: E402
from repro.core.planes import SprayConfig as RefSprayConfig  # noqa: E402
from repro import cosim as ref_cosim  # noqa: E402
from repro.experiments import cosuite as ref_cosuite  # noqa: E402
from repro.experiments.sweep import (  # noqa: E402
    SWEEP_TOPOLOGIES as REF_TOPOLOGIES)
from repro.models.registry import get_config as ref_get_config  # noqa
from repro.telemetry import TraceRecorder as RefTraceRecorder  # noqa
from repro.telemetry import collecting as ref_collecting  # noqa: E402
from repro.telemetry import recording as ref_recording  # noqa: E402
from repro_torch import cosim  # noqa: E402
from repro_torch.core import mapping  # noqa: E402
from repro_torch.core.hyperx import MPHX, table2_mphx_rows  # noqa: E402
from repro_torch.core.netsim import NetParams, make_router  # noqa: E402
from repro_torch.core.planes import SprayConfig  # noqa: E402
from repro_torch.experiments import cosuite  # noqa: E402
from repro_torch.experiments.run import main as cli_main  # noqa: E402
from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES  # noqa: E402
from repro_torch.models.registry import (PORTED_ARCH_IDS,  # noqa: E402
                                         get_config)
from repro_torch.telemetry import (TraceRecorder, collecting,  # noqa: E402
                                   recording)

WALLS = ("sim_wall_s",)
INF = math.inf


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small ops in the event loop: under the test runner's parallel
    workers torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(a, b, path="") -> None:
    """Recursive equality: floats within 1e-9 relative, the rest exact,
    wall-clock keys skipped."""
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        ka = {k for k in a if k not in WALLS}
        kb = {k for k in b if k not in WALLS}
        assert ka == kb, (path, ka ^ kb)
        for k in ka:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if math.isinf(a) or math.isnan(a):
            assert (a == b) or (math.isnan(a) and math.isnan(b)), path
        else:
            assert b == pytest.approx(a, rel=1e-9, abs=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def flow_rows(flows):
    return [(f.src, f.dst, f.size_bytes, f.start_s, f.tag) for f in flows]


# ------------------------------------------------------------ mapping ----


def mapping_cases():
    """(port topo, ref topo, port axes, ref axes) from test_mapping.py."""
    cases = []

    def add(kw, axes):
        cases.append((MPHX(**kw), RefMPHX(**kw),
                      [mapping.AxisTraffic(*a, **k) for a, k in axes],
                      [ref_mapping.AxisTraffic(*a, **k) for a, k in axes]))

    mphx8 = dict(n=8, p=256, dims=(256,))
    add(mphx8, [(("model", 16), dict(allgather_bytes=200e9, calls=400)),
                (("data", 16), dict(allreduce_bytes=20e9, calls=2))])
    add(mphx8, [(("ep", 16), dict(alltoall_bytes=1e9, calls=60))])
    add(dict(n=4, p=86, dims=(86, 9), links_per_dim=(85, 85)),
        [(("tp", 16), dict(allgather_bytes=3e9, calls=120)),
         (("ep", 8), dict(alltoall_bytes=5e9, calls=116)),
         (("dpo", 128), dict(allreduce_bytes=1e11))])
    return cases


@pytest.mark.parametrize("case", range(3))
def test_best_mapping_matches_reference(case):
    topo, ref_topo, axes, ref_axes = mapping_cases()[case]
    same([asdict(lv) for lv in mapping.mphx_levels(topo)],
         [asdict(lv) for lv in ref_mapping.mphx_levels(ref_topo)])
    got = mapping.best_mapping(topo, axes)
    want = ref_mapping.best_mapping(ref_topo, ref_axes)
    same(asdict(got), asdict(want))
    for ax, rax in zip(axes, ref_axes):
        for lv, rlv in zip(mapping.mphx_levels(topo),
                           ref_mapping.mphx_levels(ref_topo)):
            same(mapping.axis_time_on_level(ax, lv, topo),
                 ref_mapping.axis_time_on_level(rax, rlv, ref_topo))


def test_mapping_on_table2_rows_matches_reference():
    args = dict(param_bytes=18e9, act_bytes_per_layer=70e6, n_layers=48,
                ep_bytes=0.0, mesh_shape={"pod": 2, "data": 16,
                                          "model": 16})
    axes = mapping.traffic_from_model(**args)
    ref_axes = ref_mapping.traffic_from_model(**args)
    same([asdict(a) for a in axes], [asdict(a) for a in ref_axes])
    for t, rt in zip(table2_mphx_rows(), ref_table2_rows()):
        same(asdict(mapping.best_mapping(t, axes)),
             asdict(ref_mapping.best_mapping(rt, ref_axes)))


@pytest.mark.parametrize("size,caps", [(1, [4, 4]), (16, [86, 86, 9]),
                                       (128, [5, 86, 9]), (36, [6, 6]),
                                       (7, [2, 3]), (4096, [86, 86, 9])])
def test_factorizations_match_reference(size, caps):
    assert list(mapping._factorizations(size, caps)) == \
        list(ref_mapping._factorizations(size, caps))


def test_mapping_errors_match_reference():
    kw = dict(n=8, p=256, dims=(256,))
    axes = [("model", 300, 0.0, 1e9), ("data", 300, 1e9)]
    with pytest.raises(ValueError) as got:
        mapping.best_mapping(MPHX(**kw), [mapping.AxisTraffic(*a)
                                          for a in axes])
    with pytest.raises(ValueError) as want:
        ref_mapping.best_mapping(RefMPHX(**kw), [ref_mapping.AxisTraffic(*a)
                                                 for a in axes])
    assert str(got.value) == str(want.value)
    # the 16,384-rank cell's job at 65,536 ranks fits no level of the
    # paper's Table-2 MPHX: the same error as the reference's
    arch, n = "kimi-k2-1t-a32b", 65_536
    mesh = cosuite.default_mesh(arch, n, 384)
    assert mesh == ref_cosuite.default_mesh(arch, n, 384) == \
        {"dp": 4096, "tp": 16, "ep": 8}
    job = cosim.job_from_model(get_config(arch), **mesh)
    ref_job = ref_cosim.job_from_model(ref_get_config(arch), **mesh)
    with pytest.raises(ValueError) as got:
        cosim.mphx_rank_layout(SWEEP_TOPOLOGIES["mphx-4p-86x9"], job)
    with pytest.raises(ValueError) as want:
        ref_cosim.mphx_rank_layout(REF_TOPOLOGIES["mphx-4p-86x9"], ref_job)
    assert str(got.value) == str(want.value)
    assert "does not fit on 4-Plane 2D HyperX remaining capacity" in \
        str(got.value)


# ------------------------------------------------------------ traffic ----

MESHES = [(4, 1, 1), (8, 2, 1), (8, 8, 8), (16, 4, 2), (64, 16, 8),
          (1024, 16, 8)]


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_job_from_model_matches_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    for dp, tp, ep in MESHES:
        job = cosim.job_from_model(cfg, dp=dp, tp=tp, ep=ep)
        ref_job = ref_cosim.job_from_model(ref_cfg, dp=dp, tp=tp, ep=ep)
        same(asdict(job), asdict(ref_job))
        assert job.total_wire_bytes() == ref_job.total_wire_bytes()
    # ep not dividing dp; ep not dividing the expert count (MoE only)
    for bad in (dict(dp=4, tp=2, ep=3), dict(dp=10, tp=1, ep=5)):
        if cfg.moe is None and bad["dp"] % bad["ep"] == 0:
            continue
        with pytest.raises(ValueError) as got:
            cosim.job_from_model(cfg, param_count=1, active_params=1, **bad)
        with pytest.raises(ValueError) as want:
            ref_cosim.job_from_model(ref_cfg, param_count=1,
                                     active_params=1, **bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="train steps, got prefill_32k"):
        cosim.job_from_model(cfg, dp=2, shape="prefill_32k")


@pytest.mark.parametrize("n,experts", [(64, 8), (64, 384), (96, 8),
                                       (4096, None), (16_384, 384), (2, 8)])
def test_default_mesh_matches_reference(n, experts):
    for arch in ("kimi-k2-1t-a32b", "mixtral-8x22b", "yi-9b"):
        assert cosuite.default_mesh(arch, n, experts) == \
            ref_cosuite.default_mesh(arch, n, experts)
    assert cosuite.normalize_arch("kimi_k2_1t_a32b") == "kimi-k2-1t-a32b"


CHAINS = [[(4, 1), (4, 4)], [(2, 1), (2, 2), (4, 4)], [(16, 1)],
          [(8, 8), (2, 64)]]


@pytest.mark.parametrize("kind", ["allreduce", "allgather", "reducescatter",
                                  "alltoall"])
def test_decompose_phase_matches_reference(kind):
    for chain in CHAINS:
        size = math.prod(f for f, _ in chain)
        ph = cosim.CollectivePhase("x", kind, size, 1, 3.0 * (1 << 20),
                                   calls=3)
        ref_ph = ref_cosim.CollectivePhase("x", kind, size, 1,
                                           3.0 * (1 << 20), calls=3)
        same([asdict(s) for s in cosim.decompose_phase(ph, chain)],
             [asdict(s) for s in ref_cosim.decompose_phase(ref_ph, chain)])
    with pytest.raises(ValueError, match="does not factor group 16"):
        cosim.decompose_phase(cosim.CollectivePhase("y", kind, 16, 1, 1.0),
                              [(4, 1), (2, 4)])


def test_phases_from_collectives_matches_reference():
    parsed = {
        "all-reduce": {"count": 2, "by_group": {"8": 1400.0}},
        "all-gather": {"count": 1, "by_group": {"4": 300.0, "16": 90.0}},
        "reduce-scatter": {"count": 1, "by_group": {"2": 64.0, "1": 5.0}},
        "all-to-all": {"count": 1, "by_group": {"4": 512.0}},
        "collective-permute": {"count": 3, "by_group": {}},
    }
    for calls in (1, 4):
        same([asdict(p) for p in
              cosim.phases_from_collectives(parsed, 16, calls=calls)],
             [asdict(p) for p in
              ref_cosim.phases_from_collectives(parsed, 16, calls=calls)])
    bad = {"all-reduce": {"count": 1, "by_group": {"3": 9.0}}}
    with pytest.raises(ValueError) as got:
        cosim.phases_from_collectives(bad, 16)
    with pytest.raises(ValueError) as want:
        ref_cosim.phases_from_collectives(bad, 16)
    assert str(got.value) == str(want.value)
    for kind, size in (("nope", 4), ("allreduce", 1)):
        with pytest.raises(ValueError):
            cosim.CollectivePhase("z", kind, size, 1, 1.0)


# ---------------------------------------------------------- placement ----

PLACEMENT_CELLS = [("mphx-2p-8x8", 64), ("mphx-2p-8x8", 128),
                   ("mphx-2p-16x16", 256), ("mphx-2p-16x16", 4096)]


def jobs_at(n_ranks):
    out = []
    for arch in ("kimi-k2-1t-a32b", "mixtral-8x22b"):
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        mesh = cosuite.default_mesh(arch, n_ranks, cfg.moe.n_experts)
        out.append((cosim.job_from_model(cfg, **mesh),
                    ref_cosim.job_from_model(ref_cfg, **mesh)))
    return out


def check_phase_flows(phase, ref_phase, switch_of, ref_switch_of, n, start):
    flows, steps, senders = cosim.phase_step_flows(phase, switch_of, n,
                                                   start_s=start)
    rf, rsteps, rsenders = ref_cosim.phase_step_flows(
        ref_phase, ref_switch_of, n, start_s=start)
    # merged bytes bit for bit (exact ==), steps and senders exact
    assert flow_rows(flows) == flow_rows(rf)
    assert steps == rsteps
    assert senders.dtype == rsenders.dtype
    assert np.array_equal(senders, rsenders)
    return len(flows)


@pytest.mark.parametrize("topo_name,n_ranks", PLACEMENT_CELLS,
                         ids=[f"{t}-{n}" for t, n in PLACEMENT_CELLS])
def test_phase_step_flows_and_layout_match_reference(topo_name, n_ranks):
    topo, ref_topo = SWEEP_TOPOLOGIES[topo_name], REF_TOPOLOGIES[topo_name]
    sw, ref_sw = cosim.rank_to_switch(topo), ref_cosim.rank_to_switch(
        ref_topo)
    assert np.array_equal(sw, ref_sw)
    n_flows = 0
    for job, ref_job in jobs_at(n_ranks):
        for ph, rph in zip(job.phases, ref_job.phases):
            n_flows += check_phase_flows(ph, rph, sw, ref_sw, n_ranks, 1e-3)
        layout = cosim.mphx_rank_layout(topo, job)
        ref_layout = ref_cosim.mphx_rank_layout(ref_topo, ref_job)
        assert np.array_equal(layout.nic, ref_layout.nic)
        assert layout.factors == ref_layout.factors
        assert sorted(layout.nic.tolist()) == sorted(
            set(layout.nic.tolist()))
        sw_m = layout.nic // topo.p
        for ph, rph in zip(job.phases, ref_job.phases):
            chain = layout.factors[{(job.mesh["tp"], 1): "tp",
                                    (job.mesh["ep"], job.mesh["tp"]): "ep"}
                                   .get((ph.size, ph.stride), "dp")]
            subs = cosim.decompose_phase(ph, chain)
            ref_subs = ref_cosim.decompose_phase(rph, chain)
            for s, rs in zip(subs, ref_subs):
                n_flows += check_phase_flows(s, rs, sw_m, sw_m, n_ranks, 0.0)
    assert n_flows > 0


@pytest.mark.parametrize("name", ["ft3-small", "dragonfly-small",
                                  "mpft-2p-small", "dfplus-small"])
def test_rank_to_switch_on_graphs_matches_reference(name):
    topo, ref_topo = SWEEP_TOPOLOGIES[name], REF_TOPOLOGIES[name]
    got = cosim.rank_to_switch(topo)
    assert np.array_equal(got, ref_cosim.rank_to_switch(ref_topo))
    router = make_router(topo, engine="graph", device="cpu")
    assert np.array_equal(cosim.rank_to_switch(topo, router.graph), got)
    assert cosim.group_members(24, 4, 2) == ref_cosim.group_members(24, 4, 2)
    with pytest.raises(ValueError, match="does not tile"):
        cosim.group_members(10, 4, 1)


# ------------------------------------------------------ simulate_step ----

def toy_jobs(mod, n_ranks=32, scale=1.0):
    ph = mod.CollectivePhase
    return mod.TrainJob(
        "toy", n_ranks, {"dp": n_ranks // 4, "tp": 4, "ep": 4},
        tokens_per_step=4096, active_params=int(1e9),
        phases=(ph("tp_ag", "allgather", 4, 1, scale * (1 << 22), calls=4),
                ph("ep_a2a", "alltoall", 4, 4, scale * (1 << 22), calls=2),
                ph("dp_ar", "allreduce", n_ranks // 4, 4,
                   scale * (1 << 26))))


# (topology, arch or "toy", engine, placement, method, plane_skew, stagger)
STEP_CASES = {
    "8x8-array-linear": ("mphx-2p-8x8", "mixtral-8x22b", "array", "linear",
                         "steady", None, True),
    "8x8-array-mapped": ("mphx-2p-8x8", "kimi-k2-1t-a32b", "array",
                         "mapped", "steady", None, True),
    "8x8-graph-linear": ("mphx-2p-8x8", "kimi-k2-1t-a32b", "graph",
                         "linear", "steady", None, True),
    "8x8-batches": ("mphx-2p-8x8", "mixtral-8x22b", "array", "linear",
                    "batches", None, True),
    "8x8-mapped-batches": ("mphx-2p-8x8", "kimi-k2-1t-a32b", "array",
                           "mapped", "batches", None, True),
    "8x8-dead-plane": ("mphx-2p-8x8", "mixtral-8x22b", "array", "linear",
                       "steady", [1.0, INF], True),
    "8x8-skew-unstaggered": ("mphx-2p-8x8", "kimi-k2-1t-a32b", "graph",
                             "linear", "steady", [1.5, 1.0], False),
    "8x8-mapped-unstaggered": ("mphx-2p-8x8", "mixtral-8x22b", "array",
                               "mapped", "steady", [INF, 1.25], False),
    "ft3-steady": ("ft3-small", "kimi-k2-1t-a32b", "graph", "linear",
                   "steady", None, True),
    "ft3-batches": ("ft3-small", "mixtral-8x22b", "graph", "linear",
                    "batches", None, False),
    "dragonfly-steady": ("dragonfly-small", "mixtral-8x22b", "graph",
                         "linear", "steady", None, True),
    "dragonfly-batches": ("dragonfly-small", "kimi-k2-1t-a32b", "graph",
                          "linear", "batches", None, True),
    "toy-1d": ("mphx-2p-4x8", "toy", "array", "linear", "steady",
               [1.0, 2.0], True),
    "toy-1d-graph-dead": ("mphx-2p-4x8", "toy", "graph", "linear",
                          "steady", [INF, 1.0], True),
}


def topologies(name):
    if name == "mphx-2p-4x8":
        return MPHX(n=2, p=4, dims=(8,)), RefMPHX(n=2, p=4, dims=(8,))
    return SWEEP_TOPOLOGIES[name], REF_TOPOLOGIES[name]


def step_pair(name, **kw):
    """(port StepResult, reference StepResult) of one case."""
    tn, arch, engine, placement, method, skew, stagger = STEP_CASES[name]
    topo, ref_topo = topologies(tn)
    if arch == "toy":
        job, ref_job = toy_jobs(cosim), toy_jobs(ref_cosim)
    else:
        mesh = cosuite.default_mesh(arch, 64,
                                    get_config(arch).moe.n_experts)
        job = cosim.job_from_model(get_config(arch), **mesh)
        ref_job = ref_cosim.job_from_model(ref_get_config(arch), **mesh)
    args = dict(engine=engine, placement=placement, method=method,
                plane_skew=skew, stagger=stagger)
    got = cosim.simulate_step(topo, job, device="cpu", **args, **kw)
    want = ref_cosim.simulate_step(ref_topo, ref_job, backend="numpy",
                                   **args)
    return got, want


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_simulate_step_matches_reference(name):
    got, want = step_pair(name)
    same(got.row(), want.row())
    same([asdict(p) for p in got.phases], [asdict(p) for p in want.phases])
    for k in ("comm_s", "compute_s", "step_s", "tokens_per_s",
              "analytic_comm_s"):
        same(getattr(got, k), getattr(want, k), k)
    assert got.comm_s > 0


def test_uncontended_collapse_matches_reference():
    """test_cosim.py's uncontended limit (zero per-hop latencies, even
    spray, no chunk overhead) with a custom spray config and net: both
    methods equal the reference's and the closed form."""
    from repro_torch.core.netsim import ring_allreduce_time
    kw = dict(t_switch=0.0, t_prop_per_hop=0.0)
    spray = dict(n_planes=2, chunk_bytes=1 << 17, per_chunk_overhead_s=0.0)
    b = 8 * 2 * (1 << 17) * 4
    for method in cosim.PHASE_METHODS:
        job = cosim.TrainJob("toy", 8, {"dp": 8, "tp": 1, "ep": 1}, 1, 0,
                             (cosim.CollectivePhase("ar", "allreduce", 8, 1,
                                                    b),))
        ref_job = ref_cosim.TrainJob(
            "toy", 8, {"dp": 8, "tp": 1, "ep": 1}, 1, 0,
            (ref_cosim.CollectivePhase("ar", "allreduce", 8, 1, b),))
        got = cosim.simulate_step(MPHX(n=2, p=1, dims=(8,)), job,
                                  cfg=SprayConfig(**spray),
                                  net=NetParams(**kw), method=method,
                                  device="cpu")
        want = ref_cosim.simulate_step(RefMPHX(n=2, p=1, dims=(8,)),
                                       ref_job, cfg=RefSprayConfig(**spray),
                                       net=RefNetParams(**kw), method=method)
        same(got.row(), want.row())
        closed = ring_allreduce_time(MPHX(n=2, p=1, dims=(8,)), b, m=8,
                                     net=NetParams(**kw)).total_s
        assert abs(got.comm_s - closed) / closed < 1e-6


def test_simulate_step_refuses_what_the_reference_refuses():
    topo = MPHX(n=2, p=1, dims=(4,))
    job = toy_jobs(cosim)
    with pytest.raises(ValueError, match="job needs 32 ranks"):
        cosim.simulate_step(topo, job, device="cpu")
    topo = MPHX(n=2, p=4, dims=(8,))
    with pytest.raises(ValueError, match="unknown method"):
        cosim.simulate_step(topo, job, method="exact", device="cpu")
    with pytest.raises(ValueError, match="unknown placement"):
        cosim.simulate_step(topo, job, placement="random", device="cpu")
    with pytest.raises(ValueError, match="MPHX-only"):
        cosim.simulate_step(SWEEP_TOPOLOGIES["dragonfly-small"],
                            toy_jobs(cosim, n_ranks=16), placement="mapped",
                            device="cpu")


def test_per_flow_caps_reach_the_sprayed_simulation():
    """``simulate_sprayed`` takes a per-flow cap array (numpy or tensor)
    and refuses one of the wrong length."""
    from repro_torch.sim.events import FlowSpec
    from repro_torch.sim.spray import simulate_sprayed
    topo = MPHX(n=2, p=4, dims=(8,))
    flows = [FlowSpec(0, 1, 1 << 22), FlowSpec(2, 3, 1 << 22)]
    router = make_router(topo, device="cpu")
    caps = np.array([topo.port_gbps / 8, topo.port_gbps])
    a = simulate_sprayed(topo, flows, rate_cap_gbps=caps, router=router)
    b = simulate_sprayed(topo, flows, rate_cap_gbps=torch.tensor(caps),
                         router=router)
    assert torch.equal(a.completion_s, b.completion_s)
    assert float(a.completion_s[1]) < float(a.completion_s[0])
    with pytest.raises(ValueError, match="rate_cap_gbps has shape"):
        simulate_sprayed(topo, flows, rate_cap_gbps=caps[:1], router=router)


def phase_spans(events):
    return [(e["name"], e["tid"], e["ts"], e["dur"], e.get("args"))
            for e in events if e.get("cat") in ("phase", "plane")]


@pytest.mark.parametrize("name", ["8x8-array-mapped", "8x8-dead-plane",
                                  "dragonfly-batches"])
def test_trace_spans_and_counters_match_reference(name):
    rec, ref_rec = TraceRecorder(), RefTraceRecorder()
    with recording(rec), collecting() as mx:
        with ref_recording(ref_rec), ref_collecting() as ref_mx:
            got, want = step_pair(name)
    spans = phase_spans(rec.events)
    assert spans
    same(spans, phase_spans(ref_rec.events))
    steps = [e for e in rec.events if e.get("cat") == "phase"]
    assert len(steps) == len(got.phases)
    assert sum(e["dur"] for e in steps) == pytest.approx(got.comm_s * 1e6,
                                                         rel=1e-9)
    # plane spans never outlast their phase
    for e in rec.events:
        if e.get("cat") == "plane":
            ph = next(s for s in steps if s["name"] == e["name"])
            assert e["dur"] <= ph["dur"]
    counters = mx.snapshot()["counters"]
    ref_counters = ref_mx.snapshot()["counters"]
    assert counters["cosim.phases"] == len(got.phases)
    for k in ("cosim.phases", "sim.runs", "sim.flows", "sim.epochs",
              "spray.plane_sims", "spray.respray_events"):
        assert counters.get(k) == ref_counters.get(k), k


# ---------------------------------------------------------------- suite ----


def test_cosim_suite_defaults_match_reference(tmp_path):
    got = cosuite.run_cosim_suite(str(tmp_path / "port"), device="cpu")
    want = ref_cosuite.run_cosim_suite(str(tmp_path / "ref"),
                                       backend="numpy")
    same(got["rows"], want["rows"])
    assert got["params"]["n_rows"] == want["params"]["n_rows"] == 10
    assert got["params"]["meshes"] == want["params"]["meshes"]
    assert got["schema_version"] == 7 and got["suite"] == "cosim"
    disk = json.loads((tmp_path / "port" / "cosim.json").read_text())
    assert disk["rows"] == json.loads(json.dumps(got["rows"]))
    md = (tmp_path / "port" / "cosim.md").read_text()
    assert "tokens_per_s" in md and "Per-phase breakdown" in md
    assert all(r["sim_wall_s"] >= 0 for r in got["rows"])


def test_cosim_suite_skip_records_match_reference(tmp_path):
    kw = dict(config_names=["mixtral_8x22b", "kimi-k2-1t-a32b"],
              topo_names=["dragonfly-small", "mphx-2p-8x8"], n_ranks=128,
              method="batches")
    got = cosuite.run_cosim_suite(str(tmp_path / "port"), device="cpu",
                                  sim_backend="torch", **kw)
    want = ref_cosuite.run_cosim_suite(str(tmp_path / "ref"), **kw)
    same(got["rows"], want["rows"])
    skipped = [r for r in got["rows"] if r.get("skipped")]
    assert len(skipped) == got["params"]["n_skipped"] == 2
    assert all("NIC" in r["reason"] for r in skipped)
    assert "Skipped" in (tmp_path / "port" / "cosim.md").read_text()


def test_cosim_cli_writes_artifacts_and_traces_phases(tmp_path):
    trace_path = tmp_path / "t.json"
    rc = cli_main(["--suite", "cosim", "--config", "mixtral_8x22b",
                   "--topos", "mphx-2p-8x8", "--ranks", "32",
                   "--device", "cpu", "--out", str(tmp_path),
                   "--trace", str(trace_path)])
    assert rc == 0
    payload = json.loads((tmp_path / "cosim.json").read_text())
    assert (tmp_path / "cosim.md").exists()
    rows = payload["rows"]
    assert [(r["engine"], r["placement"]) for r in rows] == \
        [("array", "linear"), ("array", "mapped"), ("graph", "linear")]
    assert payload["telemetry"]["counters"]["cosim.phases"] == \
        sum(len(r["phases"]) for r in rows)
    trace = json.loads(trace_path.read_text())
    assert trace["otherData"]["skipped"] == []
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "phase"]
    assert len(spans) == sum(len(r["phases"]) for r in rows)
    # the step track's spans add up to the rows' measured comm time
    total_ms = sum(r["comm_ms"] for r in rows)
    assert sum(e["dur"] for e in spans) / 1e3 == pytest.approx(
        total_ms, abs=1e-4 * len(rows))
    # every cell skipped: an explicit untraced note
    rc = cli_main(["--suite", "cosim", "--topos", "dragonfly-small",
                   "--ranks", "128", "--device", "cpu", "--out",
                   str(tmp_path), "--trace", str(trace_path)])
    assert rc == 0
    trace = json.loads(trace_path.read_text())
    assert [n["name"] for n in trace["otherData"]["skipped"]] == ["cosim"]
