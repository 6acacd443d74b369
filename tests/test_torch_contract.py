"""The port's package contract.

* No module under ``src/repro_torch/``, not ``chip_smoke.py`` and no script
  under ``tools/`` imports ``jax`` or anything of the JAX package ``repro``
  (an AST scan).
* With ``jax`` and ``repro`` blocked, every module imports and the CPU
  slices run: the sim CLI (under ``--trace``), the table2 CLI, the cost
  model and the collective closed forms, the serve CLI (yi-9b and
  recurrentgemma-2b) and a yi-9b and a mixtral-8x22b smoke forward pass
  (a subprocess).
* With no CUDA device, entry points called without ``device="cpu"`` raise
  instead of running on the CPU; unknown backends raise; a wrapper handed
  a tensor that is neither on the CPU nor on a GPU raises.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import (resolve_kernel_backend,  # noqa: E402
                         resolve_sim_backend)
from repro_torch.convert import (decoder_params_from_numpy,  # noqa: E402
                                 demands_from_arrays,
                                 hybrid_params_from_numpy,
                                 incidence_from_arrays)
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.cosim import (CollectivePhase, TrainJob,  # noqa: E402
                               simulate_step)
from repro_torch.experiments.cosuite import run_cosim_suite  # noqa: E402
from repro_torch.experiments.servesuite import (  # noqa: E402
    TENANT_PRESETS, run_serving_suite)
from repro_torch.workload import run_tenant_mix  # noqa: E402
from repro_torch.core.netsim import (  # noqa: E402
    adversarial_throughput_fraction, make_router, pattern_throughput,
    resolve_engine)
from repro_torch.core.routing_vec import (  # noqa: E402
    VectorizedHyperXRouter, neighbor_shift_demands, ring_demands,
    uniform_demands)
from repro_torch.core.routing_graph import (  # noqa: E402
    GraphRouter, graph_uniform_demands)
from repro_torch.experiments.run import main as cli_main  # noqa: E402
from repro_torch.experiments.sweep import (SWEEP_TOPOLOGIES,  # noqa: E402
                                           run_sweep_suite)
from repro_torch.experiments.simsuite import (  # noqa: E402
    run_failures_suite, run_sim_suite)
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    grouped_matmul, ragged_grouped_matmul)
from repro_torch.kernels.rg_lru import lru_scan  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.segment_fairshare import segment_sum  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.models.rglru import RGLRUModel  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.routing.protection import ProtectedRouter  # noqa: E402
from repro_torch.sim.events import (FlowSpec, flows_to_demands,  # noqa
                                    simulate_incidence)
from repro_torch.sim.collective_sim import simulate_collective  # noqa
from repro_torch.sim.failures import (  # noqa: E402
    degraded_router, failure_throughput, parse_failure_spec, recovery_curve)
from repro_torch.sim.fairshare import max_min_rates  # noqa: E402
from repro_torch.sim.spray import flowlet_split, simulate_sprayed  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    tools = os.path.join(ROOT, "tools")
    out += [os.path.join(tools, f) for f in sorted(os.listdir(tools))
            if f.endswith(".py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(forbidden(n) for n in names), (path, names)


def test_package_runs_with_jax_blocked(tmp_path):
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.experiments.run import main
        rc = main(["--topos", "mphx-2p-8x8", "--device", "cpu",
                   "--out", {str(tmp_path)!r},
                   "--trace", {str(tmp_path / "trace.json")!r}])
        assert main(["--suite", "table2", "--out", {str(tmp_path)!r}]) == 0
        from repro_torch.core.cost import table2
        from repro_torch.core.netsim import (allreduce_time,
                                             compare_topologies)
        from repro_torch.core.cost import table2_topologies
        from repro_torch.telemetry import validate_trace
        import json
        assert len(table2(access_copper=True)) == 8
        topos = table2_topologies()
        assert len(compare_topologies(topos)) == 8
        assert allreduce_time(topos[-1], 2**20).total_s > 0
        trace = json.load(open({str(tmp_path / "trace.json")!r}))
        assert validate_trace(trace) == [] and trace["traceEvents"]
        import torch
        from repro_torch.launch.serve import main as serve
        stats = serve(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "8",
                       "--max-new", "3"])
        assert stats.tokens_out == 6, stats
        from repro_torch.models.registry import get_config, get_model
        model = get_model(get_config("yi-9b", smoke=True), device="cpu")
        logits, _ = model.forward(model.init(0),
                                  torch.zeros((2, 5), dtype=torch.int64))
        assert logits.shape == (2, 5, 512)
        assert bool(torch.isfinite(logits).all())
        model = get_model(get_config("mixtral-8x22b", smoke=True),
                          device="cpu")
        logits, aux = model.forward(model.init(0),
                                    torch.zeros((2, 5), dtype=torch.int64))
        assert logits.shape == (2, 5, 512) and float(aux) > 0
        stats = serve(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                       "cpu", "--requests", "2", "--prompt-len", "10",
                       "--max-new", "3"])
        assert stats.tokens_out == 6, stats
        assert "jax" not in sys.modules or sys.modules["jax"] is None
        sys.exit(rc)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "telemetry" in json.loads((tmp_path / "sim.json").read_text())
    assert (tmp_path / "table2.json").exists()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_refuse_to_run_on_the_cpu_unasked(no_cuda, tmp_path):
    topo = MPHX(n=2, p=8, dims=(8, 8))
    inc = incidence_from_arrays([0], [0], [1.0], 1, [1.0], device="cpu")
    spec = parse_failure_spec("link:0.05")

    job = TrainJob("toy", 16, {"dp": 16, "tp": 1, "ep": 1}, 1, 0,
                   (CollectivePhase("ar", "allreduce", 16, 1, 2.0**20),))

    def build(*args):
        raise AssertionError("demands built before the device was checked")

    calls = [
        lambda: make_router(topo),
        lambda: VectorizedHyperXRouter(topo),
        lambda: uniform_demands(topo, 800.0),
        lambda: neighbor_shift_demands(topo, 800.0),
        lambda: max_min_rates(inc, [1.0]),
        lambda: simulate_incidence(inc, 1.0, 1.0),
        lambda: incidence_from_arrays([0], [0], [1.0], 1, [1.0]),
        lambda: demands_from_arrays([0], [1], [1.0]),
        lambda: run_sim_suite(str(tmp_path)),
        lambda: run_sweep_suite(str(tmp_path)),
        lambda: cli_main(["--out", str(tmp_path)]),
        lambda: cli_main(["--suite", "sweep", "--out", str(tmp_path)]),
        lambda: make_router(SWEEP_TOPOLOGIES["dragonfly-small"]),
        lambda: GraphRouter(SWEEP_TOPOLOGIES["ft3-small"]),
        lambda: graph_uniform_demands(SWEEP_TOPOLOGIES["ft3-small"], 800.0),
        lambda: flows_to_demands([FlowSpec(0, 1, 1e6)]),
        lambda: DecoderLM(get_config("yi-9b", smoke=True)),
        lambda: get_model(get_config("yi-9b", smoke=True)),
        lambda: get_model(get_config("mixtral-8x22b", smoke=True)),
        lambda: decoder_params_from_numpy({}, get_config("yi-9b",
                                                          smoke=True)),
        lambda: RGLRUModel(get_config("recurrentgemma-2b", smoke=True)),
        lambda: get_model(get_config("recurrentgemma-2b", smoke=True)),
        lambda: hybrid_params_from_numpy({}, get_config("recurrentgemma-2b",
                                                        smoke=True)),
        lambda: serve_main(["--arch", "recurrentgemma-2b", "--smoke"]),
        lambda: serve_main(["--smoke"]),
        lambda: cli_main(["--trace", str(tmp_path / "t.json"),
                          "--out", str(tmp_path)]),
        lambda: cli_main(["--suite", "sweep", "--simulate", "--trace",
                          str(tmp_path / "t.json"), "--out",
                          str(tmp_path)]),
        lambda: adversarial_throughput_fraction(topo),
        lambda: pattern_throughput(topo, None, mode="minimal"),
        lambda: ring_demands(topo, 800.0),
        lambda: simulate_sprayed(topo, [FlowSpec(0, 5, 1e6)]),
        lambda: simulate_sprayed(topo, [FlowSpec(0, 5, 1e6)],
                                 granularity="flowlet"),
        lambda: simulate_collective(topo, "alltoall", 2**20),
        lambda: simulate_collective(SWEEP_TOPOLOGIES["dragonfly-small"],
                                    "allreduce_ring", 2**20),
        lambda: flowlet_split(np.ones(3), 2, 0.5),
        lambda: cli_main(["--sim-collective-mb", "1", "--out",
                          str(tmp_path)]),
        lambda: run_failures_suite(str(tmp_path)),
        lambda: cli_main(["--suite", "failures", "--out", str(tmp_path)]),
        lambda: ProtectedRouter(topo),
        lambda: degraded_router(topo, spec),
        lambda: failure_throughput(topo, build, spec, 400.0),
        lambda: recovery_curve(topo, build, spec, 400.0),
        lambda: recovery_curve(topo, build, spec, 400.0, reroute="local"),
        lambda: simulate_step(topo, job),
        lambda: simulate_step(topo, job, method="batches"),
        lambda: run_tenant_mix(topo, [TENANT_PRESETS["chat"]]),
        lambda: run_cosim_suite(str(tmp_path)),
        lambda: run_serving_suite(str(tmp_path)),
        lambda: cli_main(["--suite", "cosim", "--out", str(tmp_path)]),
        lambda: cli_main(["--suite", "serving", "--out", str(tmp_path)]),
        lambda: cli_main(["--suite", "all", "--out", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "sim.json").exists()
    assert not (tmp_path / "sweep.json").exists()
    assert not (tmp_path / "t.json").exists()
    assert not (tmp_path / "failures.json").exists()
    for suite in ("cosim", "serving", "table2"):
        assert not (tmp_path / f"{suite}.json").exists()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown fairshare backend 'auto'"):
        resolve_sim_backend("auto")
    inc = incidence_from_arrays([0], [0], [1.0], 1, [1.0], device="cpu")
    for bad in ("auto", "numpy", "jax", "pallas"):
        with pytest.raises(ValueError, match="expected one of"):
            max_min_rates(inc, [1.0], backend=bad, device="cpu")


def test_unknown_kernel_backend_raises():
    with pytest.raises(ValueError, match="unknown kernel backend 'auto'"):
        resolve_kernel_backend("auto")
    for bad in ("auto", "triton", "jax"):
        with pytest.raises(ValueError, match="expected one of"):
            get_model(get_config("yi-9b", smoke=True), device="cpu",
                      kernel_backend=bad)
    with pytest.raises(SystemExit):
        serve_main(["--smoke", "--device", "cpu", "--kernel-backend",
                    "auto"])


def test_resolve_engine_matches_the_reference():
    """The graph engine is ported: ``resolve_engine`` behaves as the
    reference's (array for MPHX under ``auto``, graph for the baselines,
    ``ValueError`` for an unknown engine or the array engine on a
    baseline)."""
    mphx = MPHX(n=2, p=8, dims=(8, 8))
    dragonfly = SWEEP_TOPOLOGIES["dragonfly-small"]
    assert resolve_engine(mphx, "auto") == "array"
    assert resolve_engine(mphx, "graph") == "graph"
    assert resolve_engine(dragonfly, "auto") == "graph"
    with pytest.raises(ValueError, match="array engine is MPHX-only, got "
                       "Dragonfly \\(small\\)"):
        resolve_engine(dragonfly, "array")
    with pytest.raises(ValueError, match="unknown engine 'ecmp'"):
        resolve_engine(mphx, "ecmp")


def test_wrapper_has_no_fallback_off_the_cpu():
    vals = torch.zeros(4, dtype=torch.float64, device="meta")
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        segment_sum(vals, ids, 2)


def test_model_kernel_wrappers_have_no_fallback_off_the_cpu():
    x = torch.zeros(3, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rmsnorm(x, torch.ones(16, device="meta"))
    q = torch.zeros(1, 2, 1, 2, 16, device="meta")
    k = torch.zeros(1, 3, 1, 16, device="meta")
    pos = torch.zeros(2, dtype=torch.int32, device="meta")
    kv_pos = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(q, k, k, pos, kv_pos)


def test_grouped_matmul_wrappers_have_no_fallback_off_the_cpu():
    x = torch.zeros(2, 3, 16, device="meta")
    w = torch.zeros(2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        grouped_matmul(x, w)
    sizes = torch.tensor([2, 1], device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ragged_grouped_matmul(torch.zeros(3, 16, device="meta"), w, sizes)


def test_lru_scan_wrapper_has_no_fallback_off_the_cpu():
    a = torch.zeros(2, 5, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lru_scan(a, a)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lru_scan(a, a, torch.zeros(2, 8, device="meta"))


def test_convert_checks_flow_order():
    with pytest.raises(ValueError, match="sorted by flow"):
        incidence_from_arrays(np.array([1, 0]), [0, 1], [1.0, 1.0], 2,
                              [1.0, 1.0], device="cpu")
