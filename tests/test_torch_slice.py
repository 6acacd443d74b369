"""The port's slice as a whole: ``--suite sim`` through the CLI on the
CPU against the JAX package's ``run_sim_suite`` (jitted backend).

Every ``steady_check``, ``fct`` and measured ``collective`` row must
match at 1e-9 relative with integers exact, leaving out the wall clocks
and the round-off measure ``max_abs_util_diff`` (held below 1e-6 on both
sides by ``agrees_1e-6``).
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.experiments.simsuite import run_sim_suite  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--suite", "sim", "--topos", "mphx-2p-8x8", "--scenarios",
        "uniform", "neighbor_shift", "--loads", "0.5", "0.9"]
UNCOMPARED = {"sim_wall_s", "max_abs_util_diff"}
PORT_ONLY = {"sim_nnz", "sim_waterfill_rounds"}


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def run_port_cli(out_dir, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.run", *ARGS,
         "--device", "cpu", "--out", str(out_dir), *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(out_dir, "sim.json")) as f:
        return json.load(f)


def test_cli_rows_match_reference(tmp_path):
    port = run_port_cli(tmp_path / "port")
    ref = run_sim_suite(str(tmp_path / "ref"), topo_names=["mphx-2p-8x8"],
                        scenario_names=["uniform", "neighbor_shift"],
                        load_fractions=(0.5, 0.9), sim_backend="jax")
    assert port["schema_version"] == ref["schema_version"] == 7
    assert port["params"]["device"] == "cpu"
    want, got = ref["rows"], port["rows"]
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == \
        ["steady_check", "fct", "fct"] * 2 + ["collective"] * 3
    for g, w in zip(got, want):
        assert set(g) == set(w) | (PORT_ONLY if g["kind"] == "fct"
                                   else set())
        for k, v in w.items():
            if k in UNCOMPARED:
                continue
            name = w.get("scenario", w.get("collective"))
            if isinstance(v, float) and v != 0:
                assert abs(g[k] - v) <= 1e-9 * abs(v), (name, k)
            else:
                assert g[k] == v, (name, k, g[k], v)
        if w["kind"] == "steady_check":
            assert g["agrees_1e-6"] and w["agrees_1e-6"]
    assert (tmp_path / "port" / "sim.md").exists()


def test_cli_plain_backend_gives_the_same_rows(tmp_path):
    a = run_port_cli(tmp_path / "a", "--sim-backend", "cuda")
    b = run_port_cli(tmp_path / "b", "--sim-backend", "torch")
    assert b["params"]["sim_backend"] == "torch"
    strip = lambda rows: [{k: v for k, v in r.items() if k != "sim_wall_s"}
                          for r in rows]
    assert strip(a["rows"]) == strip(b["rows"])
