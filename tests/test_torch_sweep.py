"""The port's ``sweep`` and ``sim`` suites against the JAX package's, on
the CPU.

``run_sweep_suite`` over ``mphx-2p-8x8``, a 1-D MPHX and the reference's
default topologies (the small MPHX and the four Table-2 baselines on the
graph engine), every scenario (the synthetic ones and the three
collective chunk schedules), the three routing modes, two loads,
measured FCT columns on the minimal rows, against the reference's with
its numpy backends: every row the reference writes has a port row in the
same place, with every key both write equal (floats at 1e-9 relative,
the rest exactly; the wall clocks left out), and the skip records are
the reference's.  The same for ``run_sim_suite``'s default rows
(``mphx-2p-8x8`` and ``dragonfly-small``), the measured collectives
included, and for MPHX forced onto the graph engine.  The CLI's
``--suite sweep`` runs on the CPU.
"""

import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.experiments import simsuite as ref_simsuite  # noqa: E402
from repro.experiments import sweep as ref_sweep  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.experiments import simsuite, sweep  # noqa: E402
from repro_torch.experiments.run import SUITES  # noqa: E402
from repro_torch.experiments.run import main as cli_main  # noqa: E402
from repro_torch.experiments.scenarios import SCENARIOS  # noqa: E402

ONE_D = ("mphx-2p-8", dict(n=2, p=4, dims=(8,)))
COLLECTIVES = sorted(n for n, s in SCENARIOS.items()
                     if s.kind == "collective")
LOADS = (0.5, 1.0)
UNCOMPARED = ("sweep_wall_s", "sim_wall_s", "max_abs_util_diff")


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The graph engine's CPU path is thousands of small ops; under the
    test runner's parallel workers torch's thread pools oversubscribe
    the cores, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_d(monkeypatch):
    """A small 1-D preset on both sides (the 1-D Table-2 row, 65,536
    NICs, is too large for the CPU reference)."""
    name, kw = ONE_D
    monkeypatch.setitem(ref_sweep.SWEEP_TOPOLOGIES, name, RefMPHX(**kw))
    monkeypatch.setitem(sweep.SWEEP_TOPOLOGIES, name, MPHX(**kw))
    return name


def routed(payload):
    return [r for r in payload["rows"] if not r.get("skipped")]


def assert_rows_match(got_rows, want_rows):
    """Row for row, every key both write (wall clocks and round-off
    sizes left out): floats at 1e-9 relative, the rest exactly.  A row
    names its scenario, or (a measured collective) its collective."""
    assert len(got_rows) == len(want_rows) > 0
    for g, w in zip(got_rows, want_rows):
        shared = (set(g) & set(w)) - set(UNCOMPARED)
        assert {"topology", "engine"} <= shared
        assert {"scenario", "collective"} & shared
        name = g.get("scenario", g.get("collective"))
        for k in sorted(shared):
            v = w[k]
            if isinstance(v, float) and v != 0:
                assert abs(g[k] - v) <= 1e-9 * abs(v), (g["topology"],
                                                        name, k)
            else:
                assert g[k] == v, (g["topology"], name, k, g[k], v)


@pytest.mark.parametrize("simulate", (True, False))
@pytest.mark.parametrize("topo", ["mphx-2p-8x8", "1d"])
def test_sweep_suite_matches_the_reference(tmp_path, one_d, topo, simulate):
    name = one_d if topo == "1d" else topo
    want = ref_sweep.run_sweep_suite(
        str(tmp_path / "ref"), topo_names=[name], load_fractions=LOADS,
        backend="numpy", simulate=simulate, sim_backend="numpy")
    got = sweep.run_sweep_suite(
        str(tmp_path / "port"), topo_names=[name], load_fractions=LOADS,
        simulate=simulate, sim_backend="torch", device="cpu")
    want_rows = routed(want)
    got_rows = routed(got)
    assert len(got_rows) == len(want_rows) > 0
    assert {r["scenario"] for r in got_rows if r["kind"] == "collective"} \
        == set(COLLECTIVES)
    n_shared = 0
    for g, w in zip(got_rows, want_rows):
        shared = (set(g) & set(w)) - set(UNCOMPARED)
        assert {"scenario", "mode", "max_util", "latency_us"} <= shared
        for k in sorted(shared):
            v = w[k]
            if isinstance(v, float) and v != 0:
                assert abs(g[k] - v) <= 1e-9 * abs(v), (g["scenario"],
                                                        g["mode"], k)
            else:
                assert g[k] == v, (g["scenario"], g["mode"], k, g[k], v)
        n_shared += 1
        assert ("fct_p99_us" in g) == (simulate and g["mode"] == "minimal")
    assert n_shared == len(want_rows)
    assert [r for r in got["rows"] if r.get("skipped")] == \
        [r for r in want["rows"] if r.get("skipped")]


def test_default_sweep_skips_the_graph_presets(tmp_path):
    """The default sweep no longer skips the graph presets: it routes the
    reference's five default topologies, the four baselines on the graph
    engine, every scenario (the collective ones too), and its only skip
    records are the reference's (``transpose`` on the baselines)."""
    payload = sweep.run_sweep_suite(str(tmp_path), load_fractions=(1.0,),
                                    modes=["minimal"], device="cpu")
    assert payload["params"]["topologies"] == ref_sweep.DEFAULT_SWEEP_TOPOS
    assert not [r for r in payload["rows"] if r["scenario"] == "*"]
    skips = [(r["topology"], r["scenario"]) for r in payload["rows"]
             if r.get("skipped")]
    names = [ref_sweep.SWEEP_TOPOLOGIES[n].name
             for n in ref_sweep.DEFAULT_SWEEP_TOPOS]
    assert sorted(skips) == sorted((t, "transpose") for t in names[1:])
    engines = {r["topology"]: r["engine"] for r in routed(payload)}
    assert engines == {t: "array" if i == 0 else "graph"
                       for i, t in enumerate(names)}
    assert len(routed(payload)) == len(SCENARIOS) + 4 * (len(SCENARIOS) - 1)
    md = (tmp_path / "sweep.md").read_text()
    assert all(f"{t} (" in md for t in names)


@pytest.mark.parametrize("simulate", (True, False))
def test_default_sweep_matches_the_reference(tmp_path, simulate):
    want = ref_sweep.run_sweep_suite(
        str(tmp_path / "ref"), load_fractions=LOADS, backend="numpy",
        simulate=simulate, sim_backend="numpy")
    got = sweep.run_sweep_suite(
        str(tmp_path / "port"), load_fractions=LOADS, simulate=simulate,
        sim_backend="torch", device="cpu")
    assert_rows_match(routed(got), routed(want))
    assert {r["engine"] for r in routed(got)} == {"array", "graph"}
    assert {(r["kind"], r["engine"]) for r in routed(got)} == {
        (k, e) for k in ("synthetic", "collective")
        for e in ("array", "graph")}
    for r in routed(got):
        assert ("fct_p99_us" in r) == (simulate and r["mode"] == "minimal")
    assert [r for r in got["rows"] if r.get("skipped")] == \
        [r for r in want["rows"] if r.get("skipped")]


def test_sweep_engine_choice_matches_the_reference(tmp_path):
    """``engine="graph"`` routes MPHX on the graph engine; ``"array"``
    turns the baselines into one skip record each, the reference's."""
    kw = dict(topo_names=["mphx-2p-8x8", "dragonfly-small"],
              scenario_names=["uniform", "hotspot"], load_fractions=(1.0,))
    for engine in ("graph", "array"):
        want = ref_sweep.run_sweep_suite(
            str(tmp_path / f"ref-{engine}"), backend="numpy", engine=engine,
            **kw)
        got = sweep.run_sweep_suite(str(tmp_path / engine), engine=engine,
                                    device="cpu", **kw)
        assert_rows_match(routed(got), routed(want))
        assert [r for r in got["rows"] if r.get("skipped")] == \
            [r for r in want["rows"] if r.get("skipped")]


def test_default_sim_suite_matches_the_reference(tmp_path):
    """``run_sim_suite``'s defaults, ``mphx-2p-8x8`` and
    ``dragonfly-small``, whole: the steady-state checks, the FCT rows
    and the measured collectives (three a topology)."""
    assert simsuite.DEFAULT_SIM_TOPOS == ref_simsuite.DEFAULT_SIM_TOPOS
    assert simsuite.MAX_COLLECTIVE_NICS == ref_simsuite.MAX_COLLECTIVE_NICS
    want = ref_simsuite.run_sim_suite(str(tmp_path / "ref"),
                                      backend="numpy", sim_backend="numpy")
    got = simsuite.run_sim_suite(str(tmp_path / "port"), sim_backend="torch",
                                 device="cpu")
    assert len(got["rows"]) == len(want["rows"]) == 18
    assert_rows_match(got["rows"], want["rows"])
    assert [r["engine"] for r in got["rows"]] == ["array"] * 9 + ["graph"] * 9
    assert [r["collective"] for r in got["rows"]
            if r["kind"] == "collective"] == \
        list(ref_simsuite.SIM_COLLECTIVES) * 2
    assert got["params"]["all_steady_checks_agree_1e-6"] is True
    assert got["params"]["collective_mb"] == 16.0


def test_sweep_transpose_is_a_skip_record_on_a_non_square_grid(tmp_path):
    payload = sweep.run_sweep_suite(
        str(tmp_path), topo_names=["mphx-4p-86x9"],
        scenario_names=["transpose"], device="cpu")
    (row,) = payload["rows"]
    assert row["skipped"] and "square" in row["reason"]
    assert row["reason"] == ref_sweep.get_scenario("transpose").skip_reason(
        ref_sweep.SWEEP_TOPOLOGIES["mphx-4p-86x9"])


def test_cli_sweep_suite_on_the_cpu(tmp_path, capsys):
    assert SUITES == ["table2", "sim", "sweep", "failures", "cosim",
                      "serving", "all"]
    rc = cli_main(["--suite", "sweep", "--topos", "mphx-2p-8x8",
                   "--scenarios", "neighbor_shift", "transpose",
                   "--modes", "minimal", "adaptive", "--loads", "0.5",
                   "1.0", "--simulate", "--sim-backend", "torch",
                   "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    assert "8 routed rows, 0 skipped" in capsys.readouterr().out
    payload = json.loads((tmp_path / "sweep.json").read_text())
    assert payload["params"]["sim_backend"] == "torch"
    assert payload["params"]["device"] == "cpu"
    rows = payload["rows"]
    assert [r["mode"] for r in rows] == ["minimal"] * 2 + ["adaptive"] * 2 \
        + ["minimal"] * 2 + ["adaptive"] * 2
    assert all("fct_p50_us" in r for r in rows if r["mode"] == "minimal")
    assert (tmp_path / "sweep.md").exists()


def test_cli_sim_suite_refuses_unported_cells(tmp_path, capsys):
    """Every cell of the sim suite is ported: on a baseline it routes the
    scenarios and measures the collectives (``--sim-collective-mb`` MiB
    a NIC); what it refuses is, with ``--engine array``, a topology that
    engine cannot route, and a collective on a fabric past
    ``MAX_COLLECTIVE_NICS``: skip records with the reference's
    reasons."""
    rc = cli_main(["--suite", "sim", "--topos", "ft3-small", "--device",
                   "cpu", "--sim-backend", "torch", "--sim-collective-mb",
                   "2", "--out", str(tmp_path)])
    assert rc == 0
    payload = json.loads((tmp_path / "sim.json").read_text())
    assert not [r for r in payload["rows"] if r.get("skipped")]
    assert len(routed(payload)) == 9
    assert {r["engine"] for r in routed(payload)} == {"graph"}
    colls = [r for r in payload["rows"] if r["kind"] == "collective"]
    assert [r["collective"] for r in colls] == list(simsuite.SIM_COLLECTIVES)
    assert {r["bytes_per_nic"] for r in colls} == {2 * 2**20}
    assert payload["params"]["collective_mb"] == 2.0
    # the Table-2 row (66,564 NICs): the collectives are the reference's
    # skip records, reason word for word (no scenario, so nothing routes)
    big = "mphx-4p-86x9"
    got = simsuite._sim_topo_rows(
        sweep.SWEEP_TOPOLOGIES[big], [], (0.5,), 200e-6, 4096, 16.0, "torch",
        "auto", torch.device("cpu"))
    want = ref_simsuite._sim_topo_rows(
        ref_sweep.SWEEP_TOPOLOGIES[big], [], (0.5,), 200e-6, 4096, "numpy",
        "auto", 16.0, sim_backend="numpy")
    assert got == want and len(got) == 3
    assert all(r["skipped"] and "66564 NICs > 4096" in r["reason"]
               for r in got)
    rc = cli_main(["--suite", "sim", "--topos", "ft3-small", "--engine",
                   "array", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    (row,) = json.loads((tmp_path / "sim.json").read_text())["rows"]
    assert row["skipped"] and row["scenario"] == "*"
    assert row["reason"] == "array engine is MPHX-only, got " \
        "3-layer Fat-Tree (small)"
    assert "skipping topology" in capsys.readouterr().err
