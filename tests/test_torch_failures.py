"""The port's failure injection and ``--suite failures`` against the JAX
package's numpy ones, on the CPU.

* ``degrade_graph`` on ``tests/test_failure_props.py``'s grid of 160
  specs over mphx-2p-8x8 and dragonfly-small, one parameter a case: the
  surviving adjacency (multiplicities exactly), tiers, NIC nodes, name,
  ``node_map``, failed switches and edges, ``failed_links``,
  ``total_links`` and ``info()``.
* ``parse_failure_spec`` and ``FailureSpec``: the same values, labels and
  error messages.
* ``run_failures_suite`` on mphx-2p-8x8 and dragonfly-small (specs
  ``link:0.01``, ``link:0.05``, ``link:0.01,plane:1``,
  ``switch:0.03,seed:1``; scenarios uniform and neighbor_shift; all three
  reroute modes) and on ft3-small and dfplus-small (``link:0.05`` at 8
  layers): every column of every row but the walls equal, skip records
  included; of ``time_to_90_s`` only whether it is ``None``.
* The CLI: ``--suite failures --device cpu`` at its defaults under
  ``--trace`` against the reference's CLI (rows, counters, timer counts,
  and the ``failures`` track's spans apart from their times), exit 2 on a
  bad spec with the reference's message, ``--engine array`` skip records
  and the untraced note.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core.dragonfly import Dragonfly as RefDragonfly  # noqa: E402
from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.experiments import run as ref_run  # noqa: E402
from repro.experiments.simsuite import \
    run_failures_suite as ref_failures_suite  # noqa: E402
from repro.sim import failures as ref_failures  # noqa: E402
from repro_torch.core.dragonfly import Dragonfly  # noqa: E402
from repro_torch.core.hyperx import MPHX  # noqa: E402
from repro_torch.experiments import run  # noqa: E402
from repro_torch.experiments.simsuite import (  # noqa: E402
    DEFAULT_FAILURE_SPECS, run_failures_suite)
from repro_torch.sim import failures  # noqa: E402

# the walls, and (of time_to_90_s) all but whether it is None
WALL_KEYS = ("phase_wall_s", "t_offset_s", "sim_wall_s", "time_to_90_s")
SUITE_SPECS = ["link:0.01", "link:0.05", "link:0.01,plane:1",
               "switch:0.03,seed:1"]
SUITE_SCENARIOS = ["uniform", "neighbor_shift"]
GRAPHS = {"mphx": (RefMPHX(n=2, p=8, dims=(8, 8)).build_graph(),
                   MPHX(n=2, p=8, dims=(8, 8)).build_graph()),
          "df": (RefDragonfly(p=2, a=4, h=2, groups=9,
                              name="Dragonfly (small)").build_graph(),
                 Dragonfly(p=2, a=4, h=2, groups=9,
                           name="Dragonfly (small)").build_graph())}


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The graph engine's CPU path is many small ops; under the test
    runner's parallel workers torch's thread pools would oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid_spec(mod, i):
    """``tests/test_failure_props.py``'s case ``i`` of 160."""
    return mod.FailureSpec(
        link_fraction=[0.0, 0.01, 0.05, 0.2, 0.5][i % 5],
        switch_fraction=[0.0, 0.02, 0.1, 0.3][(i // 5) % 4],
        seed=i // 20)


def assert_rows_match(got, want):
    """Every key of every row but the walls equal; ``time_to_90_s`` only
    as None or not."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys(), (a, b)
        for k in a:
            if k == "time_to_90_s":
                assert (a[k] is None) == (b[k] is None), (a, b)
            elif k not in WALL_KEYS:
                assert a[k] == b[k], (k, a, b)


# ------------------------------------------------------ degrade_graph ----


@pytest.mark.parametrize("i", range(160))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_degrade_graph_matches(name, i):
    ref_g, g = GRAPHS[name]
    want = ref_failures.degrade_graph(ref_g, grid_spec(ref_failures, i))
    got = failures.degrade_graph(g, grid_spec(failures, i))
    assert got.graph.adj == want.graph.adj
    assert got.graph.tier == want.graph.tier
    assert got.graph.nic_nodes == want.graph.nic_nodes
    assert got.graph.name == want.graph.name
    assert got.graph.n_switches == want.graph.n_switches
    np.testing.assert_array_equal(got.node_map, want.node_map)
    assert got.failed_switches == want.failed_switches
    assert got.fully_failed_edges == want.fully_failed_edges
    assert got.failed_links == want.failed_links
    assert got.total_links == want.total_links
    assert got.info() == want.info()


# ------------------------------------------------------------ the specs ----


GOOD_SPECS = ["link:0.01", "link:0.01,plane:1", "switch:0.02,seed:3",
              " LINK : 0.5 , seed:7 ,", "plane:0", "", "link:1e-3"]
BAD_SPECS = ["link", "link:x", "plane:1.5", "link:0.01,link:0.02",
             "bogus:1", "seed:-1", "link:-0.1", "link:1.0", "switch:2",
             "link:0.01,,switch"]


@pytest.mark.parametrize("text", GOOD_SPECS)
def test_parse_failure_spec_matches(text):
    want = ref_failures.parse_failure_spec(text)
    got = failures.parse_failure_spec(text)
    assert (got.link_fraction, got.switch_fraction, got.planes_down,
            got.seed) == (want.link_fraction, want.switch_fraction,
                          want.planes_down, want.seed)
    assert got.label() == want.label()
    assert got.is_noop == want.is_noop


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_failure_spec_rejects_like_the_reference(text):
    with pytest.raises(ValueError) as want:
        ref_failures.parse_failure_spec(text)
    with pytest.raises(ValueError) as got:
        failures.parse_failure_spec(text)
    assert str(got.value) == str(want.value)


def test_plane_capacity_factor_matches():
    ref_t, t = RefMPHX(n=4, p=8, dims=(8, 8)), MPHX(n=4, p=8, dims=(8, 8))
    for k in range(4):
        assert failures.plane_capacity_factor(
            t, failures.FailureSpec(planes_down=k)) == \
            ref_failures.plane_capacity_factor(
                ref_t, ref_failures.FailureSpec(planes_down=k))
    with pytest.raises(ValueError, match="planes_down=4 >= 4 planes"):
        failures.plane_capacity_factor(t, failures.FailureSpec(planes_down=4))


def test_time_to_recover_matches():
    rows = [{"phase": "healthy", "delivered_fraction": 0.8,
             "t_offset_s": 0.0, "phase_wall_s": 0.5},
            {"phase": "failed", "delivered_fraction": 0.5,
             "t_offset_s": 0.5, "phase_wall_s": 0.25},
            {"phase": "local_reroute", "delivered_fraction": 0.75,
             "t_offset_s": 0.75, "phase_wall_s": 0.125}]
    for target in (0.5, 0.9, 0.95):
        assert failures.time_to_recover(rows, target) == \
            ref_failures.time_to_recover(rows, target)
    with pytest.raises(ValueError, match="healthy"):
        failures.time_to_recover(rows[1:])


# ------------------------------------------------------------ the suite ----


@pytest.mark.parametrize("spec", SUITE_SPECS)
@pytest.mark.parametrize("fabric", ["mphx-2p-8x8", "dragonfly-small"])
def test_failures_suite_matches(tmp_path, fabric, spec):
    kw = dict(topo_names=[fabric], scenario_names=SUITE_SCENARIOS,
              failure_specs=[spec])
    want = ref_failures_suite(str(tmp_path / "ref"), backend="numpy", **kw)
    got = run_failures_suite(str(tmp_path / "port"), device="cpu", **kw)
    assert_rows_match(got["rows"], want["rows"])
    kinds = {r.get("kind") for r in got["rows"]}
    if got["params"]["n_rows"]:         # dragonfly-small has one plane
        assert {"throughput", "recovery", "recovery_summary"} <= kinds
    else:
        assert spec.endswith("plane:1") and kinds == {None}
    for r in got["rows"]:
        if "conservation_residual" in r:
            assert r["conservation_residual"] < 1e-9
    assert (tmp_path / "port" / "failures.md").is_file()


@pytest.mark.parametrize("fabric", ["ft3-small", "dfplus-small"])
def test_failures_suite_matches_on_the_baselines(tmp_path, fabric):
    kw = dict(topo_names=[fabric], failure_specs=["link:0.05"],
              protection_layers=8)
    want = ref_failures_suite(str(tmp_path / "ref"), backend="numpy", **kw)
    got = run_failures_suite(str(tmp_path / "port"), device="cpu", **kw)
    assert_rows_match(got["rows"], want["rows"])


def test_failures_suite_skip_records_match(tmp_path):
    """A dead plane count, a coordinate-only scenario under switch
    failures, and survivors the failures disconnect."""
    kw = dict(topo_names=["mphx-2p-8x8", "dragonfly-small"],
              scenario_names=["uniform", "transpose"],
              failure_specs=["plane:2", "switch:0.3,seed:2", "link:0.5"],
              reroute_modes=["local"])
    want = ref_failures_suite(str(tmp_path / "ref"), backend="numpy", **kw)
    got = run_failures_suite(str(tmp_path / "port"), device="cpu", **kw)
    assert_rows_match(got["rows"], want["rows"])
    reasons = [r["reason"] for r in got["rows"] if r.get("skipped")]
    assert any("planes_down=2" in r for r in reasons)
    assert any("no graph builder" in r for r in reasons)
    assert any("disconnected" in r for r in reasons)
    assert got["params"]["n_skipped"] == len(reasons)


# -------------------------------------------------------------- the CLI ----


def run_both(tmp_path, *args):
    """Both CLIs with ``args`` under ``--trace``: (payload, trace) each."""
    out = {}
    for name, main, extra in (("ref", ref_run.main, []),
                              ("port", run.main, ["--device", "cpu"])):
        d = tmp_path / name
        rc = main(["--suite", "failures", *args, *extra, "--out", str(d),
                   "--trace", str(d / "trace.json")])
        assert rc == 0
        out[name] = (json.loads((d / "failures.json").read_text()),
                     json.loads((d / "trace.json").read_text()))
    return out["ref"], out["port"]


def test_cli_defaults_match_the_reference(tmp_path, capsys):
    (want, want_tr), (got, got_tr) = run_both(tmp_path)
    assert got["params"]["failure_specs"] == DEFAULT_FAILURE_SPECS
    assert got["params"]["topologies"] == want["params"]["topologies"]
    assert_rows_match(got["rows"], want["rows"])
    # counters equal; timers recorded as often
    assert got["telemetry"]["counters"] == want["telemetry"]["counters"]
    assert {k: v["count"] for k, v in got["telemetry"]["timers"].items()} \
        == {k: v["count"] for k, v in want["telemetry"]["timers"].items()}
    assert got["telemetry"]["counters"]["protection.local_reroutes"] > 0

    # the failures track's spans, apart from their times
    def spans(tr):
        names = {(e["pid"], e["tid"]): (e["args"]["name"])
                 for e in tr["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        return [(names[e["pid"], e["tid"]], e["name"], e["cat"],
                 {k: v for k, v in e["args"].items()})
                for e in tr["traceEvents"] if e["ph"] == "X"]

    got_spans, want_spans = spans(got_tr), spans(want_tr)
    assert got_spans == want_spans
    assert len(got_spans) == sum(1 for r in got["rows"]
                                 if r.get("kind") == "recovery")
    assert got_tr["otherData"]["skipped"] == []
    out = capsys.readouterr().out
    assert "failures: " in out and "rows" in out


@pytest.mark.parametrize("bad", ["link", "link:0.01,link:0.02", "plane:x"])
def test_cli_exits_2_on_a_bad_spec(tmp_path, capsys, bad):
    assert ref_run.main(["--suite", "failures", "--failures", "link:0.01",
                         bad, "--out", str(tmp_path / "ref")]) == 2
    want = capsys.readouterr().err
    assert run.main(["--suite", "failures", "--failures", "link:0.01", bad,
                     "--device", "cpu", "--out", str(tmp_path / "port")]) == 2
    got = capsys.readouterr().err
    assert got == want and got.startswith("error: ")
    assert not (tmp_path / "port").exists()


def test_cli_array_engine_skips_with_the_untraced_note(tmp_path):
    (want, want_tr), (got, got_tr) = run_both(
        tmp_path, "--engine", "array", "--topos", "mphx-2p-8x8",
        "ft3-small")
    assert_rows_match(got["rows"], want["rows"])
    assert all(r["skipped"] for r in got["rows"])
    assert got["params"]["n_rows"] == 0
    assert got_tr["otherData"]["skipped"] == want_tr["otherData"]["skipped"]
