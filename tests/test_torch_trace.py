"""The port's fabric flight recorder against the JAX package's.

The staggered case of ``tests/test_telemetry.py`` traced by both
packages (the reference through its numpy loop): the same events, equal
journal edge ids and active-flow counts, no dropped epochs, ``t``, ``dt``
and utilization equal bit for bit (so within the 1e-9 of the makespan
and the 1e-9 that the port is held to on the card) and one row an
epoch.  The stall epoch on incidences with a
zero-capacity edge, the bounded journal and flow spans, the link
selection, recording's inertness (outputs equal bit for bit with and
without a recorder), the Perfetto export, the artifact's ``telemetry``
block and the CLI's ``--trace``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro.core.hyperx import MPHX as RefMPHX  # noqa: E402
from repro.core.netsim import make_router as ref_make_router  # noqa: E402
from repro.core.routing_vec import (  # noqa: E402
    neighbor_shift_demands as ref_shift, uniform_demands as ref_uniform)
from repro.experiments.artifacts import (  # noqa: E402
    artifact_payload as ref_artifact_payload)
from repro.experiments.run import main as ref_cli  # noqa: E402
from repro.sim.events import simulate_incidence as ref_simulate  # noqa
from repro.sim.fairshare import FlowIncidence as RefIncidence  # noqa: E402
from repro.sim.fairshare import flow_incidence as ref_flow_incidence  # noqa
from repro.telemetry import (  # noqa: E402
    LinkSeriesPolicy as RefPolicy, TraceRecorder as RefRecorder,
    collecting as ref_collecting, recording as ref_recording,
    validate_trace as ref_validate)
from repro_torch.convert import incidence_from_arrays  # noqa: E402
from repro_torch.experiments.artifacts import artifact_payload  # noqa: E402
from repro_torch.experiments.run import main as cli  # noqa: E402
from repro_torch.sim.events import simulate_incidence  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    LinkSeriesPolicy, TraceRecorder, collecting, get_metrics, get_recorder,
    recording, validate_trace)

BACKENDS = ("torch", "cuda")


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def as_port(ref_inc):
    return incidence_from_arrays(ref_inc.flow, ref_inc.edge, ref_inc.frac,
                                 ref_inc.n_flows, ref_inc.capacity,
                                 device="cpu")


def staggered_case(scenario=ref_shift, seed=11, dims=(8, 8)):
    """The reference's ``_staggered_case`` (mphx-2p-8x8, 800 Gbps a NIC,
    sizes up to 4 MiB, starts within 200 us), or another fabric's."""
    topo = RefMPHX(n=2, p=dims[0], dims=dims)
    router = ref_make_router(topo, backend="numpy")
    dem = scenario(topo, 800.0)
    inc = ref_flow_incidence(router, dem, "minimal")
    caps = np.asarray(dem.gbps, dtype=np.float64)
    rng = np.random.default_rng(seed)
    size = rng.uniform(0.2, 1.0, inc.n_flows) * (1 << 22)
    start = rng.uniform(0.0, 200e-6, inc.n_flows)
    return inc, size, caps, start


def traced_pair(ref_inc, size, caps, start, backend, **rec_kw):
    """The same simulation under both packages' recorders:
    ``(ref recorder, ref result, port recorder, port result)``."""
    want = RefRecorder(**rec_kw)
    with ref_recording(want):
        ref_res = ref_simulate(ref_inc, size, caps, start_s=start,
                               backend="numpy")
    got = TraceRecorder(**{k: (LinkSeriesPolicy(**vars(v))
                               if isinstance(v, RefPolicy) else v)
                           for k, v in rec_kw.items()})
    with recording(got):
        res = simulate_incidence(as_port(ref_inc), size, caps, start_s=start,
                                 backend=backend, device="cpu")
    return want, ref_res, got, res


def assert_journals_match(want, got, makespan):
    assert [(e["ph"], e["name"]) for e in got.events] == \
        [(e["ph"], e["name"]) for e in want.events]
    assert len(got.journals) == len(want.journals) == 1
    jw, jg = want.journals[0], got.journals[0]
    assert jg["label"] == jw["label"]
    assert jg["edge_ids"] == jw["edge_ids"]
    assert jg["active_flows"] == jw["active_flows"]
    assert jg["dropped_epochs"] == jw["dropped_epochs"]
    # on the CPU the port's clock and loads are the numpy loop's bits
    for key in ("t_s", "dt_s", "util"):
        a, b = np.asarray(jg[key]), np.asarray(jw[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario,seed,dims", [
    ("neighbor_shift", 11, (8, 8)), ("uniform", 3, (4, 4))])
def test_staggered_journal_matches_the_reference(backend, scenario, seed,
                                                 dims):
    build = {"neighbor_shift": ref_shift, "uniform": ref_uniform}[scenario]
    ref_inc, size, caps, start = staggered_case(build, seed, dims)
    want, ref_res, got, res = traced_pair(ref_inc, size, caps, start,
                                          backend)
    assert res.n_epochs == ref_res.n_epochs
    assert_journals_match(want, got, ref_res.makespan_s)
    j = got.journals[0]
    assert j["dropped_epochs"] == 0
    assert len(j["t_s"]) == len(j["util"]) == res.n_epochs
    pol = LinkSeriesPolicy()
    assert 0 < len(j["edge_ids"]) <= pol.top_k + pol.reservoir
    assert all(len(row) == len(j["edge_ids"]) for row in j["util"])
    # every event's values, spans and counters alike
    assert got.events == want.events


def all_stall_incidence():
    """Flow 2 runs first; flows 0 and 1 arrive after it finished and
    cross only a zero-capacity edge, so every active flow stalls at once
    (the reference's ``dt = 0`` journal row)."""
    return RefIncidence(flow=np.array([0, 1, 1, 2]),
                        edge=np.array([1, 0, 1, 2]),
                        frac=np.array([1.0, 1.0, 0.5, 1.0]), n_flows=3,
                        capacity=np.array([4.0, 0.0, 2.0]))


def mixed_stall_incidence():
    """Flows 0 and 1 cross a zero-capacity edge; flow 2 arrives later,
    so the dead flows stall while flow 2 runs on."""
    return RefIncidence(flow=np.array([0, 0, 1, 2]),
                        edge=np.array([0, 1, 1, 2]),
                        frac=np.array([1.0, 1.0, 0.5, 1.0]), n_flows=3,
                        capacity=np.array([4.0, 0.0, 2.0]))


STALL_CASES = {
    "all-stall": (all_stall_incidence, np.array([1e6, 2e6, 5e5]),
                  np.array([3.0, 3.0, 1.0]), np.array([1e-2, 1e-2, 0.0])),
    "mixed": (mixed_stall_incidence, np.array([1e6, 2e6, 5e5]),
              np.array([3.0, 3.0, 1.0]), np.array([0.0, 0.0, 1e-3])),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(STALL_CASES))
def test_stall_epoch_journals_like_the_reference(backend, case):
    make, size, caps, start = STALL_CASES[case]
    ref_inc = make()
    want, ref_res, got, res = traced_pair(ref_inc, size, caps, start,
                                          backend)
    assert res.n_epochs == ref_res.n_epochs
    np.testing.assert_array_equal(res.stalled.numpy(), ref_res.stalled)
    assert_journals_match(want, got, ref_res.makespan_s)
    j = got.journals[0]
    # the zero-capacity edge is journaled, at utilization 0
    assert 1 in j["edge_ids"]
    assert all(row[j["edge_ids"].index(1)] == 0.0 for row in j["util"])
    if case == "all-stall":
        assert j["dt_s"][-1] == 0.0 and j["active_flows"][-1] == 0
        assert j["util"][-1] == [0.0] * len(j["edge_ids"])
    assert got.metrics.value("sim.stalled_flows") == \
        want.metrics.value("sim.stalled_flows") == 2


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("max_epochs", [0, 1, 5])
def test_journal_rows_up_to_max_epochs_match_the_reference(backend,
                                                           max_epochs):
    """The default link selection with the journal cut at no row, one or
    a few: the reference's first rows, bit for bit, and its dropped
    count."""
    ref_inc, size, caps, start = staggered_case()
    want, ref_res, got, res = traced_pair(
        ref_inc, size, caps, start, backend,
        link_policy=RefPolicy(max_epochs=max_epochs))
    j = got.journals[0]
    assert len(j["edge_ids"]) == 24   # one entry an edge
    assert res.n_epochs == ref_res.n_epochs > max_epochs
    assert len(j["t_s"]) == max_epochs
    assert j["dropped_epochs"] == res.n_epochs - max_epochs
    assert got.metrics.value("trace.dropped_epochs") == \
        want.metrics.value("trace.dropped_epochs")
    assert_journals_match(want, got, ref_res.makespan_s)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bounded_journal_and_spans_match_the_reference(backend):
    ref_inc, size, caps, start = staggered_case()
    want, ref_res, got, res = traced_pair(
        ref_inc, size, caps, start, backend,
        link_policy=RefPolicy(top_k=4, reservoir=2, max_epochs=16),
        max_flow_events=8)
    assert res.n_epochs == ref_res.n_epochs > 16
    assert_journals_match(want, got, ref_res.makespan_s)
    j = got.journals[0]
    assert len(j["t_s"]) == 16
    assert j["dropped_epochs"] == res.n_epochs - 16
    snap, ref_snap = got.metrics.snapshot(), want.metrics.snapshot()
    for k in ("trace.dropped_epochs", "trace.dropped_flow_events",
              "sim.runs", "sim.flows", "sim.epochs"):
        assert snap["counters"][k] == ref_snap["counters"][k], k
    assert snap["counters"]["trace.dropped_flow_events"] == \
        ref_inc.n_flows - 8
    spans = [e for e in got.events if e["ph"] == "X"]
    assert [e["name"] for e in spans] == \
        [e["name"] for e in want.events if e["ph"] == "X"]
    assert validate_trace(got.to_json()) == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_link_policy_records_spans_only(backend):
    ref_inc, size, caps, start = staggered_case()
    want, _, got, _ = traced_pair(ref_inc, size, caps, start, backend,
                                  link_policy=None)
    assert got.journals == want.journals == []
    assert [(e["ph"], e["name"], e["ts"]) for e in got.events] == \
        [(e["ph"], e["name"], e["ts"]) for e in want.events]


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_flow_set_journals_no_rows(backend):
    ref_inc = RefIncidence(flow=np.zeros(0, np.int64),
                           edge=np.zeros(0, np.int64), frac=np.zeros(0),
                           n_flows=0, capacity=np.ones(3))
    want, _, got, res = traced_pair(ref_inc, np.zeros(0), 1.0, None,
                                    backend)
    assert res.n_epochs == 0
    assert got.journals == want.journals
    assert got.journals[0]["t_s"] == [] and got.events == want.events == []


POLICIES = [dict(), dict(top_k=4, reservoir=2, seed=3),
            dict(top_k=1, reservoir=0), dict(top_k=200, reservoir=5)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", range(len(POLICIES)))
@pytest.mark.parametrize("scenario", ["neighbor_shift", "uniform"])
def test_link_selection_matches_the_reference(backend, policy, scenario):
    """Uniform routing gives many exactly equal loads: the ties go by
    edge id, as numpy's ``lexsort`` breaks them."""
    build = {"neighbor_shift": ref_shift, "uniform": ref_uniform}[scenario]
    ref_inc, _, caps, _ = staggered_case(build)
    kw = POLICIES[policy]
    want = RefPolicy(**kw).select(ref_inc, caps)
    got = LinkSeriesPolicy(**kw).select(as_port(ref_inc), caps, backend)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, np.sort(got))
    again = LinkSeriesPolicy(**kw).select(as_port(ref_inc), caps, backend)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_recording_is_inert(backend):
    ref_inc, size, caps, start = staggered_case()
    inc = as_port(ref_inc)
    plain = simulate_incidence(inc, size, caps, start_s=start,
                               backend=backend, device="cpu")
    for rec in (TraceRecorder(), TraceRecorder(link_policy=None),
                TraceRecorder(LinkSeriesPolicy(max_epochs=3), 2)):
        with recording(rec):
            traced = simulate_incidence(inc, size, caps, start_s=start,
                                        backend=backend, device="cpu")
        for name in ("finish_s", "fct_s", "edge_bytes", "latency_s"):
            a, b = getattr(traced, name), getattr(plain, name)
            assert torch.equal(a.view(torch.int64), b.view(torch.int64)), \
                name
        assert traced.n_epochs == plain.n_epochs
        assert traced.waterfill_rounds == plain.waterfill_rounds
        assert traced.makespan_s == plain.makespan_s
    assert get_recorder() is None


def test_perfetto_round_trip(tmp_path):
    """The reference's round trip, through both packages' recorders."""
    def fill(rec):
        rec.span("phase_a", 0.0, 1e-3, process="cosim:t", thread="step",
                 args={"kind": "allreduce"})
        rec.span("plane busy", 0.0, 5e-4, process="cosim:t",
                 thread="plane 0")
        rec.instant("failure", 2e-3, process="failures")
        rec.counter("active_flows", 0.0, {"epochs": 4})
        rec.note_skip("table2", "analytic only")
        rec.metrics.inc("sim.runs")
        with rec.wall_span("solve"):
            pass
        return rec

    path = tmp_path / "trace.json"
    fill(TraceRecorder()).export(str(path))
    payload = json.loads(path.read_text())
    assert validate_trace(payload) == [] == ref_validate(payload)
    assert payload["displayTimeUnit"] == "ms"
    evs = payload["traceEvents"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert {m["name"] for m in metas} == {"process_name", "thread_name"}
    span = next(e for e in evs if e["ph"] == "X" and e["name"] == "phase_a")
    assert span["ts"] == 0.0 and span["dur"] == pytest.approx(1e3)
    other = payload["otherData"]
    assert other["generated_by"] == "repro_torch.telemetry"
    assert other["skipped"] == [{"name": "table2", "traced": False,
                                 "reason": "analytic only"}]
    assert other["metrics"]["counters"]["sim.runs"] == 1
    want = fill(RefRecorder()).to_json()
    strip = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
             for e in evs]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                     for e in want["traceEvents"]]
    assert other["skipped"] == want["otherData"]["skipped"]


def test_validate_trace_flags_malformed_events():
    bad = {"traceEvents": [{"ph": "X", "name": "x", "ts": -1.0},
                           {"ph": "?"}, "nope"]}
    assert validate_trace(bad) == ref_validate(bad)
    problems = validate_trace(bad)
    assert any("missing" in p for p in problems)
    assert any("unknown ph" in p for p in problems)
    assert any("not an object" in p for p in problems)
    assert validate_trace({}) == ["traceEvents missing or not a list"]


def test_recording_installs_the_metrics_sink():
    assert get_recorder() is None and not get_metrics().enabled
    with recording() as rec:
        assert get_recorder() is rec and get_metrics() is rec.metrics
        inner = TraceRecorder()
        with recording(inner):
            assert get_recorder() is inner
        assert get_recorder() is rec
    assert get_recorder() is None and not get_metrics().enabled


def test_artifact_telemetry_block():
    assert "telemetry" not in artifact_payload("table2", {}, [])
    assert "telemetry" not in ref_artifact_payload("table2", {}, [])
    with collecting() as mx, ref_collecting() as ref_mx:
        for m in (mx, ref_mx):
            m.inc("incidence.walks", 3)
            m.observe("sim.wall_s", 0.25)
        on = artifact_payload("table2", {}, [])
        ref_on = ref_artifact_payload("table2", {}, [])
    assert on["telemetry"] == ref_on["telemetry"]
    assert on["telemetry"]["counters"]["incidence.walks"] == 3
    assert on["schema_version"] == ref_on["schema_version"]


def test_cli_table2_trace_writes_the_untraced_note(tmp_path):
    notes = {}
    for name, run in (("port", cli), ("ref", ref_cli)):
        trace = tmp_path / f"{name}.json"
        assert run(["--suite", "table2", "--out", str(tmp_path / name),
                    "--trace", str(trace)]) == 0
        payload = json.loads(trace.read_text())
        assert validate_trace(payload) == []
        assert payload["traceEvents"] == []
        notes[name] = payload["otherData"]["skipped"]
        disk = json.loads((tmp_path / name / "table2.json").read_text())
        assert "telemetry" in disk
    assert notes["port"] == notes["ref"]
    assert notes["port"][0]["name"] == "table2"
    assert notes["port"][0]["traced"] is False


def test_cli_sweep_without_simulate_is_untraced(tmp_path):
    trace = tmp_path / "t.json"
    assert cli(["--suite", "sweep", "--topos", "mphx-2p-8x8", "--scenarios",
                "uniform", "--modes", "minimal", "--loads", "0.5",
                "--device", "cpu", "--out", str(tmp_path),
                "--trace", str(trace)]) == 0
    skipped = json.loads(trace.read_text())["otherData"]["skipped"]
    assert [n["name"] for n in skipped] == ["sweep"]
    assert "--simulate" in skipped[0]["reason"]


def test_cli_sim_trace_on_the_cpu(tmp_path, capsys):
    trace = tmp_path / "sim_trace.json"
    assert cli(["--suite", "sim", "--topos", "mphx-2p-8x8", "--scenarios",
                "neighbor_shift", "--loads", "0.5", "--device", "cpu",
                "--out", str(tmp_path), "--trace", str(trace)]) == 0
    assert f"-> {trace}" in capsys.readouterr().out
    payload = json.loads(trace.read_text())
    assert validate_trace(payload) == []
    assert payload["otherData"]["skipped"] == []
    names = {e["name"] for e in payload["traceEvents"]}
    assert {"active_flows", "link_util"} <= names
    assert any(e.get("cat") == "flow" for e in payload["traceEvents"])
    disk = json.loads((tmp_path / "sim.json").read_text())
    counters = disk["telemetry"]["counters"]
    assert counters["sim.runs"] >= 1 and counters["sim.epochs"] >= 1
    assert get_recorder() is None
