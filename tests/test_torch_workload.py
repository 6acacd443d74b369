"""The port's multi-tenant workloads (``workload/``,
``experiments/servesuite.py``) and the CLI's new suites against the JAX
package's, on the CPU.

Tolerances: floats within 1e-9 relative, integers, strings, tags and
error messages exact; the samplers, arrivals, flows, caps and the mixed
and isolated runs' ``finish_s`` bit for bit (the draws are numpy's from
the same ``SeedSequence`` children, in the reference's order).  The
reference runs at ``backend="numpy"``.

* ``sample_sizes`` for every ``SizeDist`` kind and both arrival
  processes, for a few seeds;
* ``build_tenant_traffic`` for each preset (flows, tags, caps, request
  traces), ``run_tenant_mix`` with its isolated runs, ``slo_rows``;
* ``run_serving_suite`` at its defaults, with the four tenants, with
  ``duration_ms=20`` and with skip records; two same-seed
  ``serving.json`` byte-identical; the ``workload.*`` counters and the
  tenant spans equal the reference's;
* the CLI's ``--suite serving`` and ``--suite all`` on ``--device cpu``
  and the untraced notes under ``--trace``.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

from repro import workload as ref_workload  # noqa: E402
from repro.experiments import servesuite as ref_servesuite  # noqa: E402
from repro.experiments.sweep import (  # noqa: E402
    SWEEP_TOPOLOGIES as REF_TOPOLOGIES)
from repro.cosim.placement import rank_to_switch as ref_rank_to_switch  # noqa
from repro.models.registry import get_config as ref_get_config  # noqa
from repro.telemetry import TraceRecorder as RefTraceRecorder  # noqa
from repro.telemetry import collecting as ref_collecting  # noqa: E402
from repro.telemetry import recording as ref_recording  # noqa: E402
from repro_torch import workload  # noqa: E402
from repro_torch.cosim.placement import rank_to_switch  # noqa: E402
from repro_torch.experiments import servesuite  # noqa: E402
from repro_torch.experiments.run import main as cli_main  # noqa: E402
from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.telemetry import (TraceRecorder, collecting,  # noqa: E402
                                   recording)

WALLS = ("sim_wall_s",)
DISTS = [dict(kind="fixed", mean=100.0),
         dict(kind="lognormal", mean=800.0, sigma=1.0),
         dict(kind="pareto", alpha=1.2, lo=128.0, hi=32768.0),
         dict(kind="pareto", alpha=1.0, lo=10.0, hi=1e5),
         dict(kind="empirical", name="websearch"),
         dict(kind="empirical", name="datamining"),
         dict(kind="empirical", name="hadoop")]
SEEDS = [0, 7, 2**40 + 3]
ALL4 = ["chat", "burst", "train", "web"]


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
            assert a == b or (math.isnan(a) and math.isnan(b)), path
        else:
            assert b == pytest.approx(a, rel=1e-9, abs=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def bits_equal(a, b) -> bool:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def flow_rows(flows):
    return [(f.src, f.dst, f.size_bytes, f.start_s, f.tag) for f in flows]


def spec_pair(name, **changes):
    """(port spec, reference spec) of one preset."""
    spec = servesuite.tenant_specs([name])[0]
    ref_spec = ref_servesuite.tenant_specs([name])[0]
    if changes:
        spec = dataclasses.replace(spec, **changes)
        ref_spec = dataclasses.replace(ref_spec, **changes)
    return spec, ref_spec


# ------------------------------------------------------------ samplers ----


@pytest.mark.parametrize("dist", DISTS, ids=lambda d: "-".join(
    str(v) for v in d.values()))
def test_samplers_match_reference(dist):
    d, rd = workload.SizeDist(**dist), ref_workload.SizeDist(**dist)
    assert workload.mean_size(d) == ref_workload.mean_size(rd)
    for seed in SEEDS:
        for n in (0, 1, 700):
            assert bits_equal(
                workload.sample_sizes(d, n, np.random.default_rng(seed)),
                ref_workload.sample_sizes(rd, n,
                                          np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals_match_reference(seed):
    for rate, dur in ((400.0, 0.25), (4000.0, 0.02), (0.0, 1.0)):
        assert bits_equal(
            workload.poisson_arrivals(rate, dur, np.random.default_rng(seed)),
            ref_workload.poisson_arrivals(rate, dur,
                                          np.random.default_rng(seed)))
        for b in (1.0, 6.0):
            assert bits_equal(
                workload.mmpp_arrivals(rate, dur, np.random.default_rng(seed),
                                       burstiness=b),
                ref_workload.mmpp_arrivals(rate, dur,
                                           np.random.default_rng(seed),
                                           burstiness=b))


def test_size_dist_errors_match_reference():
    for bad in (dict(kind="weibull"), dict(kind="empirical", name="x"),
                dict(kind="pareto", lo=5.0, hi=1.0)):
        with pytest.raises(ValueError) as got:
            workload.SizeDist(**bad)
        with pytest.raises(ValueError) as want:
            ref_workload.SizeDist(**bad)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------- tenants ----


@pytest.mark.parametrize("preset", ALL4)
@pytest.mark.parametrize("topo_name", ["mphx-2p-8x8", "dragonfly-small"])
def test_build_tenant_traffic_matches_reference(preset, topo_name):
    topo, ref_topo = SWEEP_TOPOLOGIES[topo_name], REF_TOPOLOGIES[topo_name]
    sw = rank_to_switch(topo)
    assert np.array_equal(sw, ref_rank_to_switch(ref_topo))
    spec, ref_spec = spec_pair(preset)
    for base, seed in ((0, 0), (5, 11)):
        t = workload.build_tenant_traffic(spec, topo, sw, base,
                                          np.random.default_rng(seed))
        rt = ref_workload.build_tenant_traffic(
            ref_spec, ref_topo, sw, base, np.random.default_rng(seed))
        assert (t.name, t.kind, t.nic_base, t.n_nics) == \
            (rt.name, rt.kind, rt.nic_base, rt.n_nics)
        assert flow_rows(t.flows) == flow_rows(rt.flows)
        assert bits_equal(t.caps_gbps, rt.caps_gbps)
        assert t.payload_bytes == rt.payload_bytes
        same(t.meta, rt.meta)
        assert workload.tenant_kind(spec) == t.kind
        if t.serving is not None:
            w, rw = t.serving, rt.serving
            for k in ("arrival_s", "prompt_tokens", "kv_bytes",
                      "kv_start_s", "prefill_replica", "decode_replica",
                      "caps_gbps", "local_requests"):
                assert bits_equal(getattr(w, k), getattr(rw, k)), k
            assert w.intra_bytes == rw.intra_bytes
            assert w.n_requests == rw.n_requests > 0
    assert workload.kv_bytes_per_token(get_config("mixtral-8x22b")) == \
        ref_workload.kv_bytes_per_token(ref_get_config("mixtral-8x22b"))


def test_tenant_errors_match_reference():
    topo, ref_topo = SWEEP_TOPOLOGIES["mpft-2p-small"], \
        REF_TOPOLOGIES["mpft-2p-small"]
    sw = rank_to_switch(topo)
    for preset in ("chat", "train", "web"):
        spec, ref_spec = spec_pair(preset)
        with pytest.raises(ValueError) as got:
            workload.build_tenant_traffic(spec, topo, sw, 30,
                                          np.random.default_rng(0))
        with pytest.raises(ValueError) as want:
            ref_workload.build_tenant_traffic(ref_spec, ref_topo, sw, 30,
                                              np.random.default_rng(0))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown arrival"):
        workload.ServingTenantSpec("x", arrival="bursty")
    with pytest.raises(TypeError, match="unknown tenant spec type"):
        workload.tenant_kind(object())


MIXES = {
    "mphx-4": ("mphx-2p-8x8", ALL4, dict(duration_s=0.02)),
    "dragonfly-3": ("dragonfly-small", ["chat", "burst", "train"],
                    dict(duration_s=0.03)),
    "ft3-bursty": ("ft3-small", ["burst", "web"],
                   dict(duration_s=0.02, rate_hz=2000.0)),
}


def mix_pair(name, seed=3, **kw):
    tn, presets, changes = MIXES[name]
    specs, ref_specs = [], []
    for p in presets:
        ch = {k: v for k, v in changes.items()
              if hasattr(servesuite.TENANT_PRESETS[p], k)}
        s, rs = spec_pair(p, **ch)
        specs.append(s)
        ref_specs.append(rs)
    got = workload.run_tenant_mix(SWEEP_TOPOLOGIES[tn], specs, seed=seed,
                                  device="cpu", **kw)
    want = ref_workload.run_tenant_mix(REF_TOPOLOGIES[tn], ref_specs,
                                       seed=seed, sim_backend="numpy")
    return got, want


@pytest.mark.parametrize("name", sorted(MIXES))
def test_tenant_mix_matches_reference_bit_for_bit(name):
    got, want = mix_pair(name)
    assert bits_equal(got.caps_gbps, want.caps_gbps)
    assert got.alpha_local_s == want.alpha_local_s
    for k in ("start_s", "finish_s", "fct_s", "latency_s", "size_bytes"):
        assert bits_equal(getattr(got.mixed, k), getattr(want.mixed, k)), k
    assert list(got.mixed.tags) == list(want.mixed.tags)
    assert got.mixed.n_epochs == want.mixed.n_epochs
    assert sorted(got.isolated) == sorted(want.isolated)
    for t in got.isolated:
        for k in ("finish_s", "fct_s"):
            assert bits_equal(getattr(got.isolated[t], k),
                              getattr(want.isolated[t], k)), (t, k)
    same(workload.slo_rows(got), ref_workload.slo_rows(want))
    for t in got.traffic:
        m = workload.tenant_mask(got.mixed, t.name)
        assert np.array_equal(m, ref_workload.tenant_mask(want.mixed,
                                                          t.name))
        if t.serving is not None:
            ttft, valid = workload.serving_ttft_s(got, t.name)
            rttft, rvalid = ref_workload.serving_ttft_s(want, t.name)
            assert bits_equal(ttft, rttft) and np.array_equal(valid, rvalid)


def test_tenant_mix_without_isolation_and_on_the_plain_backend():
    got, want = mix_pair("mphx-4", include_isolated=False,
                         sim_backend="torch")
    assert got.isolated == {}
    assert bits_equal(got.mixed.finish_s, want.mixed.finish_s)
    rows = workload.slo_rows(got)
    assert all("slowdown_mean" not in r for r in rows)


def test_tenant_mix_counters_and_spans_match_reference():
    rec, ref_rec = TraceRecorder(), RefTraceRecorder()
    with recording(rec), collecting() as mx:
        with ref_recording(ref_rec), ref_collecting() as ref_mx:
            mix_pair("mphx-4")
    counters = mx.snapshot()["counters"]
    ref_counters = ref_mx.snapshot()["counters"]
    keys = [k for k in ref_counters if k.startswith("workload.")]
    assert len(keys) == 3 * 4 - 2 + 1
    for k in keys + ["sim.runs", "sim.flows", "sim.epochs",
                     "incidence.cache_hits", "incidence.cache_misses"]:
        assert counters[k] == ref_counters[k], k

    def tenant_spans(events):
        return [(e["name"], e["ts"], e["dur"], e["args"]) for e in events
                if e.get("cat") == "tenant"]

    spans = tenant_spans(rec.events)
    # web's 8 NICs sit under one switch of mphx-2p-8x8: no flow, no span
    assert [s[0] for s in spans] == ["chat", "burst", "train"]
    same(spans, tenant_spans(ref_rec.events))


def test_tenant_mix_refusals_match_reference():
    small = SWEEP_TOPOLOGIES["mpft-2p-small"]
    spec, ref_spec = spec_pair("train", n_ranks=64)
    with pytest.raises(ValueError) as got:
        workload.run_tenant_mix(small, [spec], device="cpu")
    with pytest.raises(ValueError) as want:
        ref_workload.run_tenant_mix(REF_TOPOLOGIES["mpft-2p-small"],
                                    [ref_spec])
    assert str(got.value) == str(want.value)
    # every tenant under one switch of a large fabric: no fabric flow
    chat, _ = spec_pair("chat")
    with pytest.raises(ValueError, match="produced no fabric flows"):
        workload.run_tenant_mix(SWEEP_TOPOLOGIES["mphx-8p-256"], [chat],
                                device="cpu")


# ---------------------------------------------------------------- suite ----

SUITES = {
    "defaults": {},
    "four-tenants": dict(tenant_names=ALL4),
    "four-tenants-20ms": dict(tenant_names=ALL4, duration_ms=20.0),
    "skips": dict(topo_names=["mpft-2p-small", "mphx-8p-256",
                              "mphx-2p-8x8"],
                  tenant_names=["chat", "burst", "train"],
                  duration_ms=10.0,
                  rate_scale=2.0, seed=5),
}


@pytest.mark.parametrize("name", sorted(SUITES))
def test_serving_suite_matches_reference(tmp_path, name):
    kw = SUITES[name]
    got = servesuite.run_serving_suite(str(tmp_path / "port"),
                                       device="cpu", **kw)
    want = ref_servesuite.run_serving_suite(str(tmp_path / "ref"),
                                            sim_backend="numpy", **kw)
    same(got["rows"], want["rows"])
    for k in ("topologies", "tenants", "seed", "duration_ms", "rate_scale",
              "tenant_specs", "n_rows", "n_skipped"):
        same(got["params"][k], want["params"][k], k)
    assert got["schema_version"] == 7 and got["suite"] == "serving"
    md = (tmp_path / "port" / "serving.md").read_text()
    assert "Per-tenant SLOs" in md
    if name == "skips":
        assert got["params"]["n_skipped"] == 2
        assert "Skipped" in md


@pytest.mark.parametrize("where,err,skipped", [
    ("make_router", ValueError, True),
    ("make_router", NotImplementedError, True),
    ("run_tenant_mix", ValueError, True),
    ("run_tenant_mix", NotImplementedError, False)])
def test_serving_suite_skips_what_the_reference_skips(tmp_path, monkeypatch,
                                                       where, err, skipped):
    """As the reference: a router that cannot be built, or a mix that
    produces no fabric flows, is a skip record; any other failure of the
    mix's simulation propagates."""
    def refuse(*args, **kwargs):
        raise err("refused")

    monkeypatch.setattr(servesuite, where, refuse)
    run = lambda: servesuite.run_serving_suite(  # noqa: E731
        str(tmp_path), topo_names=["mphx-2p-8x8"], tenant_names=["chat"],
        duration_ms=10.0, device="cpu")
    if not skipped:
        with pytest.raises(err, match="refused"):
            run()
        return
    got = run()
    assert got["rows"] == [{"topology": "mphx-2p-8x8", "skipped": True,
                            "reason": "refused"}]


def test_serving_json_is_byte_identical_across_runs(tmp_path):
    kw = dict(tenant_names=ALL4, duration_ms=20.0, seed=7,
              topo_names=["mphx-2p-8x8", "dragonfly-small"])
    for d in ("a", "b"):
        servesuite.run_serving_suite(str(tmp_path / d), device="cpu", **kw)
    a = (tmp_path / "a" / "serving.json").read_bytes()
    assert a == (tmp_path / "b" / "serving.json").read_bytes()
    servesuite.run_serving_suite(str(tmp_path / "c"), device="cpu",
                                 **{**kw, "seed": 8})
    assert a != (tmp_path / "c" / "serving.json").read_bytes()
    with pytest.raises(ValueError, match="unknown tenant preset"):
        servesuite.tenant_specs(["nope"])


def test_serving_cli_and_untraced_notes(tmp_path):
    trace = tmp_path / "t.json"
    rc = cli_main(["--suite", "serving", "--topos", "mphx-2p-8x8",
                   "--tenants", "chat", "train", "--seed", "3",
                   "--serving-duration-ms", "10", "--device", "cpu",
                   "--out", str(tmp_path), "--trace", str(trace)])
    assert rc == 0
    payload = json.loads((tmp_path / "serving.json").read_text())
    assert payload["params"]["n_rows"] == 2
    counters = payload["telemetry"]["counters"]
    assert counters["workload.mixes"] == 1
    t = json.loads(trace.read_text())
    assert t["otherData"]["skipped"] == []
    assert {e["name"] for e in t["traceEvents"]
            if e.get("cat") == "tenant"} == {"chat", "train"}
    # a fabric whose tenants all sit on one switch: skip record and note
    rc = cli_main(["--suite", "serving", "--topos", "mphx-8p-256",
                   "--tenants", "chat", "--device", "cpu",
                   "--out", str(tmp_path), "--trace", str(trace)])
    assert rc == 0
    t = json.loads(trace.read_text())
    assert t["otherData"]["skipped"] == [{
        "name": "serving", "traced": False,
        "reason": "suite produced no trace events (all cells skipped)"}]


def test_cli_suite_all_runs_every_suite_in_order(tmp_path, capsys):
    rc = cli_main(["--suite", "all", "--topos", "mphx-2p-8x8",
                   "--scenarios", "uniform", "--loads", "0.5",
                   "--modes", "minimal", "--failures", "link:0.05",
                   "--reroute-modes", "none", "--ranks", "32",
                   "--config", "mixtral-8x22b", "--tenants", "chat",
                   "train", "--serving-duration-ms", "10",
                   "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    order = [line.split(":")[0] for line in out.splitlines()]
    assert order == ["table2", "sweep", "sim", "cosim", "serving",
                     "failures"]
    for suite in order:
        assert (tmp_path / f"{suite}.json").exists()
        assert (tmp_path / f"{suite}.md").exists()
