"""The port's Table 2 against the JAX package's.

``table2()`` (with and without copper access links), ``PAPER_TABLE2``,
``run_table2_suite``'s rows and ``--suite table2`` equal the reference's
exactly; so do the closed forms (latencies, uniform throughput, every
collective estimate, ``compare_topologies``, the topology summaries, Eq.
2 and the Frontier example) on the eight Table-2 rows and the ``*-small``
presets.  ``adversarial_throughput_fraction`` in the three modes within
1e-12 relative of the reference's array engine, and
``pattern_throughput(simulate=True)`` within 1e-9 with the simulator's
loads within 1e-6 of the router's.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.experimental  # noqa: E402

import repro.core.cost as ref_cost  # noqa: E402
import repro.core.dragonfly as ref_dragonfly  # noqa: E402
import repro.core.hyperx as ref_hyperx  # noqa: E402
import repro.core.netsim as ref_netsim  # noqa: E402
import repro.experiments.sweep as ref_sweep  # noqa: E402
from repro.core import routing_vec as ref_rv  # noqa: E402
import repro_torch.core.cost as cost  # noqa: E402
import repro_torch.core.dragonfly as dragonfly  # noqa: E402
import repro_torch.core.hyperx as hyperx  # noqa: E402
import repro_torch.core.netsim as netsim  # noqa: E402
from repro_torch.core import routing_vec as rv  # noqa: E402
from repro_torch.experiments import run_table2_suite  # noqa: E402
from repro_torch.experiments.run import main as cli  # noqa: E402
from repro_torch.experiments.sweep import SWEEP_TOPOLOGIES  # noqa: E402

SMALL = ["mphx-2p-8x8", "mphx-2p-16x16", "ft3-small", "mpft-2p-small",
         "dragonfly-small", "dfplus-small"]
TABLE2 = [t.name for t in ref_cost.table2_topologies()]


@pytest.fixture(autouse=True)
def jax_x64_shim(monkeypatch):
    """jax 0.9 moved ``enable_x64`` out of ``jax.experimental``, where the
    reference imports it from; undone after each test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def topo_pair(name):
    """(reference topology, port topology) of a Table-2 row or preset."""
    if name in SWEEP_TOPOLOGIES:
        return ref_sweep.SWEEP_TOPOLOGIES[name], SWEEP_TOPOLOGIES[name]
    i = TABLE2.index(name)
    return ref_cost.table2_topologies()[i], cost.table2_topologies()[i]


@pytest.mark.parametrize("copper", [False, True])
def test_table2_matches_the_reference(copper):
    want = ref_cost.table2(access_copper=copper)
    got = cost.table2(access_copper=copper)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert [r.row() for r in got] == [r.row() for r in want]
    assert [(r.total_usd, r.per_nic_usd) for r in got] == \
        [(r.total_usd, r.per_nic_usd) for r in want]


def test_paper_table2_and_the_cost_model_match_the_reference():
    assert cost.PAPER_TABLE2 == ref_cost.PAPER_TABLE2
    assert cost.DEFAULT_COST.switch_usd == ref_cost.DEFAULT_COST.switch_usd
    assert cost.DEFAULT_COST.optics_usd == ref_cost.DEFAULT_COST.optics_usd
    for speed in (200, 400, 800, 1600, 1600.4):
        assert cost.DEFAULT_COST.optic_price(speed) == \
            ref_cost.DEFAULT_COST.optic_price(speed)
    with pytest.raises(KeyError, match="no transceiver price"):
        cost.DEFAULT_COST.optic_price(100)
    # every row's N, N_s, N_o against the published table
    for rep, (name, n, ns, no, _) in zip(cost.table2(), cost.PAPER_TABLE2):
        assert (rep.name, rep.n_nics, rep.n_switches, rep.n_optics) == \
            (name, n, ns, no)


@pytest.mark.parametrize("collective_mb,msg_bytes",
                         [(256.0, 4096), (16.0, 512), (1024.0, 65536)])
def test_run_table2_suite_rows_match_the_reference(tmp_path, collective_mb,
                                                   msg_bytes):
    got = run_table2_suite(str(tmp_path / "port"), collective_mb, msg_bytes)
    want = ref_sweep.run_table2_suite(str(tmp_path / "ref"), collective_mb,
                                      msg_bytes)
    assert got["rows"] == want["rows"]
    for a, b in zip(got["rows"], want["rows"]):
        assert list(a) == list(b)
    assert got["params"] == want["params"]
    assert all(r["cost_matches_paper"] for r in got["rows"])
    disk = json.loads((tmp_path / "port" / "table2.json").read_text())
    assert disk["rows"] == json.loads(json.dumps(want["rows"]))
    assert disk["generated_by"] == "repro_torch.experiments"
    assert (tmp_path / "port" / "table2.md").read_text() == \
        (tmp_path / "ref" / "table2.md").read_text()


def test_cli_table2_matches_the_reference(tmp_path, capsys):
    assert cli(["--suite", "table2", "--collective-mb", "64",
                "--out", str(tmp_path)]) == 0
    assert "table2: 8 topologies" in capsys.readouterr().out
    rows = json.loads((tmp_path / "table2.json").read_text())["rows"]
    want = ref_sweep.run_table2_suite(str(tmp_path / "ref"), 64.0, 4096)
    assert rows == json.loads(json.dumps(want["rows"]))
    assert "allreduce_64MB_ms" in rows[0]


def estimates(nm, topo, msg):
    """Every closed form of one topology, as plain values."""
    out = {
        "zero_load": nm.zero_load_latency(topo, msg),
        "zero_load_no_spray": nm.zero_load_latency(topo, msg, spray=False),
        "avg_latency": nm.avg_latency(topo, msg),
        "uniform": nm.uniform_throughput_fraction(topo),
        "alpha": nm._alpha(topo, 3.0, nm.DEFAULT_NET),
    }
    size = 64 * 2**20
    for name, est in (
            ("ring", nm.ring_allreduce_time(topo, size)),
            ("ring_m", nm.ring_allreduce_time(topo, size, m=64)),
            ("hd", nm.hd_allreduce_time(topo, size)),
            ("hd_m", nm.hd_allreduce_time(topo, size, m=100)),
            ("a2a", nm.alltoall_time(topo, size)),
            ("ag", nm.allgather_time(topo, size)),
            ("ag_m", nm.allgather_time(topo, size, m=8)),
            ("ar", nm.allreduce_time(topo, size))):
        out[name] = (dataclasses.asdict(est), est.total_s, est.row())
    if topo.__class__.__name__ == "MPHX":
        est = nm.hierarchical_allreduce_time(topo, size)
        out["hier"] = (dataclasses.asdict(est), est.total_s, est.row())
    return out


@pytest.mark.parametrize("msg", [64, 4096, 1 << 20])
@pytest.mark.parametrize("name", TABLE2 + SMALL)
def test_closed_forms_match_the_reference(name, msg):
    ref_topo, topo = topo_pair(name)
    assert estimates(netsim, topo, msg) == estimates(ref_netsim, ref_topo,
                                                     msg)


@pytest.mark.parametrize("name", TABLE2 + SMALL)
def test_topology_summary_matches_the_reference(name):
    ref_topo, topo = topo_pair(name)
    assert topo.summary() == ref_topo.summary()
    assert topo.bisection_bw_tbps() == ref_topo.bisection_bw_tbps()
    assert topo.bisection_per_nic_gbps() == ref_topo.bisection_per_nic_gbps()


@pytest.mark.parametrize("collective_mb", [16.0, 256.0])
def test_compare_topologies_matches_the_reference(collective_mb):
    ref_topos = [topo_pair(n)[0] for n in TABLE2 + SMALL]
    topos = [topo_pair(n)[1] for n in TABLE2 + SMALL]
    assert netsim.compare_topologies(topos, collective_mb=collective_mb) == \
        ref_netsim.compare_topologies(ref_topos, collective_mb=collective_mb)


def test_eq2_and_mphx_rows_match_the_reference():
    for n, k, D in ((1, 64, 2), (2, 64, 2), (4, 64, 1), (8, 64, 1),
                    (2, 32, 3)):
        assert hyperx.MPHX.max_scale(n, k, D) == \
            ref_hyperx.MPHX.max_scale(n, k, D)
        a, b = hyperx.MPHX.balanced(n, k, D), ref_hyperx.MPHX.balanced(n, k, D)
        assert (a.name, a.n, a.p, a.dims, a.n_nics, a.n_switches,
                a.n_optics) == (b.name, b.n, b.p, b.dims, b.n_nics,
                                b.n_switches, b.n_optics)
    a = hyperx.flattened_butterfly(4, 8, 3, nic_bw_gbps=400.0)
    b = ref_hyperx.flattened_butterfly(4, 8, 3, nic_bw_gbps=400.0)
    assert a.summary() == b.summary()
    assert [t.summary() for t in hyperx.table2_mphx_rows()] == \
        [t.summary() for t in ref_hyperx.table2_mphx_rows()]
    assert dragonfly.frontier_flattening_example() == \
        ref_dragonfly.frontier_flattening_example()


ADVERSARIAL = {"2p-8x8": dict(n=2, p=8, dims=(8, 8)),
               "1p-5": dict(n=1, p=3, dims=(5,)),
               "2p-4x4": dict(n=2, p=4, dims=(4, 4))}


@pytest.mark.parametrize("backend", ("torch", "cuda"))
@pytest.mark.parametrize("mode", ("minimal", "valiant", "adaptive"))
@pytest.mark.parametrize("fabric", sorted(ADVERSARIAL))
def test_adversarial_throughput_matches_the_reference(fabric, mode,
                                                      backend):
    kw = ADVERSARIAL[fabric]
    want = ref_netsim.adversarial_throughput_fraction(
        ref_hyperx.MPHX(**kw), mode, engine="array")
    got = netsim.adversarial_throughput_fraction(
        hyperx.MPHX(**kw), mode, backend=backend, device="cpu")
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    if fabric == "2p-4x4":
        for dim in (0, 1):
            assert netsim.adversarial_throughput_fraction(
                hyperx.MPHX(**kw), mode, dim=dim, backend=backend,
                device="cpu") == pytest.approx(
                    ref_netsim.adversarial_throughput_fraction(
                        ref_hyperx.MPHX(**kw), mode, dim=dim),
                    rel=1e-12, abs=0)


def test_adversarial_throughput_refuses_what_is_not_ported():
    topo = hyperx.MPHX(n=2, p=4, dims=(4, 4))
    with pytest.raises(NotImplementedError, match="repro/core/routing.py"):
        netsim.adversarial_throughput_fraction(topo, engine="dict",
                                               device="cpu")
    with pytest.raises(TypeError, match="adversarial model implemented "
                                        "for MPHX"):
        netsim.adversarial_throughput_fraction(
            SWEEP_TOPOLOGIES["dragonfly-small"], device="cpu")


PATTERNS = {"uniform": (ref_rv.uniform_demands, rv.uniform_demands),
            "neighbor_shift": (ref_rv.neighbor_shift_demands,
                               rv.neighbor_shift_demands),
            "hotspot": (ref_rv.hotspot_demands, rv.hotspot_demands)}


@pytest.mark.parametrize("backend", ("torch", "cuda"))
@pytest.mark.parametrize("mode", ("minimal", "valiant"))
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("fabric", ["2p-4x4", "1p-5"])
def test_pattern_throughput_simulated_matches_the_reference(
        fabric, pattern, mode, backend):
    kw = ADVERSARIAL[fabric]
    ref_build, build = PATTERNS[pattern]
    ref_topo, topo = ref_hyperx.MPHX(**kw), hyperx.MPHX(**kw)
    want = ref_netsim.pattern_throughput(
        ref_topo, ref_build(ref_topo, 800.0), mode=mode, backend="numpy",
        simulate=True)
    got = netsim.pattern_throughput(topo, build(topo, 800.0, device="cpu"),
                                    mode=mode, simulate=True,
                                    backend=backend, device="cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        if k == "sim_max_abs_util_diff":
            assert got[k] <= 1e-6 and v <= 1e-6
        else:
            assert got[k] == pytest.approx(v, rel=1e-9, abs=0), k


def test_pattern_throughput_adaptive_matches_and_refuses_simulate():
    kw = ADVERSARIAL["2p-4x4"]
    ref_topo, topo = ref_hyperx.MPHX(**kw), hyperx.MPHX(**kw)
    want = ref_netsim.pattern_throughput(
        ref_topo, ref_rv.uniform_demands(ref_topo, 800.0), backend="numpy")
    got = netsim.pattern_throughput(
        topo, rv.uniform_demands(topo, 800.0, device="cpu"), device="cpu")
    assert got == pytest.approx(want, rel=1e-9, abs=0)
    with pytest.raises(ValueError, match="static path spread"):
        netsim.pattern_throughput(
            topo, rv.uniform_demands(topo, 800.0, device="cpu"),
            simulate=True, device="cpu")
