"""The port's cost-model examples (``repro_torch.examples``) against the
reference's ``examples/*.py``.

Each reference example is loaded with ``runpy.run_path`` and its ``main()``
called under a patched ``sys.argv``; the port's ``main(argv)`` must print
the same text line for line, search times (``in NNNms``) masked.  The
``--h100`` paths are held to the reference's own ``main`` with its cluster
functions patched to return the reference's ``ClusterConfig`` of the same
H100 meshes (the port's grid, card for card): the same rankings, the same
EXPLAIN, the same winners.  ``linreg_ds``'s scenario table and XS EXPLAIN
equal the reference's ``show_scenarios``, and its estimates the
reference's model's.  ``chip_smoke.py``'s entrypoints helpers are checked
on the CPU runs.  Nothing runs on a device."""
import contextlib
import dataclasses
import io
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import cluster as ref_cluster
from repro.core import estimate as ref_estimate
from repro.core import linreg as ref_linreg
from repro.core.resource import ClusterCandidate as RefCandidate
from repro_torch.core import gpu_clusters
from repro_torch.core.cluster import (h100_multi_node_config,
                                      h100_node_config)
from repro_torch.examples import (autotune_plan, linreg_ds,
                                  optimize_resources, quickstart, sweep_plans)

ROOT = Path(__file__).resolve().parents[1]
PORT = {"quickstart": quickstart, "autotune_plan": autotune_plan,
        "optimize_resources": optimize_resources,
        "sweep_plans": sweep_plans}
TIMED = re.compile(r"in \d+ms")


def masked(text: str):
    return [TIMED.sub("in Nms", line) for line in text.splitlines()]


def printed(fn, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def reference(name: str):
    """The reference example's ``main`` (its module namespace loaded from
    ``examples/<name>.py``)."""
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"))["main"]


def run_reference(main, argv, monkeypatch, **patches) -> str:
    """The reference's ``main()`` under ``sys.argv = [name, *argv]``, with
    names of its module replaced by ``patches``."""
    monkeypatch.setattr(sys, "argv", ["example", *argv])
    for name, value in patches.items():
        monkeypatch.setitem(main.__globals__, name, value)
    return printed(main)


def ref_cc(cc):
    """The reference's ``ClusterConfig`` of one of the port's: every field
    the same, the chip as the reference's ``ChipSpec``."""
    fields = {f.name: getattr(cc, f.name)
              for f in dataclasses.fields(cc) if f.name != "chip"}
    return ref_cluster.ClusterConfig(
        chip=ref_cluster.ChipSpec(**dataclasses.asdict(cc.chip)), **fields)


def ref_h100_grid(*_a, **_k):
    return [RefCandidate(c.cid, ref_cc(c.cc))
            for c in gpu_clusters.enumerate_h100_clusters()]


CASES = [
    ("quickstart", []),
    ("autotune_plan", []),
    ("autotune_plan", ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k"]),
    ("optimize_resources", []),
    ("optimize_resources", ["--arch", "qwen1.5-0.5b", "--shape",
                            "decode_32k", "--objective", "job_cost",
                            "--steps-per-job", "50000"]),
    ("optimize_resources", ["--arch", "qwen1.5-0.5b", "--shape",
                            "decode_32k", "--objective", "slo", "--slo-ms",
                            "50"]),
    ("optimize_resources", ["--arch", "gemma3-12b", "--shape", "chat_2k",
                            "--objective", "ttft_p99"]),
    ("sweep_plans", []),
    ("sweep_plans", ["--archs", "qwen1.5-0.5b", "gemma3-12b", "--shapes",
                     "train_4k", "decode_32k", "--clusters", "pod", "2pod",
                     "--search", "exhaustive"]),
    ("sweep_plans", ["--archs", "qwen1.5-0.5b", "--shapes", "train_4k",
                     "--resources", "--objective", "cost"]),
    ("sweep_plans", ["--archs", "mamba2-1.3b", "--shapes", "decode_32k",
                     "--jobs", "2"]),
]


@pytest.mark.parametrize("name, argv", CASES,
                         ids=[f"{n}{'-' if a else ''}{'-'.join(a[:2])}"
                              for n, a in CASES])
def test_example_prints_the_reference_text(name, argv, monkeypatch):
    want = run_reference(reference(name), argv, monkeypatch)
    got = printed(PORT[name].main, argv)
    assert want.strip()
    assert masked(got) == masked(want)


def test_quickstart_h100_is_the_reference_on_an_h100_node(monkeypatch):
    want = run_reference(reference("quickstart"), [], monkeypatch,
                         single_pod_config=lambda: ref_cc(h100_node_config()))
    assert printed(quickstart.main, ["--h100"]) == want


def test_autotune_h100_is_the_reference_on_h100_nodes(monkeypatch):
    main = reference("autotune_plan")
    want = run_reference(
        main, ["--arch", "qwen1.5-4b"], monkeypatch,
        single_pod_config=lambda: ref_cc(h100_node_config()),
        multi_pod_config=lambda: ref_cc(h100_multi_node_config()))
    got = printed(autotune_plan.main, ["--arch", "qwen1.5-4b", "--h100"])
    label = re.compile(r"^== .*: (\d+) candidates ==$")
    assert [label.sub(r"\1", line) for line in got.splitlines()] == [
        label.sub(r"\1", line) for line in want.splitlines()]
    assert "== two H100 nodes, 4x network:" in got


@pytest.mark.parametrize("argv", [[], ["--objective", "slo", "--slo-ms",
                                       "400"],
                                  ["--arch", "gemma3-12b", "--pod-counts",
                                   "1", "2"]])
def test_optimize_resources_h100_is_the_reference_on_the_grid(argv,
                                                              monkeypatch):
    nodes = (1, 2) if "--pod-counts" in argv else (1, 2, 4)

    def grid(*_a, **_k):
        return [RefCandidate(c.cid, ref_cc(c.cc))
                for c in gpu_clusters.enumerate_h100_clusters(nodes)]
    want = run_reference(reference("optimize_resources"), argv, monkeypatch,
                         enumerate_clusters=grid)
    got = printed(optimize_resources.main, ["--h100", *argv])
    assert masked(got) == masked(want)
    assert "winner: h100-" in got


def test_optimize_resources_h100_serving_defaults_to_ttft(capsys):
    decisions = optimize_resources.main(["--h100", "--shape", "chat_2k"])
    out = capsys.readouterr().out
    assert out.startswith("qwen1.5-0.5b x chat_2k, objective=ttft_p99")
    assert decisions[0].feasible and decisions[0].cluster_id in out


@pytest.mark.parametrize("argv", [["--objective", "cost"],
                                  ["--objective", "job_cost"],
                                  ["--shape", "chat_2k", "--objective",
                                   "tokens_per_dollar"]])
def test_h100_dollar_objectives_raise(argv):
    with pytest.raises(ValueError, match="no price is assumed"):
        optimize_resources.main(["--h100", *argv])


def test_h100_refuses_the_tpu_chip_table():
    with pytest.raises(SystemExit):
        optimize_resources.main(["--h100", "--chips", "tpu_v5e"])


def test_sweep_h100_is_the_reference_on_the_grid(monkeypatch):
    argv = ["--archs", "qwen1.5-0.5b", "mamba2-1.3b", "--shapes",
            "train_4k", "decode_32k", "--resources"]
    want = run_reference(reference("sweep_plans"), argv, monkeypatch,
                         enumerate_clusters=ref_h100_grid)
    got = printed(sweep_plans.main, ["--h100", *argv])
    assert masked(got) == masked(want)
    assert "|h100-" in got


def test_sweep_h100_refuses_a_dollar_objective():
    with pytest.raises(ValueError, match="no price is assumed"):
        sweep_plans.main(["--h100", "--objective", "cost"])


# ---------------------------------------------------------------- linreg_ds

def test_scenario_table_and_xs_explain_are_the_references():
    want = printed(runpy.run_path(
        str(ROOT / "examples" / "linreg_ds.py"))["show_scenarios"])
    got = printed(linreg_ds.show_scenarios)
    assert got == want
    assert "costed plan, scenario XS" in got and got.count("exec=") == 5


@pytest.mark.parametrize("m, n", [(8192, 256), (262144, 1024)])
def test_estimates_are_the_reference_models(m, n):
    """The CPU's estimate is the reference example's (``cpu_host_config``,
    its budgets, the float64 scenario); the card's is the reference model's
    for one H100 (``tpu_budgets``, float32)."""
    cpu = linreg_ds.estimate_small(m, n, "cpu")
    cc = ref_cluster.cpu_host_config()
    prog, _ = ref_linreg.build_linreg_program(
        ref_linreg.Scenario("exec", m, n, dtype="float64"), cc,
        ref_linreg.CompilerBudgets(local_mem=8e9, broadcast_mem=2e9,
                                   block_size=4096))
    assert cpu["est_seconds"] == ref_estimate(prog, cc).breakdown.compute
    card = linreg_ds.estimate_small(m, n, "cuda")
    cc = ref_cc(linreg_ds.h100_single_config())
    prog, choice = ref_linreg.build_linreg_program(
        ref_linreg.Scenario("exec", m, n, dtype="float32"), cc,
        ref_linreg.tpu_budgets(cc))
    assert card["est_seconds"] == ref_estimate(prog, cc).breakdown.compute
    assert (card["chip_spec"], card["exec_type"], card["tsmm_op"]) == (
        "h100_sxm", choice.exec_type, choice.tsmm_op)


def test_main_on_the_cpu_prints_the_table_solves_and_estimate(capsys):
    r = linreg_ds.main(["--m", "2048", "--n", "128", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "== §2: generated plans across Table-1 scenarios ==" in out
    assert out.count("solved 2048x128") == 2
    assert "est / measured" in out and "cpu_host" in out
    assert r["max_abs_err_vs_f64"] < 5e-5 and r["chip_spec"] == "cpu_host"
    assert r["est_over_measured"] == r["est_seconds"] / r["seconds"]


def test_execute_small_on_numpy_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4096, 96)).astype(np.float32)
    y = (x @ rng.standard_normal((96, 1)).astype(np.float32)
         + 0.01 * rng.standard_normal((4096, 1)).astype(np.float32))
    r = linreg_ds.execute_small(device="cpu", x=torch.from_numpy(x),
                                y=torch.from_numpy(y))
    ref = np.linalg.lstsq(x, y, rcond=None)[0]
    assert np.abs(r["beta"].numpy() - ref).max() < 5e-5
    assert r["max_abs_err_vs_f64"] < 5e-5


# ------------------------------------------- chip_smoke's entrypoints phase

@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_reads_each_h100_winner(chip_smoke):
    """The winners the card's phase emits, from the same calls on the
    CPU: feasible, printed, with an estimated step."""
    for name, argv in chip_smoke.ENTRY_EXAMPLES:
        result, text = chip_smoke._captured(PORT[name].main, argv)
        w = chip_smoke._example_winner(name, result)
        assert w["feasible"] and w["est_step_ms"] > 0, (name, argv)
        assert w["winner"].split(": ")[0] in text


def test_chip_smoke_table_verdicts(chip_smoke):
    rows = ["a.x,1.0,n=3;MATCH", "a.y,2,max_abs_err=0;speedup=1.2x;"
            "claim=5x;FAIL", "a.z,0,evals=1/9;PASS",
            "a.w,0,max_abs_err=1e-09;PASS", "a.v,0,MISMATCH('x')",
            "a.u,0,hit_rate=0.1;FAIL", "a.t,0,EXCEPTION"]
    v = chip_smoke._table_verdicts("a", rows)
    assert v["faults"] == [rows[3], rows[4], rows[5], rows[6]]
    assert [c["row"] for c in v["wall_clock_claims"]] == ["a.y"]
    assert v["wall_clock_claims"][0]["verdict"] == "FAIL"
    assert v["gates_passed"] == ["a.z"]
