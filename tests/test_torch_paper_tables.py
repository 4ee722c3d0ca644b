"""The port's paper-table modules (``repro_torch.benchmarks``) against the
reference's ``benchmarks/*.py``, their dry-run tables and their runner.

Each module's ``run(quick=True)`` gives the reference's rows: the same
names and the same ``derived`` fields, with what reads the host's clock
masked (the ``us_per_call`` column, ``*_us=``, ``speedup=``, ``ncpu=``,
``gate=``, and a PASS / FAIL beside one of them: a wall-clock claim, not
asserted here).  ``render_tables`` runs on a synthetic ``build/dryrun`` tree
priced with an H100's constants; the runner prints its header, and a module
that raises gives an ``EXCEPTION`` row and exit 1.

``bench_parallel`` does not shrink its grid under ``quick`` (about a minute
a package on this host), so both packages run it here on the same smaller
grid, its module constants patched alike: the same serial / 4-worker /
warm-start sweeps and resource search on fewer cells.  The full grid runs
on the card's host in ``chip_smoke.py``'s entrypoints phase.  The resource
table is in ``tests/test_torch_resource_tables.py``."""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_costing_speed as ref_costing_speed  # noqa: E402
from benchmarks import bench_parallel as ref_parallel            # noqa: E402
from benchmarks import bench_plan_costing as ref_plan_costing    # noqa: E402
from benchmarks import bench_scenarios as ref_scenarios          # noqa: E402
from benchmarks import bench_serving as ref_serving              # noqa: E402
from repro_torch.benchmarks import (bench_costing_speed,         # noqa: E402
                                    bench_parallel, bench_plan_costing,
                                    bench_scenarios, bench_serving,
                                    render_tables)
from repro_torch.benchmarks import run as runner                 # noqa: E402

WALL = re.compile(r"^(\w*speedup\w*|\w*_us|ncpu|gate)=")
SMALL_GRID = {"GRID_ARCHS": ("qwen1.5-0.5b", "mamba2-1.3b"),
              "GRID_SHAPES": ("train_4k", "decode_32k", "chat_2k"),
              "GRID_CLUSTERS": ("pod", "2pod", "v5p-pod"),
              "AFFINITY_ARCHS": ("qwen1.5-0.5b", "mamba2-1.3b"),
              "AFFINITY_SHAPES": ("train_4k", "decode_32k")}
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src"), str(ROOT)]), JAX_PLATFORMS="cpu")


def masked(rows):
    """(name, fields) of each row, what reads the clock masked."""
    out = []
    for row in rows:
        name, _, derived = row.split(",", 2)
        fields = derived.split(";")
        wall = any(WALL.match(f) for f in fields)
        out.append((name, [
            f.split("=")[0] + "=*" if WALL.match(f)
            else "*" if wall and f in ("PASS", "FAIL") else f
            for f in fields]))
    return out


def rows_and_text(mod):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = mod.run(quick=True)
    return rows, buf.getvalue()


@pytest.mark.parametrize("port, ref", [
    (bench_scenarios, ref_scenarios), (bench_plan_costing, ref_plan_costing),
    (bench_costing_speed, ref_costing_speed), (bench_serving, ref_serving)],
    ids=["scenarios", "plan_costing", "costing_speed", "serving"])
def test_rows_are_the_references(port, ref):
    got, got_text = rows_and_text(port)
    want, want_text = rows_and_text(ref)
    assert masked(got) == masked(want)
    assert got_text == want_text          # plan_costing's EXPLAINs
    assert not any("MISMATCH" in r or "EXCEPTION" in r for r in got)


def test_scenario_rows_reproduce_the_paper_switches():
    rows = dict(masked(bench_scenarios.run(quick=True)))
    for name in ("XS", "XL1", "XL2", "XL3", "XL4"):
        assert rows[f"scenarios.{name}"][-1] == "MATCH"


def test_parallel_rows_are_the_references_on_a_smaller_grid(monkeypatch):
    for mod in (bench_parallel, ref_parallel):
        for name, value in SMALL_GRID.items():
            monkeypatch.setattr(mod, name, value)
    got, _ = rows_and_text(bench_parallel)
    want, _ = rows_and_text(ref_parallel)
    assert masked(got) == masked(want)
    assert [r.split(",")[0] for r in got] == [
        "parallel.sweep_serial", "parallel.sweep_jobs4",
        "resource_opt.parallel", "resource_opt.warmstart",
        "parallel.affinity"]
    assert "cells=18" in got[0]
    for row in got[1:4]:
        assert "MISMATCH" not in row and "MATCH" in row


@pytest.mark.parametrize("name", sorted(SMALL_GRID))
def test_the_patched_constants_exist_in_both(name):
    assert getattr(bench_parallel, name) == getattr(ref_parallel, name)


# ------------------------------------------------------------ render_tables

def _artifact(arch, shape, mesh, status="ok", peak=0.0, tag="", bound=2.0):
    d = {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
         "status": status, "why": "pure full-attention arch" if
         status == "skip" else "", "plan": "dp+tp[batch=data,tp=model]",
         "trace_s": 12.0}
    if status == "ok":
        d.update(memory_analysis={"argument_bytes": 1e9, "output_bytes": 1e9,
                                  "temp_bytes": 1e9, "peak_bytes": peak,
                                  "alias_bytes": 0},
                 roofline={"compute_s": 1.0, "memory_s": bound,
                           "collective_s": 0.5, "dominant": "memory_s",
                           "roofline_bound_s": bound},
                 model_flops=4e15, useful_flops_ratio=0.5)
    return d


@pytest.fixture
def dryrun_tree(tmp_path):
    arts = [_artifact("qwen1.5-0.5b", "train_4k", "single", peak=70e9),
            _artifact("qwen1.5-0.5b", "train_4k", "multi", peak=90e9),
            _artifact("gemma3-12b", "long_500k", "single", status="skip"),
            _artifact("qwen1.5-0.5b", "decode_32k", "single", peak=20e9,
                      tag="h1")]
    for d in arts:
        tag = f"_{d['tag']}" if d["tag"] else ""
        (tmp_path / f"dryrun_{d['arch']}_{d['shape']}_{d['mesh']}{tag}"
         f".json").write_text(json.dumps(d))
    return tmp_path


def test_render_tables_prices_an_h100(dryrun_tree):
    assert render_tables.PEAK == 989e12
    assert render_tables.HBM_BUDGET == 80e9
    lines = render_tables.dryrun_table(str(dryrun_tree))
    # 70e9 fits an H100's 80e9 (not the reference's v5e 14.4e9); 90e9 not
    assert "| qwen1.5-0.5b | train_4k | single | ok | dp+tp | 70.0 GB | " \
           "yes | 12 |" in lines
    assert "| qwen1.5-0.5b | train_4k | multi | ok | dp+tp | 90.0 GB | " \
           "**no** | 12 |" in lines
    assert "| gemma3-12b | long_500k | single | SKIP | — | — | — | — |" \
        in lines
    roof = render_tables.roofline_table("single", str(dryrun_tree))
    row = next(r for r in roof if r.startswith("| qwen1.5-0.5b | train_4k"))
    mfu = 4e15 / (8 * 989e12 * 2.0)          # one node: eight cards
    assert f"| {mfu:.3f} |" in row and "| memory |" in row
    multi = render_tables.roofline_table("multi", str(dryrun_tree))
    row = next(r for r in multi if r.startswith("| qwen1.5-0.5b"))
    assert f"| {4e15 / (16 * 989e12 * 2.0):.3f} |" in row
    perf = render_tables.perf_rows(artifact_dir=str(dryrun_tree))
    assert perf == ["qwen1.5-0.5b x decode_32k [h1] plan=dp+tp[batch=data,"
                    "tp=model]: compute=1000.0ms mem=2000.0ms coll=500.0ms "
                    "dom=memory_s"]


def test_render_tables_main(dryrun_tree, capsys):
    render_tables.main(["all", "--artifact-dir", str(dryrun_tree)])
    out = capsys.readouterr().out
    assert out.startswith("## Dry-run matrix")
    assert "## Roofline (one H100 node)" in out and "## Perf iterations" in out
    render_tables.main(["roofline", "--artifact-dir", str(dryrun_tree)])
    assert "Dry-run matrix" not in capsys.readouterr().out


def test_render_tables_carries_no_tpu_constant():
    src = Path(render_tables.__file__).read_text()
    assert "197e12" not in src and "16e9" not in src


# ------------------------------------------------------------------ runner

def test_runner_quick_scenarios_matches_the_references():
    cmd = ["--quick", "--only", "scenarios"]
    got = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", *cmd,
         "--device", "cpu"], env=ENV, capture_output=True, text=True,
        timeout=300)
    want = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "run.py"), *cmd], env=ENV,
        capture_output=True, text=True, timeout=300)
    assert got.returncode == 0 == want.returncode, got.stderr
    lines = got.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert masked(lines[1:]) == masked(want.stdout.splitlines()[1:])


def test_runner_reports_a_raising_module(monkeypatch, capsys):
    def boom(quick=False):
        raise RuntimeError("planted")
    monkeypatch.setattr(bench_scenarios, "run", boom)
    with pytest.raises(SystemExit) as exit_:
        runner.main(["--quick", "--only", "scenarios", "--device", "cpu"])
    assert exit_.value.code == 1
    out = capsys.readouterr().out.splitlines()
    assert out == ["name,us_per_call,derived", "scenarios,0,EXCEPTION"]


def test_runner_order_and_device_binding():
    names = [n for n, _ in runner.runners("cpu")]
    assert names == ["scenarios", "plan_costing", "accuracy",
                     "costing_speed", "resource_opt", "serving", "fusion",
                     "parallel", "roofline", "calibrate"]
    fns = dict(runner.runners("cpu"))
    for name in runner.ON_DEVICE:
        assert fns[name].keywords == {"device": "cpu"}


def test_runner_accuracy_on_the_cpu(capsys):
    runner.main(["--quick", "--only", "accuracy", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("accuracy.f64-S,0,est=")
    assert "tsmm_launches=0" in out[1]
    assert out[2].startswith("accuracy.worst_factor,0,")


def test_runner_loads_no_torch_at_import():
    """``parallel``'s spawn workers import the runner again when it is the
    main module: its import must load the cost model's world only."""
    code = ("import sys, importlib\n"
            "importlib.import_module('repro_torch.benchmarks.run')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
