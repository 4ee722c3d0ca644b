"""The port's dry run (``repro_torch.launch.dryrun``) and its roofline table
(``repro_torch.benchmarks.bench_roofline``).

One cell, qwen1.5-0.5b ``decode_32k`` on ``single`` (one H100 node's fake
``(1, 8)`` mesh), runs in a subprocess into ``tmp_path`` and must come back
``ok`` (the reference's ``test_one_cell_compiles_in_subprocess``); its
artifact carries the reference's keys; a ``long_500k`` cell of a
full-attention arch is skipped for the reference's own reason; and
``bench_roofline.run`` reads the artifact and fits it against an H100's
80e9 bytes.  Nothing runs on a device: the step is traced on fake
``DTensor``s over the fake process group.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"status", "plan", "plan_fields", "analytical_time_s",
        "analytical_hbm_gb", "memory_analysis", "compiled_cost", "roofline",
        "collectives_by_kind", "roofline_components", "model_flops",
        "useful_flops_ratio"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
               "alias_bytes"}


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = (
        "from repro_torch.launch.dryrun import run_cell;"
        "r = run_cell('qwen1.5-0.5b', 'decode_32k', 'single',"
        f" artifact_dir=r'{out_dir}', force=True);"
        "print('STATUS=' + r['status']);"
        "assert r['status'] == 'ok', r.get('traceback')"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "STATUS=ok" in out.stdout, out.stdout + out.stderr
    return out_dir


def test_one_cell_traces_in_subprocess(cell):
    path = os.path.join(cell, "dryrun_qwen1.5-0.5b_decode_32k_single.json")
    with open(path) as f:
        d = json.load(f)
    assert d["status"] == "ok"
    assert d["compiled_cost"]["num_devices"] == 8
    assert d["compiled_cost"]["flops_per_device"] > 0


def test_artifact_carries_the_reference_keys(cell):
    with open(os.path.join(
            cell, "dryrun_qwen1.5-0.5b_decode_32k_single.json")) as f:
        d = json.load(f)
    assert KEYS <= set(d)
    assert set(d["memory_analysis"]) == MEMORY_KEYS
    assert d["memory_analysis"]["argument_bytes"] > 0
    r = d["roofline"]
    assert r["source"] == "components" and r["memory_s"] > 0
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert "error" not in d["roofline_components"]
    assert d["model_flops"] > 0 and d["useful_flops_ratio"] > 0
    assert d["plan_fields"]["batch_axes"]


def test_inapplicable_cell_is_skipped_for_the_reference_reason(tmp_path):
    from repro_torch.launch.dryrun import run_cell
    r = run_cell("qwen1.5-0.5b", "long_500k", "multi",
                 artifact_dir=str(tmp_path))
    assert r["status"] == "skip" and r["why"].startswith("skip:")
    assert os.path.exists(tmp_path / "dryrun_qwen1.5-0.5b_long_500k_multi.json")


def test_bench_roofline_reads_the_artifact(cell):
    from repro_torch.benchmarks import bench_roofline
    rows = bench_roofline.run(artifact_dir=str(cell))
    assert len(rows) == 1
    name, bound_us, derived = rows[0].split(",", 2)
    assert name == "roofline.qwen1.5-0.5b|decode_32k|single"
    assert float(bound_us) > 0 and "dom=" in derived and "fits=" in derived
    d = bench_roofline.load_artifacts(str(cell))[0]
    assert bench_roofline.hbm_budget(d) == 80e9
    used = d["memory_analysis"]["peak_bytes"]
    assert ("fits=True" in derived) == (used <= 80e9)
