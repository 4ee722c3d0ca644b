"""``BENCHMARK.json`` keeps its required shape and naming rules, and a cell
added as files only (a configuration, its reference, a traffic mix, its
checks and an entry) is found and run by the harness unchanged."""
import json
import re
import shutil
import subprocess
import sys

from gpubench.lib import spec

S = spec.load()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_each_entrys_keys():
    assert set(S) == TOP
    for c in S["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in S["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in S["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in S["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in S["end_to_end"]}


def test_names_units_and_files_follow_the_rules():
    assert spec.problems(S) == []
    assert len(json.dumps(S)) < 64 * 1024
    assert 1 <= S["run_seconds"] <= 51
    for p in S["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch")
    for word in S["command"]:
        assert not word.startswith("/") and ".." not in word


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in S["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end_of(S, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.per_layer_of(S, w["name"])
        assert layers and all(m["moves"] in e2e for m in layers)
        assert any("mfu" in m["name"] for m in layers)


def test_bad_names_are_found():
    bad = json.loads(json.dumps(S))
    bad["workloads"][0]["name"] = "a cell"
    bad["per_layer"][0]["unit"] = "tokens per second"
    found = spec.problems(bad)
    assert any("bad name" in p for p in found)
    assert any("bad unit" in p for p in found)


def test_a_cell_added_as_files_only_is_found(tmp_path):
    """Copy the benchmark, add a configuration, its reference, a traffic
    mix, its checks and the entries: the harness runs the new cell on the
    CPU with no file of its own changed."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / "gpubench"
    cfg = json.loads((b / "configs" / "mamba2-1.3b.json").read_text())
    cfg.update(name="mamba2-tiny", n_layers=2, d_model=64, vocab_size=256)
    cfg["ssm"].update(state_size=16, head_dim=16, chunk_size=32)
    (b / "configs" / "mamba2-tiny.json").write_text(json.dumps(cfg))
    shutil.copy(b / "reference" / "mamba2-1.3b.py",
                b / "reference" / "mamba2-tiny.py")
    mix = json.loads((b / "traffic" / "train-b8s2048.json").read_text())
    mix.update(rows=2, seq=64)
    (b / "traffic" / "train-tiny.json").write_text(json.dumps(mix))
    (b / "checks" / "mamba2-tiny.train-tiny.json").write_text(json.dumps(
        {"check_steps": 2, "limits": {"loss_rel": 0.01, "grad1_gap": 0.1,
                                      "change_gap": 0.1}}))
    s = json.loads(json.dumps(S))
    s["configs"].append({"name": "mamba2-tiny", "source": "x",
                         "file": "gpubench/configs/mamba2-tiny.json",
                         "reduced": ["n_layers"], "why": "a test"})
    s["workloads"].append({"name": "mamba2-tiny.train-tiny",
                           "config": "mamba2-tiny", "traffic": "train-tiny",
                           "chips": 1, "why": "a test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "train_tokens_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append("mamba2-tiny.train-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    src = spec.ROOT / "src"
    code = (
        "import sys, time, json, torch\n"
        f"sys.path[:0] = [{str(root)!r}, {str(src)!r}]\n"
        "from gpubench.lib import cli, spec\n"
        "s = spec.load()\n"
        "assert spec.problems(s) == [], spec.problems(s)\n"
        "for traced in (False, True):\n"
        "    out, metrics = cli.run_cell(s, 'mamba2-tiny.train-tiny', 5,\n"
        "        0.2, traced, torch.device('cpu'), time.perf_counter())\n"
        "    print(json.dumps({'correct': out.correct,\n"
        "                      'metrics': sorted(metrics)}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()[-2:]]
    assert lines[0] == {"correct": True,
                        "metrics": ["setup_s", "train_tokens_per_s"]}
    # on the CPU no device trace exists; the counts and the host clock do
    assert lines[1]["correct"] and "train_mfu" in lines[1]["metrics"]
