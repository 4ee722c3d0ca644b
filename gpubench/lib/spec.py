"""``BENCHMARK.json`` and the files it names.

The harness is driven by data: a cell (``workloads`` entry) names its
configuration and its traffic mix, and everything that belongs to one of
them sits in a file of its own, found by name:

* ``configs[*].file``                      the configuration as it is run;
* ``gpubench/traffic/<traffic>.json``      the traffic mix's parameters,
  with ``"driver"`` naming the general generator in ``gpubench/drivers/``;
* ``gpubench/checks/<cell>.json``          the cell's correctness limits;
* ``gpubench/reference/<config>.py``       the plain reference;
* ``gpubench/metrics/<metric>.py``         each per-layer metric's reader.

A later change adds a cell, a mix, a configuration or a metric by adding
such files and entries; no file here needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH = Path(__file__).resolve().parents[1]      # gpubench/
ROOT = BENCH.parent                              # the checkout

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def config_file(spec: dict, name: str, root: Path = ROOT) -> dict:
    return read_json(root / config_entry(spec, name)["file"])


def traffic_file(traffic: str, bench: Path = BENCH) -> dict:
    return read_json(bench / "traffic" / f"{traffic}.json")


def checks_file(cell_name: str, bench: Path = BENCH) -> dict:
    return read_json(bench / "checks" / f"{cell_name}.json")


def load_module(path: Path, tag: str) -> ModuleType:
    """A module of the benchmark by its file (names may hold dots)."""
    mod_name = "gpubench_" + tag + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(config: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "reference" / f"{config}.py", "reference")


def metric_reader(metric: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "metrics" / f"{metric}.py", "metric")


def end_to_end_of(spec: dict, cell_name: str) -> List[dict]:
    """The cell's end-to-end metrics: those without ``workloads`` and those
    that list it."""
    return [m for m in spec["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_of(spec: dict, cell_name: str) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    ``workloads`` whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(spec, cell_name)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def problems(spec: dict, root: Path = ROOT) -> List[str]:
    """What in ``spec`` breaks the benchmark's own naming rules or names a
    file that is not there (empty when none)."""
    out: List[str] = []

    def name_ok(what: str, value: str) -> None:
        if not isinstance(value, str) or not NAME_RE.match(value):
            out.append(f"{what}: bad name {value!r}")

    def line_ok(what: str, value: str) -> None:
        if (not isinstance(value, str) or not 1 <= len(value) <= 200
                or "\n" in value or "\t" in value):
            out.append(f"{what}: bad text {value!r}")

    for word in spec["command"]:
        line_ok("command", word)
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        name_ok("config", c["name"])
        line_ok(f"{c['name']}.source", c["source"])
        line_ok(f"{c['name']}.why", c["why"])
        for key in c["reduced"]:
            name_ok(f"{c['name']}.reduced", key)
        if not (root / c["file"]).is_file():
            out.append(f"{c['name']}: no file {c['file']}")
    cells = set()
    for w in spec["workloads"]:
        name_ok("workload", w["name"])
        name_ok(f"{w['name']}.config", w["config"])
        name_ok(f"{w['name']}.traffic", w["traffic"])
        line_ok(f"{w['name']}.why", w["why"])
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        for path in (BENCH / "traffic" / f"{w['traffic']}.json",
                     BENCH / "checks" / f"{w['name']}.json",
                     BENCH / "reference" / f"{w['config']}.py"):
            if not path.is_file():
                out.append(f"{w['name']}: no file {path.relative_to(root)}")
        cells.add(w["name"])
    names = set()
    for m in spec["end_to_end"] + spec["per_layer"]:
        name_ok("metric", m["name"])
        if m["name"] in names:
            out.append(f"metric {m['name']} twice")
        names.add(m["name"])
        if not isinstance(m["unit"], str) or not UNIT_RE.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: unknown cell {c}")
    for m in spec["per_layer"]:
        line_ok(f"{m['name']}.layer", m["layer"])
        if not (BENCH / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader")
    return out
