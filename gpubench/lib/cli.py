"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.

With ``--trace 0`` the result line's metrics are the cell's end-to-end
metrics; with ``--trace 1`` the whole window runs under the profiler and
the metrics are the cell's per-layer metrics, each from its reader in
``gpubench/metrics/``.  Every run decides ``correct`` against the plain
reference after the window and prints each number compared beside its
limit, last on standard error and last in the result line.

``--control fp8`` and ``--fault <name>`` are for setting the limits: the
first judges the reference in the lower precision in the program's place
(``correct`` and the checks are then the control's, and the program's own
numbers go to the ``extra:`` line on standard error), the second plants a
fault under the timed path (``gpubench/lib/faults.py``).  The benchmark's
own runs use neither.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

import torch

from gpubench.lib import device as devmod
from gpubench.lib import faults, spec as specmod
from gpubench.lib.common import Ctx, Outcome


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="gpubench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--fault", choices=faults.FAULTS, default=None)
    return ap.parse_args(argv)


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, *,
             cfg: Optional[dict] = None, mix: Optional[dict] = None,
             checks: Optional[dict] = None, control: Optional[str] = None,
             fault: Optional[str] = None) -> Tuple[Outcome, dict]:
    """Run cell ``name``; the configuration, mix and checks are the cell's
    files unless given (the CPU tests give small ones)."""
    cell = specmod.cell(spec, name)
    cfg = cfg or specmod.config_file(spec, cell["config"])
    mix = mix or specmod.traffic_file(cell["traffic"])
    checks = checks or specmod.checks_file(name)
    driver = __import__(f"gpubench.drivers.{mix['driver']}",
                        fromlist=["run"])
    ctx = Ctx(cell=cell, cfg=cfg, mix=mix, checks=checks,
              reference=specmod.reference_module(cell["config"]),
              seed=seed % (1 << 64), seconds=seconds, trace=traced,
              device=device, t_start=t_start, control=control)
    with faults.planted(fault):
        out = driver.run(ctx)
    return out, metrics_of(spec, name, out, traced)


def metrics_of(spec: dict, name: str, out: Outcome,
               traced: bool) -> Dict[str, dict]:
    """The result line's metrics: the cell's end-to-end ones, or with a
    trace its per-layer ones that have a reading."""
    metrics = {}
    if not traced:
        for m in specmod.end_to_end_of(spec, name):
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
        return metrics
    for m in specmod.per_layer_of(spec, name):
        value = specmod.metric_reader(m["name"]).read(out.readout)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def result_line(out: Outcome, metrics: dict, device: torch.device,
                chips: int, traced: bool) -> dict:
    dev = {"platform": "gpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    if traced and out.summary is not None:
        dev["busy_s"] = out.summary.busy_s
        dev["window_s"] = out.summary.window_s
        line["breakdown"] = {"device_ops": out.summary.top_ops(10),
                             "idle_gaps": out.summary.gaps[:10]}
    line["checks"] = out.checks
    return line


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    spec = specmod.load()
    try:
        cell = specmod.cell(spec, args.workload)
    except KeyError as exc:
        print(exc.args[0], file=sys.stderr)
        return 2
    why_not = devmod.missing_chips(cell["chips"])
    if why_not:
        print(f"cannot run {args.workload}: {why_not}", file=sys.stderr)
        return 2
    print(f"card: {devmod.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out, metrics = run_cell(spec, args.workload, args.seed, args.seconds,
                            bool(args.trace), device, t_start,
                            control=args.control, fault=args.fault)
    bad = devmod.forbidden_loaded()
    if bad:
        print(f"forbidden modules were loaded: {bad}", file=sys.stderr)
        return 3
    if out.extra:
        print("extra: " + json.dumps(out.extra), file=sys.stderr)
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result_line(out, metrics, device, cell["chips"],
                                 bool(args.trace))), flush=True)
    return 0
