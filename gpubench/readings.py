#!/usr/bin/env python3
"""The readings a cell's limits are set from: the numbers its check
compares, over many seeds in one process (set-up is long), at the cell's
own load and a short window; on the seeds of ``--control-seeds`` the
lower-precision control is judged in the program's place too.

    python3 gpubench/readings.py --workload <cell> --seconds 8 \
        --seeds 1,2,3 --control-seeds 1

One JSON line a seed and kind on standard output: the numbers beside the
cell's limits, the verdict, and the reference's seconds.  The benchmark's
own runs (``run.py``) never call this.
"""
import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

# the same caches, paths and environment as a run of run.py
_RUN = importlib.util.spec_from_file_location(
    "gpubench_run", Path(__file__).with_name("run.py"))
_RUN.loader.exec_module(importlib.util.module_from_spec(_RUN))

import torch  # noqa: E402

from gpubench.lib import cli, device as devmod, spec as specmod  # noqa: E402
from gpubench.lib.common import free  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv):
    ap = argparse.ArgumentParser(prog="gpubench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    args = ap.parse_args(argv)
    spec = specmod.load()
    why_not = devmod.missing_chips(specmod.cell(spec, args.workload)["chips"])
    if why_not:
        print(f"cannot run {args.workload}: {why_not}", file=sys.stderr)
        return 2
    print(f"card: {devmod.card_line()}", file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in args.seeds:
        for control in [None] + (["fp8"] if seed in args.control_seeds
                                 else []):
            out, _ = cli.run_cell(spec, args.workload, seed, args.seconds,
                                  False, device, time.perf_counter(),
                                  control=control)
            print(json.dumps({
                "seed": seed, "control": control, "correct": out.correct,
                "attempted": out.attempted, "failed": out.failed,
                "checks": out.checks, "extra": out.extra}), flush=True)
            del out
            free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
