"""Benchmark runner: one module per paper table / figure.

Counterpart of the reference's ``benchmarks/run.py``, in the reference's
module order.  Prints ``name,us_per_call,derived`` CSV rows:

  * ``scenarios``     — Table 1 / §2 LinReg plan generation, then the LM
                        scenario sweep (``bench_scenarios``)
  * ``plan_costing``  — Figures 4 & 5 costed plans (``bench_plan_costing``)
  * ``accuracy``      — §3.4 "within 2x of actual execution time": LinReg
                        DS plans costed for one H100 and run on ``--device``
                        (``bench_accuracy``)
  * ``costing_speed`` — §2 "<0.5 ms to generate+cost a plan" and the
                        plan-search gates (``bench_costing_speed``)
  * ``resource_opt``  — the cluster/plan co-search gates
                        (``bench_resource_opt``)
  * ``serving``       — the serving co-search gate (``bench_serving``)
  * ``fusion``        — fusion-aware plan choice and the traced fusing
                        kernels, on ``--device`` (``bench_fusion``)
  * ``parallel``      — the parallel / persistent costing gates
                        (``bench_parallel``)
  * ``roofline``      — roofline terms per dry-run cell in
                        ``build/dryrun/`` (``bench_roofline``; no rows
                        without dry-run artifacts)
  * ``calibrate``     — the estimate / reality loop on ``--device``
                        (``bench_calibrate``)

``--quick`` shrinks every module to its smoke size.  A module that raises
prints ``<name>,0,EXCEPTION`` and the run exits 1.  ``accuracy``,
``fusion`` and ``calibrate`` run on the card unless ``--device cpu`` is
given; the other modules cost plans and run nothing on a device.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] \\
          [--only MODULE] [--device cuda|cpu]

The modules are imported in :func:`main`, not at import: ``parallel``'s
spawn workers import this module again when it is the main module, and
must not load torch.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import sys
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

MODULES = ("scenarios", "plan_costing", "accuracy", "costing_speed",
           "resource_opt", "serving", "fusion", "parallel", "roofline",
           "calibrate")
# The modules that run tensors, on --device.
ON_DEVICE = ("accuracy", "fusion", "calibrate")


def runners(device: str, only: Optional[str] = None
            ) -> List[Tuple[str, Callable[..., List[str]]]]:
    """(name, ``run``) of each module in order, ``only`` alone if given; a
    device module's ``run`` is bound to ``device``."""
    names = [n for n in MODULES if only in (None, n)]
    out = []
    for name in names:
        mod = importlib.import_module(f"repro_torch.benchmarks.bench_{name}")
        fn = (functools.partial(mod.run, device=device)
              if name in ON_DEVICE else mod.run)
        out.append((name, fn))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny configs / fewer reps (benchmark smoke)")
    ap.add_argument("--only", default=None, choices=MODULES,
                    help="run a single module (e.g. costing_speed)")
    ap.add_argument("--device", default="cuda",
                    help="where accuracy, fusion and calibrate run")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    failures = 0
    for name, fn in runners(args.device, args.only):
        try:
            for row in fn(quick=args.quick):
                print(row, flush=True)
        except Exception:
            failures += 1
            print(f"{name},0,EXCEPTION", flush=True)
            traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
