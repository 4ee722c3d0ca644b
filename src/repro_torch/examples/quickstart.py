"""Quickstart: cost a runtime plan, read the EXPLAIN, let the planner pick.

Counterpart of the reference's ``examples/quickstart.py``, through the
port's copy of the cost model.  By default it plans qwen1.5-4b ``train_4k``
on the reference's cluster (one 256-chip v5e pod) and prints the
reference's text; ``--h100`` plans it on one H100 node instead
(:func:`repro_torch.core.cluster.h100_node_config`: eight cards on NVLink).
Nothing runs on a device: the plans are costed, not executed.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--h100]
"""
import argparse

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import estimate, explain, single_pod_config
from repro_torch.core.cluster import h100_node_config
from repro_torch.core.planner import build_step_program, choose_plan


def main(argv=None):
    """Print the ranking and the winner's EXPLAIN; return the ranking."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--h100", action="store_true",
                    help="plan on one H100 node (1x8) instead of a v5e pod")
    args = ap.parse_args(argv)
    # 256-chip v5e pod (16x16), or one H100 node
    cc = h100_node_config() if args.h100 else single_pod_config()
    arch = get_config("qwen1.5-4b")
    shape = SHAPES["train_4k"]

    # 1) ask the cost-based planner for the best sharding plan
    decisions = choose_plan(arch, shape, cc, top_k=5)
    print("== plan ranking (C(P, cc), HBM estimate) ==")
    for d in decisions:
        mark = "*" if d is decisions[0] else " "
        print(f" {mark} {d.plan.describe():64s} "
              f"T={d.time*1e3:8.1f}ms  hbm={d.hbm_est/1e9:5.1f}GB  "
              f"feasible={d.feasible}")

    # 2) generate + cost the winner's runtime plan, SystemML-EXPLAIN style
    best = decisions[0]
    prog = build_step_program(arch, shape, best.plan, cc)
    costed = estimate(prog, cc.with_overlap(0.7))
    print("\n== costed runtime plan (depth 2) ==")
    print(explain(costed, max_depth=2))
    return decisions


if __name__ == "__main__":
    main()
