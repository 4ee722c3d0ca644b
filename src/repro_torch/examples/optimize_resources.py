"""Resource optimizer: which cluster should this workload run on?

Counterpart of the reference's ``examples/optimize_resources.py``, through
the port's copy of the cost model.  Enumerates cluster candidates (chip
type x pod count x mesh layout x ICI/DCN topology, the v5p 3D-torus layouts
and DCN multi-slice grids whose pod axis can carry pipeline stages: try
``--arch qwen1.5-110b --shape train_4k``), co-searches the sharding-plan
space on each through one shared sub-plan cost cache, and ranks them under
your objective: fastest step, cheapest step ($/step via
ChipSpec.cost_per_chip_hour), cheapest *job* ($/job with startup,
per-arch checkpoint-restore and expected-preemption overheads amortized
over --steps-per-job steps), or cheapest config meeting a step-time SLO.

``--shape`` also accepts a *serving workload* (chat_2k, rag_32k): the
optimizer then co-searches (pool layout x slot count x per-pool plan)
serving schedules under their traffic model, disaggregated prefill/decode
pool pairs included, under ``--objective ttft_p99`` or
``tokens_per_dollar``.

``--h100`` searches the H100 grid instead
(:mod:`repro_torch.core.gpu_clusters`: one card, one NVLink node, 2 and 4
nodes; ``--pod-counts`` gives the node counts).  The card has no price, so
the default objective there is ``step_time`` for a train shape and
``ttft_p99`` for a serving workload, and a dollar objective raises.

Run:
  PYTHONPATH=src python -m repro_torch.examples.optimize_resources
  PYTHONPATH=src python -m repro_torch.examples.optimize_resources \\
      --arch gemma3-12b --shape train_4k --objective cost
  PYTHONPATH=src python -m repro_torch.examples.optimize_resources \\
      --arch gemma3-12b --shape chat_2k --objective ttft_p99
  PYTHONPATH=src python -m repro_torch.examples.optimize_resources --h100
  PYTHONPATH=src python -m repro_torch.examples.optimize_resources \\
      --h100 --shape chat_2k
"""
import argparse
import time

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import gpu_clusters
from repro_torch.core.resource import (DEFAULT_STEPS_PER_JOB, OBJECTIVES,
                                       ResourceSearchStats, enumerate_clusters,
                                       format_decisions, optimize_resources)
from repro_torch.core.serving import (enumerate_serving_clusters,
                                      format_serving_decisions)
from repro_torch.core.workload import SERVE_WORKLOADS, SERVING_OBJECTIVES


def main(argv=None):
    """Print the ranked table, the winner and the search's cost; return the
    ranked decisions."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k",
                    choices=list(SHAPES) + list(SERVE_WORKLOADS))
    ap.add_argument("--objective", default=None,
                    choices=(list(OBJECTIVES) + ["device_seconds"]
                             + list(SERVING_OBJECTIVES)),
                    help="default: step_time, or tokens_per_dollar for a "
                         "serving workload (ttft_p99 with --h100)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="step-time target in ms (objective=slo) or p99 "
                         "TTFT target (objective=ttft_p99)")
    ap.add_argument("--steps-per-job", type=int,
                    default=DEFAULT_STEPS_PER_JOB,
                    help="job length priced by objective=job_cost")
    ap.add_argument("--chips", nargs="+", default=None,
                    metavar="CHIP", help="restrict the chip table")
    ap.add_argument("--pod-counts", nargs="+", type=int, default=(1, 2, 4),
                    help="pods, or H100 nodes with --h100")
    ap.add_argument("--search", default="beam",
                    choices=["beam", "exhaustive"])
    ap.add_argument("--h100", action="store_true",
                    help="search the H100 grid instead of the TPU chips")
    args = ap.parse_args(argv)
    if args.h100 and args.chips:
        ap.error("--chips restricts the TPU chip table; --h100 searches "
                 "the H100 grid")

    serving = args.shape in SERVE_WORKLOADS
    shape = SERVE_WORKLOADS[args.shape] if serving else SHAPES[args.shape]
    slo = args.slo_ms / 1e3 if args.slo_ms is not None else None
    stats = ResourceSearchStats()
    search = dict(search=args.search, stats=stats)
    if not serving:
        search["steps_per_job"] = args.steps_per_job
    t0 = time.perf_counter()
    if args.h100:
        nodes = tuple(args.pod_counts)
        clusters = (gpu_clusters.enumerate_h100_serving_clusters(nodes)
                    if serving else gpu_clusters.enumerate_h100_clusters(nodes))
        objective = args.objective or ("ttft_p99" if serving
                                       else "step_time")
        decisions = gpu_clusters.optimize_h100(
            get_config(args.arch), shape, clusters, objective=objective,
            slo=slo, **search)
    else:
        if serving:
            clusters = enumerate_serving_clusters(
                chips=args.chips, pod_counts=tuple(args.pod_counts))
            objective = args.objective or "tokens_per_dollar"
        else:
            clusters = enumerate_clusters(chips=args.chips,
                                          pod_counts=tuple(args.pod_counts))
            objective = args.objective or "step_time"
        decisions = optimize_resources(
            get_config(args.arch), shape, clusters,
            objective=objective, slo=slo, **search)
    dt = time.perf_counter() - t0

    print(f"{args.arch} x {args.shape}, objective={objective}"
          + (f" (slo={args.slo_ms}ms)" if slo else ""))
    if serving:
        print(format_serving_decisions(decisions))
    else:
        print(format_decisions(decisions, slo=slo))
    print(f"\nwinner: {decisions[0].describe()}")
    print(f"search: {stats.describe()} in {dt * 1e3:.0f}ms "
          f"({args.search}); exhaustive scan would cost "
          f"{stats.exhaustive_plan_space} plan evaluations")
    return decisions


if __name__ == "__main__":
    main()
