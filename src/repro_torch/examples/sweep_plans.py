"""Scenario sweep: best sharding plan for every (arch x shape x mesh) cell.

Counterpart of the reference's ``examples/sweep_plans.py``, through the
port's copy of the cost model.  The paper's point is that generating and
costing runtime plans is cheap enough to do for *every* alternative an
optimizer can enumerate; the sweep engine extends that to every *scenario*
an operator can imagine.  All cells share one sub-plan cost cache, so each
additional scenario costs less than the one before it.

``--h100`` sweeps the H100 grid (:mod:`repro_torch.core.gpu_clusters`: one
card, one NVLink node, 2 and 4 nodes) in place of ``--clusters``; with
``--resources`` each workload's winning H100 cluster follows.  The card has
no price, so a dollar objective raises there.

Run:
  PYTHONPATH=src python -m repro_torch.examples.sweep_plans
  PYTHONPATH=src python -m repro_torch.examples.sweep_plans \\
      --archs qwen1.5-0.5b gemma3-12b --shapes train_4k decode_32k \\
      --clusters pod 2pod --search beam
  PYTHONPATH=src python -m repro_torch.examples.sweep_plans --resources \\
      --objective cost
  PYTHONPATH=src python -m repro_torch.examples.sweep_plans \\
      --jobs 4 --cache-file build/plans.cache
  PYTHONPATH=src python -m repro_torch.examples.sweep_plans --h100 --resources
"""
import argparse
import time

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.core import gpu_clusters
from repro_torch.core.resource import (DEFAULT_STEPS_PER_JOB, OBJECTIVES,
                                       ResourceSearchStats, enumerate_clusters)
from repro_torch.core.sweep import CLUSTERS, SweepEngine, format_table


def main(argv=None):
    """Print the ranked table (and with ``--resources`` each workload's
    winning cluster) and the cache summary; return the costed cells."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archs", nargs="+", default=["qwen1.5-0.5b",
                                                   "gemma3-12b",
                                                   "mamba2-1.3b"],
                    choices=ARCH_IDS, metavar="ARCH")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES), metavar="SHAPE")
    ap.add_argument("--clusters", nargs="+", default=["pod"],
                    choices=list(CLUSTERS), metavar="CLUSTER")
    ap.add_argument("--resources", action="store_true",
                    help="sweep the enumerated cluster grid (chip x pods x "
                         "mesh x ICI/DCN) instead of --clusters, and report "
                         "each workload's winning cluster")
    ap.add_argument("--objective", default="step_time",
                    choices=list(OBJECTIVES) + ["device_seconds"])
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--steps-per-job", type=int,
                    default=DEFAULT_STEPS_PER_JOB,
                    help="job length priced by --objective job_cost")
    ap.add_argument("--search", default="beam",
                    choices=["beam", "exhaustive", "batched"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="cost cells over N spawn workers (ranked table is "
                         "identical to --jobs 1)")
    ap.add_argument("--cache-file", default=None,
                    help="persist the plan-cost cache here: loaded at "
                         "startup (ignored when stale — the snapshot is "
                         "fingerprinted against the cost-model version) "
                         "and re-saved after the sweep")
    ap.add_argument("--h100", action="store_true",
                    help="sweep the H100 grid instead of --clusters")
    args = ap.parse_args(argv)
    if args.h100:
        gpu_clusters.check_objective(args.objective)

    engine = SweepEngine(search=args.search, jobs=args.jobs,
                         cache_path=args.cache_file)
    if args.h100:
        clusters = gpu_clusters.enumerate_h100_clusters()
    elif args.resources:
        clusters = enumerate_clusters()
    else:
        clusters = list(args.clusters)
    t0 = time.perf_counter()
    cells = engine.sweep(args.archs, args.shapes, clusters)
    dt = time.perf_counter() - t0

    print(format_table(cells))
    if args.resources:
        slo = args.slo_ms / 1e3 if args.slo_ms is not None else None
        print(f"\nresource winners (objective={args.objective}):")
        for arch in args.archs:
            for shape in args.shapes:
                ok, why = shape_applicable(get_config(arch), SHAPES[shape])
                if not ok:
                    print(f"  {arch} x {shape}: {why}")
                    continue
                try:
                    if args.h100:
                        stats = ResourceSearchStats()
                        decisions = gpu_clusters.optimize_h100(
                            get_config(arch), SHAPES[shape], clusters,
                            objective=args.objective, slo=slo,
                            steps_per_job=args.steps_per_job,
                            cache=engine.cache, stats=stats)
                        engine.save_cache()
                    else:
                        decisions, stats = engine.optimize_cell(
                            arch, shape, clusters, objective=args.objective,
                            slo=slo, steps_per_job=args.steps_per_job)
                except ValueError as e:
                    print(f"  {arch} x {shape}: {e}")
                    continue
                print(f"  {arch} x {shape}: {decisions[0].describe()} "
                      f"[{stats.describe()}]")
    # traffic_stats() aggregates worker-local lookups after a parallel
    # sweep; for --jobs 1 it is exactly the engine cache's own counters.
    st = engine.traffic_stats()
    costed = sum(c.stats.costed for c in cells if c.stats)
    workers = f" over {args.jobs} workers" if args.jobs > 1 else ""
    print(f"\n{len(cells)} scenarios, {costed} candidate plans costed in "
          f"{dt * 1e3:.0f}ms ({args.search} search{workers}); cache: "
          f"{st.hits} hits / {st.hits + st.misses} lookups "
          f"({st.hit_rate:.0%}), {engine.cache.entries} merged entries")
    if args.cache_file:
        print(f"cache saved to {args.cache_file}")
    return cells


if __name__ == "__main__":
    main()
