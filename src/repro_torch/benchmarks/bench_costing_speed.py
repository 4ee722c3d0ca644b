"""Paper §2: "generating runtime plans from HOP DAGs is rather efficient
(<0.5 ms for common DAG sizes), which makes the generation and costing of
runtime plans feasible."

Counterpart of the reference's ``benchmarks/bench_costing_speed.py``, through
the port's copy of the cost model (numpy and the standard library: no
device runs).

Measures generate+cost time for (a) the LinReg DS plan (the paper's
"common DAG size") and (b) full LM train-step plans (hundreds of
instructions) — reported as us/plan.

Beyond the paper, this also gates the plan-search subsystem:

  * ``candidate_set`` — costing the full enumerated sharding-plan space
    for one (arch x shape) cell through the sub-plan cost cache vs. the
    uncached estimator (the seed path).  Both sides use the harness's
    warm-cache protocol; PASS requires the cached engine to be >=5x
    faster.
  * ``candidate_throughput`` — the lane-vector batched engine (one tree
    walk per structure signature, knob values as numpy lanes) on an
    expanded knob grid vs. the per-candidate uncached walk.  Reported as
    plans/sec; PASS requires >=10x over scalar, bit-exact totals and the
    identical winning plan.
  * ``beam_matches_exhaustive`` — the staged beam search must return the
    same winning plan as the exhaustive scan.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import PlanCostCache, estimate
from repro_torch.core.cluster import ClusterConfig, CPU_HOST, single_pod_config
from repro_torch.core.linreg import SCENARIOS, build_linreg_program
from repro_torch.core.planner import (OVERLAP_FRACTION, SearchStats, ShardingPlan,
                                build_step_program, choose_plan,
                                cost_candidates_batched, enumerate_plans)

PAPER_CC = ClusterConfig(chip=CPU_HOST, mesh_shape=(72,), mesh_axes=("data",))


def _time_us(fn, reps: int = 20) -> float:
    fn()                                     # warm caches
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def run(quick: bool = False) -> List[str]:
    rows = []
    sc = SCENARIOS["XL1"]
    us = _time_us(lambda: estimate(build_linreg_program(sc, PAPER_CC)[0],
                                   PAPER_CC))
    rows.append(f"costing_speed.linreg_generate_and_cost,{us:.1f},"
                f"paper_claim_us=500;{'PASS' if us < 500 else 'FAIL'}")

    cc = single_pod_config()
    plan = ShardingPlan(tp_axes=("model",), microbatches=2)
    lm_archs = ("qwen1.5-0.5b",) if quick else ("qwen1.5-0.5b",
                                                "deepseek-v3-671b")
    for arch_id in lm_archs:
        arch = get_config(arch_id)
        shape = SHAPES["train_4k"]
        us = _time_us(lambda: estimate(
            build_step_program(arch, shape, plan, cc), cc), reps=5)
        n_inst = sum(build_step_program(arch, shape, plan, cc)
                     .count_instructions().values())
        rows.append(f"costing_speed.lm_step.{arch_id},{us:.1f},"
                    f"instructions={n_inst}")

    # ---- candidate-set costing: cached engine vs. uncached (seed) path ----
    arch = get_config("qwen1.5-0.5b")
    shape = SHAPES["train_4k"]
    cands = enumerate_plans(arch, shape, cc)

    def cost_set(cache):
        return [estimate(build_step_program(arch, shape, p, cc), cc,
                         cache=cache)
                for p in cands]

    reps = 2 if quick else 5
    us_uncached = _time_us(lambda: cost_set(None), reps=reps)
    shared = PlanCostCache()
    us_cached = _time_us(lambda: cost_set(shared), reps=reps)
    base = cost_set(None)
    cached = cost_set(shared)
    exact = max(abs(a.total - b.total) for a, b in zip(base, cached))
    speedup = us_uncached / us_cached if us_cached > 0 else float("inf")
    st = shared.stats()
    rows.append(
        f"costing_speed.candidate_set,{us_cached:.1f},"
        f"n_plans={len(cands)};uncached_us={us_uncached:.1f};"
        f"speedup={speedup:.1f}x;max_abs_err={exact:.2g};"
        f"cache_hit_rate={st.hit_rate:.2f};claim=5x;"
        f"{'PASS' if speedup >= 5.0 and exact < 1e-9 else 'FAIL'}")

    # ---- batched lane-vector engine: plans/sec on an expanded grid --------
    # The enumerated space has only ~4 knob members per structure, where
    # numpy per-op overhead eats the win; the anytime-search workload the
    # engine exists for sweeps far wider grids.  Benchmark the honest
    # shape of that workload: one structure, 8 microbatch counts x 6
    # float grad-reduce dtypes = 48 lanes in one walk.
    big = dataclasses.replace(shape, global_batch=4096)
    vplan = ShardingPlan(name="dp+tp", batch_axes=("data",),
                        tp_axes=("model",))
    grid = [dataclasses.replace(vplan, microbatches=m, grad_reduce_dtype=g)
            for m in (2, 4, 8, 16, 32, 64, 128, 256)
            for g in ("float32", "bfloat16", "float16", "float64",
                      "float8_e4m3fn", "float8_e5m2")]
    # scalar baseline = the seed path per candidate: same overlap-adjusted
    # config the search's _cost_candidate walks with, no cache
    cc_p = cc.with_overlap(OVERLAP_FRACTION)
    reps_b = 1 if quick else 3
    us_scalar = _time_us(
        lambda: [estimate(build_step_program(arch, big, p, cc_p), cc_p)
                 for p in grid], reps=reps_b)
    us_batched = _time_us(lambda: cost_candidates_batched(arch, big, grid, cc),
                          reps=reps_b)
    scalar = [estimate(build_step_program(arch, big, p, cc_p), cc_p)
              for p in grid]
    batched = cost_candidates_batched(arch, big, grid, cc)
    err = max(abs(d.time - s.total) for d, s in zip(batched, scalar))
    best_i = min(range(len(grid)), key=lambda i: scalar[i].total)
    winner_ok = min(batched, key=lambda d: d.time).plan == grid[best_i]
    speedup = us_scalar / us_batched if us_batched > 0 else float("inf")
    plans_per_sec = len(grid) / (us_batched / 1e6)
    rows.append(
        f"costing_speed.candidate_throughput,{plans_per_sec:.0f},"
        f"n_plans={len(grid)};batched_us={us_batched:.0f};"
        f"scalar_us={us_scalar:.0f};speedup={speedup:.1f}x;"
        f"max_abs_err={err:.2g};"
        f"winner={'MATCH' if winner_ok else 'MISMATCH'};claim=10x;"
        f"{'PASS' if speedup >= 10.0 and err == 0.0 and winner_ok else 'FAIL'}")

    # ---- beam search returns the exhaustive winner ------------------------
    for arch_id in ("qwen1.5-0.5b", "gemma3-12b"):
        arch = get_config(arch_id)
        stats = SearchStats()
        t0 = time.perf_counter()
        bm = choose_plan(arch, shape, cc, top_k=1, search="beam",
                         stats=stats)[0]
        t_beam_us = (time.perf_counter() - t0) * 1e6
        ex = choose_plan(arch, shape, cc, top_k=1, search="exhaustive")[0]
        match = "MATCH" if bm.plan == ex.plan else "MISMATCH"
        rows.append(
            f"costing_speed.beam_matches_exhaustive.{arch_id},{t_beam_us:.0f},"
            f"winner={bm.plan.describe()};{stats.describe()};"
            f"n_space={len(enumerate_plans(arch, shape, cc))};{match}")
    return rows
