"""Serving co-search gates: the (cluster x plan x schedule) beam search
must return the exhaustive winner, and prefill/decode disaggregation must
actually win somewhere on the grid.

Counterpart of the reference's ``benchmarks/bench_serving.py``, through
the port's copy of the cost model (numpy and the standard library: no
device runs).

Rows:
  * ``resource_opt.serving.<workload>|<objective>`` — winner identity
    (pool layout, slot count, per-pool plans) for the beam co-search and
    winner-match vs. the exhaustive (cluster x slots x plan) scan.
  * ``resource_opt.serving`` — the gate: every cell's beam winner matches
    exhaustive, at least one cell's winner is a *disaggregated*
    prefill/decode pool pair, and the beam costs >=3x fewer plan
    evaluations than the exhaustive space.

The disaggregation cell is a heterogeneous fleet question: gemma3-12b
under prefill-heavy traffic (8k-token prompts, 64-token outputs) at an
arrival rate sized so every colocated candidate cheaper than the pair is
unstable (rho >= 1).  Within one chip family every phase scales ~linearly
with chips, so a same-chip split never beats its colocated parent — but
prefill is compute-bound (v6e: best FLOPs/$) while decode streams KV
(v5e: best HBM-BW/$, yet hopeless at prefill: the 12B weights don't fit
one chip, forcing collective-bound plans), and pods come in discrete
sizes.  The cheapest stable fleet is a v6e prefill pod feeding a v5e
decode pod across the DCN KV handoff — the "+pd"/cross-pool candidates
:func:`repro_torch.core.serving.enumerate_serving_clusters` emits.

Any gate failure prints FAIL/MISMATCH in the derived column; CI greps for
both.
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.configs import get_config
from repro_torch.core.costmodel import PlanCostCache
from repro_torch.core.resource import ResourceSearchStats
from repro_torch.core.serving import enumerate_serving_clusters, optimize_serving
from repro_torch.core.workload import (LengthDistribution, SERVE_WORKLOADS,
                                 ServeWorkload)

MIN_EVALS_RATIO = 3.0

# The heterogeneous-fleet workload (see module docstring): arrival rate
# 450 req/s sits between the v6e colocated pod's capacity (~390/s: its
# window serializes prefill into the decode budget) and the v6e>v5e
# pair's (~560/s: the pools run concurrently, stability is the max of
# per-pool utilizations, and the v5e pool only ever decodes).
HETERO_WL = ServeWorkload(
    "hetero_prefill_heavy", arrival_rate=450.0,
    prompt_len=LengthDistribution(8192, 16384),
    output_len=LengthDistribution(64, 128),
    ttft_slo=0.5, kv_page_tokens=128)

OBJECTIVES = ("tokens_per_dollar", "ttft_p99")


def _winner_id(d) -> str:
    """The full winner identity the beam must reproduce: pool layout x
    slot count x per-pool plans."""
    pf = d.prefill_decision.plan.describe() if d.prefill_decision else "-"
    return (f"{d.cluster_id}@B{d.slots}"
            f"+{d.decode_decision.plan.describe()}/{pf}")


def run(quick: bool = False) -> List[str]:
    rows: List[str] = []
    arch = get_config("gemma3-12b")
    hetero_grid = enumerate_serving_clusters(
        chips=["tpu_v6e", "tpu_v5e"], pod_counts=(1, 2), mesh_variants=1,
        cross_chip=True)
    cells = [(HETERO_WL, hetero_grid, "hetero")]
    if not quick:
        # A standard-workload cell on the homogeneous v5p grid (its "+pd"
        # same-chip splits included — they should *lose* here).
        v5p_grid = enumerate_serving_clusters(chips=["tpu_v5p"],
                                              pod_counts=(1, 2))
        cells.append((SERVE_WORKLOADS["chat_2k"], v5p_grid, "v5p"))

    all_match = True
    disagg_wins = 0
    total_evals = total_space = 0
    ex_cache = PlanCostCache()
    for wl, grid, tag in cells:
        cache = PlanCostCache()
        for objective in OBJECTIVES:
            stats = ResourceSearchStats()
            t0 = time.perf_counter()
            dec = optimize_serving(arch, wl, grid, objective=objective,
                                   cache=cache, stats=stats)
            us = (time.perf_counter() - t0) * 1e6
            ex = optimize_serving(arch, wl, grid, objective=objective,
                                  search="exhaustive", cache=ex_cache)
            match = _winner_id(dec[0]) == _winner_id(ex[0])
            all_match &= match
            disagg_wins += not dec[0].cand.colocated
            total_evals += stats.plan_evals
            total_space += stats.exhaustive_plan_space
            rows.append(
                f"resource_opt.serving.{wl.name}|{objective},{us:.0f},"
                f"win={_winner_id(dec[0])};"
                f"ttft_p99={dec[0].ttft_p99 * 1e3:.1f}ms;"
                f"$1k={dec[0].cost_per_1k_tokens:.4f};"
                f"evals={stats.plan_evals}/{stats.exhaustive_plan_space};"
                f"{'MATCH' if match else 'MISMATCH'}")
    ratio = total_space / max(total_evals, 1)
    gate = all_match and disagg_wins > 0 and ratio >= MIN_EVALS_RATIO
    rows.append(
        f"resource_opt.serving,0,cells={len(cells) * len(OBJECTIVES)};"
        f"disagg_wins={disagg_wins};"
        f"evals={total_evals}/{total_space}({ratio:.1f}x);"
        f"claim={MIN_EVALS_RATIO:.0f}x;"
        f"{'MATCH' if all_match else 'MISMATCH'};"
        f"{'PASS' if gate else 'FAIL'}")
    return rows
