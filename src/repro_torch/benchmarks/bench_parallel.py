"""Parallel grid search + persistent plan-cost cache gates.

Counterpart of the reference's ``benchmarks/bench_parallel.py``, through
the port's copy of the cost model (numpy and the standard library: no
device runs).

Three claims, two of them CI gates:

  * ``resource_opt.parallel`` — a ``jobs=4`` sweep of the full bench grid
    returns a ranked table *byte-identical* to the serial sweep, and
    ``optimize_resources(jobs=4)`` returns the serial decision table
    byte-for-byte (incumbent pruning included).  The >=2.5x wall-clock
    speedup half of the gate is enforced only when the machine actually
    has >= 4 usable cores (CI's 4-vCPU runners do; a 1-core container
    cannot speed anything up and reports the measured ratio
    informationally instead of failing on physics).
  * ``resource_opt.warmstart`` — a second sweep seeded from the persisted
    cache snapshot replays >= 50% of its lookups as hits and returns
    identical winners.
  * ``parallel.affinity`` — informational: serial hit rate of the
    arch-outermost (cache-affinity) visit order vs the old
    clusters-outermost order.  Cache keys embed the cluster fingerprint,
    so cross-cluster sharing is ~nil and the delta is expected to be ~0
    for an unbounded cache — the row documents that honestly; the
    affinity order exists for *sharding* (whole (arch, shape) groups land
    on one worker) and for bounded caches, not for serial hit rate.

The grid is NOT shrunk under ``--quick``: the speedup gate is only
meaningful at full-grid scale (a tiny grid is all pool-startup overhead),
and the whole module costs well under the bench-smoke budget.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import List, Sequence

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.costmodel import PlanCostCache
from repro_torch.core.parallel import default_jobs
from repro_torch.core.resource import (ResourceSearchStats, enumerate_clusters,
                                 optimize_resources)
from repro_torch.core.sweep import CLUSTERS, SweepEngine

JOBS = 4
MIN_SPEEDUP = 2.5        # enforced when the host has >= JOBS usable cores
MIN_WARM_HIT_RATE = 0.5

# The full bench grid: every arch x (train + prefill + decode + a serving
# workload) x every named cluster.  ~300 cells, ~25s serial — big enough
# that a 4-worker pool's startup cost is noise against the work.
GRID_ARCHS = tuple(ARCH_IDS)
GRID_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "chat_2k")
GRID_CLUSTERS = tuple(CLUSTERS)

AFFINITY_ARCHS = ("qwen1.5-0.5b", "gemma3-12b", "mamba2-1.3b",
                  "qwen1.5-110b")
AFFINITY_SHAPES = ("train_4k", "decode_32k")


def _canon_sweep(cells) -> str:
    """Byte-comparable ranked table: full-precision floats via repr, no
    timing or cache counters (those legitimately differ across runs)."""
    out = []
    for c in cells:
        if c.skipped:
            out.append(f"{c.key},SKIP,{c.skipped}")
            continue
        d = c.decision
        out.append(f"{c.key},{d.plan.describe()},{d.time!r},"
                   f"{d.hbm_est!r},{d.feasible}")
    return "\n".join(out)


def _canon_resource(decisions) -> str:
    out = []
    for rd in decisions:
        if rd.pruned:
            out.append(f"{rd.cluster_id},PRUNED,{rd.pruned}")
            continue
        d = rd.decision
        out.append(f"{rd.cluster_id},{d.plan.describe()},{d.time!r},"
                   f"{rd.floor_time!r},{d.feasible}")
    return "\n".join(out)


def _hit_rate_in_order(specs: Sequence) -> float:
    engine = SweepEngine(search="beam")
    for arch, shape, cluster in specs:
        engine.cost_cell(arch, shape, cluster)
    return engine.cache.stats().hit_rate


def run(quick: bool = False) -> List[str]:
    rows: List[str] = []
    ncpu = default_jobs()

    # ---- serial baseline -------------------------------------------------
    serial_engine = SweepEngine(search="beam")
    t0 = time.perf_counter()
    serial = serial_engine.sweep(GRID_ARCHS, GRID_SHAPES, GRID_CLUSTERS)
    t_serial = time.perf_counter() - t0
    serial_canon = _canon_sweep(serial)
    n_cells = len(serial)
    rows.append(f"parallel.sweep_serial,{t_serial * 1e6:.0f},"
                f"cells={n_cells};"
                f"cache={serial_engine.cache.stats().hit_rate:.2f}")
    # the full-grid cache is large; keep only the canonical table around
    del serial_engine, serial

    # ---- jobs=4 sweep: byte-identical table, measured speedup ------------
    fd, cache_path = tempfile.mkstemp(prefix="bench-plancache-",
                                      suffix=".pkl")
    os.close(fd)
    try:
        par_engine = SweepEngine(search="beam", jobs=JOBS,
                                 cache_path=cache_path)
        t0 = time.perf_counter()
        par = par_engine.sweep(GRID_ARCHS, GRID_SHAPES, GRID_CLUSTERS)
        t_par = time.perf_counter() - t0
        sweep_identical = _canon_sweep(par) == serial_canon
        speedup = t_serial / max(t_par, 1e-9)
        rows.append(
            f"parallel.sweep_jobs{JOBS},{t_par * 1e6:.0f},"
            f"speedup={speedup:.2f}x;workers={len(par_engine.last_worker_stats)};"
            f"{'MATCH' if sweep_identical else 'MISMATCH'}")
        del par_engine, par    # sweep() already persisted to cache_path

        # ---- optimize_resources(jobs=4): byte-identical decisions --------
        arch = get_config("qwen1.5-0.5b")
        shape = SHAPES["train_4k"]
        cands = enumerate_clusters()
        r_serial = optimize_resources(arch, shape, cands,
                                      objective="job_cost",
                                      stats=ResourceSearchStats())
        t0 = time.perf_counter()
        r_par = optimize_resources(arch, shape, cands, objective="job_cost",
                                   stats=ResourceSearchStats(), jobs=JOBS)
        t_rpar = time.perf_counter() - t0
        resource_identical = _canon_resource(r_par) == _canon_resource(
            r_serial)

        enforce_speedup = ncpu >= JOBS
        gate = (sweep_identical and resource_identical
                and (speedup >= MIN_SPEEDUP or not enforce_speedup))
        rows.append(
            f"resource_opt.parallel,{t_rpar * 1e6:.0f},"
            f"speedup={speedup:.2f}x;claim={MIN_SPEEDUP}x;ncpu={ncpu};"
            f"gate={'enforced' if enforce_speedup else 'informational'};"
            f"sweep={'MATCH' if sweep_identical else 'MISMATCH'};"
            f"resources={'MATCH' if resource_identical else 'MISMATCH'};"
            f"{'PASS' if gate else 'FAIL'}")

        # ---- warm start from the persisted snapshot ----------------------
        # jobs=1: this leg measures persistence (replay instead of
        # re-walk), not the pool — and it keeps one cache in RAM instead
        # of one per worker.
        warm_engine = SweepEngine(search="beam", cache_path=cache_path)
        seeded = warm_engine.cache.entries
        t0 = time.perf_counter()
        warm = warm_engine.sweep(GRID_ARCHS, GRID_SHAPES, GRID_CLUSTERS)
        t_warm = time.perf_counter() - t0
        traffic = warm_engine.traffic_stats()
        warm_identical = _canon_sweep(warm) == serial_canon
        warm_gate = (warm_identical
                     and traffic.hit_rate >= MIN_WARM_HIT_RATE
                     and seeded > 0)
        rows.append(
            f"resource_opt.warmstart,{t_warm * 1e6:.0f},"
            f"hit_rate={traffic.hit_rate:.2f};claim={MIN_WARM_HIT_RATE};"
            f"seeded={seeded};speedup_vs_cold={t_serial / max(t_warm, 1e-9):.2f}x;"
            f"{'MATCH' if warm_identical else 'MISMATCH'};"
            f"{'PASS' if warm_gate else 'FAIL'}")
    finally:
        os.unlink(cache_path)

    # ---- affinity order: serial hit-rate delta (informational) ----------
    new_order = [(a, s, c) for a in AFFINITY_ARCHS for s in AFFINITY_SHAPES
                 for c in GRID_CLUSTERS]
    old_order = [(a, s, c) for c in GRID_CLUSTERS for a in AFFINITY_ARCHS
                 for s in AFFINITY_SHAPES]
    hit_new = _hit_rate_in_order(new_order)
    hit_old = _hit_rate_in_order(old_order)
    rows.append(
        f"parallel.affinity,0,hit_arch_outer={hit_new:.4f};"
        f"hit_cluster_outer={hit_old:.4f};delta={hit_new - hit_old:+.4f};"
        f"cells={len(new_order)}")
    return rows
