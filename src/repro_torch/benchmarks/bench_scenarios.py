"""Paper Table 1 + §2: LinReg DS plan generation across the five scenarios,
plus the LM-scale scenario sweep.

Counterpart of the reference's ``benchmarks/bench_scenarios.py``, through
the port's copy of the cost model (numpy and the standard library: no
device runs).

Emits one row per LinReg scenario: the selected execution type / physical
operators and the estimated cost — must reproduce the paper's plan
switches (XS: CP+tsmm; XL1: tsmm+ak+ & mapmm w/ partitioned broadcast;
XL2: cpmm Gram; XL3: cpmm for X^T y; XL4: both cpmm).

Then one ``sweep.<arch>|<shape>|<mesh>`` row per LM scenario-sweep cell
(see :mod:`repro_torch.core.sweep`): the beam-searched best sharding plan, its
estimated step time / HBM, and the search+cache counters — all cells
costed through one shared sub-plan cache.
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.core import estimate
from repro_torch.core.cluster import ClusterConfig, CPU_HOST, single_pod_config
from repro_torch.core.linreg import (PAPER_BUDGETS, SCENARIOS, build_linreg_program,
                               tpu_budgets)
from repro_torch.core.sweep import SweepEngine, sweep_rows

SWEEP_ARCHS = ("qwen1.5-0.5b", "gemma3-12b", "mamba2-1.3b")
SWEEP_SHAPES = ("train_4k", "decode_32k")
SWEEP_CLUSTERS = ("pod", "2pod")

PAPER_CC = ClusterConfig(chip=CPU_HOST, mesh_shape=(72,), mesh_axes=("data",),
                         dispatch_latency=20.0)

EXPECTED = {
    "XS": ("CP", "tsmm", "mm"),
    "XL1": ("DIST", "tsmm+ak+", "mapmm"),
    "XL2": ("DIST", "cpmm", "mapmm"),
    "XL3": ("DIST", "tsmm+ak+", "cpmm"),
    "XL4": ("DIST", "cpmm", "cpmm"),
}


def run(quick: bool = False) -> List[str]:
    rows = []
    for name, sc in SCENARIOS.items():
        t0 = time.perf_counter()
        prog, choice = build_linreg_program(sc, PAPER_CC, PAPER_BUDGETS)
        costed = estimate(prog, PAPER_CC)
        us = (time.perf_counter() - t0) * 1e6
        got = (choice.exec_type, choice.tsmm_op, choice.mm_op)
        match = "MATCH" if got == EXPECTED[name] else f"MISMATCH{EXPECTED[name]}"
        rows.append(
            f"scenarios.{name},{us:.1f},"
            f"exec={choice.exec_type};tsmm={choice.tsmm_op};mm={choice.mm_op};"
            f"party={choice.partition_y};C={costed.total:.2f}s;{match}")
    # TPU-instantiated budgets: decision structure under v5e constants
    cc = single_pod_config()
    for name in ("XS", "XL1", "XL2"):
        prog, choice = build_linreg_program(SCENARIOS[name], cc, tpu_budgets(cc))
        costed = estimate(prog, cc)
        rows.append(f"scenarios_tpu.{name},0,"
                    f"exec={choice.exec_type};tsmm={choice.tsmm_op};"
                    f"C={costed.total:.4f}s")

    # LM scenario sweep: every (arch x shape x mesh) cell through one
    # shared plan-cost cache, ranked fastest-first
    engine = SweepEngine(search="beam")
    cells = engine.sweep(SWEEP_ARCHS[:1] if quick else SWEEP_ARCHS,
                         SWEEP_SHAPES,
                         SWEEP_CLUSTERS[:1] if quick else SWEEP_CLUSTERS)
    rows.extend(sweep_rows(cells))
    st = engine.cache.stats()
    rows.append(f"sweep.cache,0,hits={st.hits};lookups={st.hits + st.misses};"
                f"hit_rate={st.hit_rate:.2f};entries={st.entries}")
    return rows
