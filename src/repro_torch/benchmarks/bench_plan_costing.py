"""Paper Figures 4 & 5: costed runtime plans with per-instruction
[IO, compute] annotations, for scenario XS (pure CP) and XL1 (hybrid
DIST plan) — plus the same treatment for an LM train-step plan.

Counterpart of the reference's ``benchmarks/bench_plan_costing.py``, through
the port's copy of the cost model (numpy and the standard library: no
device runs).
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import estimate, explain
from repro_torch.core.cluster import ClusterConfig, CPU_HOST, single_pod_config
from repro_torch.core.linreg import SCENARIOS, build_linreg_program
from repro_torch.core.planner import choose_plan, build_step_program

PAPER_CC = ClusterConfig(chip=CPU_HOST, mesh_shape=(72,), mesh_axes=("data",),
                         dispatch_latency=20.0)


def run(quick: bool = False) -> List[str]:
    rows = []
    for name in ("XS", "XL1"):
        prog, _ = build_linreg_program(SCENARIOS[name], PAPER_CC)
        t0 = time.perf_counter()
        costed = estimate(prog, PAPER_CC)
        us = (time.perf_counter() - t0) * 1e6
        text = explain(costed)
        print(f"\n===== Costed plan, scenario {name} (paper Fig. "
              f"{'4' if name == 'XS' else '5'}) =====")
        print(text)
        dominant = max(("io", "compute", "collective", "latency"),
                       key=lambda k: getattr(costed.breakdown, k))
        rows.append(f"plan_costing.{name},{us:.1f},"
                    f"C={costed.total:.2f}s;dominant={dominant}")

    # LM-step analytical plan (the same machinery at LM scale)
    cc = single_pod_config()
    arch = get_config("qwen1.5-0.5b")
    dec = choose_plan(arch, SHAPES["train_4k"], cc, top_k=1)[0]
    prog = build_step_program(arch, SHAPES["train_4k"], dec.plan, cc)
    costed = estimate(prog, cc)
    print("\n===== Costed LM train-step plan (qwen1.5-0.5b, train_4k) =====")
    print(explain(costed, max_depth=2))
    rows.append(f"plan_costing.lm_step,0,C={costed.total*1e3:.1f}ms;"
                f"plan={dec.plan.name}")
    return rows
