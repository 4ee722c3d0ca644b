"""Paper §3.4 on the H100: "the estimated costs were within 2x of the actual
execution time."

Counterpart of the reference's ``benchmarks/bench_accuracy.py``.  LinReg DS
programs are generated and costed for one H100 (:func:`h100_single_config`,
datasheet constants, nothing fitted: R1), then the same plan is executed on
the card and the compute-side estimate is held against the warm run
(:func:`linreg_rows`).  :func:`serve_estimates` costs the serve engine's
prefill round and decode step of an arch the same way, and
:func:`train_estimates` its train step; the measured side of those
comparisons is ``chip_smoke.py``'s serve and train phases.

The estimates are outputs of the cost model with the ``h100_sxm`` chip spec,
never readings of the card.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import (ClusterConfig, Compute, CreateVar, Program,
                              ShardingPlan, TensorStat, build_step_program,
                              choose_plan, estimate, h100_single_config)
from repro_torch.core.linreg import Scenario, build_linreg_program, tpu_budgets
from repro_torch.examples import linreg_ds
from repro_torch.kernels import ops
from repro_torch.models.model import require_device

PAPER_CLAIM = 2.0
LINREG_LAM = 1e-3
SEED = 0
WARM_REPS = 5
# The first row is chip_smoke.py's LinReg DS shape, whose Gram matrix comes
# from the tsmm kernel; the float64 rows are the reference benchmark's CPU
# scenarios (its CPU_SCENARIOS), through x.T @ x (the kernel has no fp64
# body).
H100_SCENARIOS = [
    Scenario("h100-linreg", 262_144, 1024, dtype="float32"),
    Scenario("f64-S", 20_000, 256, dtype="float64"),
    Scenario("f64-M", 80_000, 384, dtype="float64"),
    Scenario("f64-L", 160_000, 512, dtype="float64"),
]
_PATHS = {"float32": "tsmm kernel", "float64": "x.T @ x"}
# The plan's instructions that make each timed part, by their output: the
# Gram matrix with its ridge, X^T y (the (y^T X)^T rewrite), the solve.
_PARTS = {"_mVarA": "gram", "_mVarA2": "gram", "_mVarYt": "xty",
          "_mVarBt": "xty", "_mVarB": "xty", "beta": "solve"}


def warm_ms(fn: Callable[[], object], device: torch.device) -> float:
    """Median milliseconds of :data:`WARM_REPS` calls of ``fn`` after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(WARM_REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def gram_as_full_product(prog: Program, sc: Scenario) -> Program:
    """``prog`` with its ``tsmm`` (half the product: the output is
    symmetric) replaced by the whole ``X^T X`` that ``x.T @ x`` computes,
    X^T being a view that moves no data: the program the float64 rows
    execute."""
    for block in prog.blocks:
        for i, inst in enumerate(block.children):
            if isinstance(inst, Compute) and inst.opcode == "tsmm":
                block.children[i:i + 1] = [
                    CreateVar("_mVarXt", TensorStat((sc.n, sc.m), sc.dtype)),
                    Compute("matmul", ("_mVarXt", "X"), inst.output)]
                return prog
    raise ValueError(f"{prog.name} has no tsmm instruction")


def _estimated_parts_ms(costed) -> Dict[str, float]:
    """Compute + collective milliseconds the estimate gives each timed part
    (the leaves of its EXPLAIN tree, by their output)."""
    out = dict.fromkeys(("gram", "xty", "solve"), 0.0)
    stack = [costed.root]
    while stack:
        node = stack.pop()
        stack.extend(node.children)
        words = node.label.split()
        if not node.children and "->" in words and words[-1] in _PARTS:
            out[_PARTS[words[-1]]] += (node.cost.compute
                                       + node.cost.collective) * 1e3
    return out


def linreg_program(sc: Scenario, cc: ClusterConfig):
    """(program, plan choice) of ``sc``'s LinReg DS plan for ``cc``, as it
    runs here: a float64 row's Gram matrix as the whole product."""
    prog, choice = build_linreg_program(sc, cc, tpu_budgets(cc))
    if sc.dtype == "float64":
        prog = gram_as_full_product(prog, sc)
    return prog, choice


def linreg_row(sc: Scenario, device: torch.device) -> dict:
    """Generate and cost the LinReg DS plan of ``sc`` for one H100, then
    execute it warm on resident inputs made from :data:`SEED`.  The
    estimate is compute + collective, the IO-free comparison of the
    reference benchmark, of the program that runs: the plan, with a
    float64 row's Gram matrix as the whole product.  Each part (the Gram
    matrix with its ridge, X^T y, the solve) is also estimated and timed on
    its own.  A float32 row also reports its beta against a float64
    solve."""
    if sc.dtype not in _PATHS:
        raise ValueError(f"{sc.name}: dtype {sc.dtype} has no LinReg path "
                         f"here (one of {sorted(_PATHS)})")
    cc = h100_single_config()
    prog, choice = linreg_program(sc, cc)
    x, y, _ = linreg_ds.make_problem(sc.m, sc.n, SEED, device)
    checked = {}
    if sc.dtype == "float64":
        x, y = x.double(), y.double()
        solve = linreg_ds.solve_linreg_f64
        eye = LINREG_LAM * torch.eye(sc.n, dtype=x.dtype, device=device)
        gram = lambda: x.T @ x + eye                     # noqa: E731
    else:
        solve = linreg_ds.solve_linreg
        gram = lambda: ops.tsmm(x, reg=LINREG_LAM)       # noqa: E731
    costed = estimate(prog, cc)
    est_ms = (costed.breakdown.compute + costed.breakdown.collective) * 1e3
    before = ops.launch_counts()["tsmm_upper"]
    actual_ms = warm_ms(lambda: solve(x, y, LINREG_LAM), device)
    launches = ops.launch_counts()["tsmm_upper"] - before
    a, b = gram(), x.T @ y
    parts = {"gram": warm_ms(gram, device),
             "xty": warm_ms(lambda: x.T @ y, device),
             "solve": warm_ms(lambda: torch.linalg.solve(a, b), device)}
    if sc.dtype != "float64":
        err = (solve(x, y, LINREG_LAM).double()
               - linreg_ds.solve_linreg_f64(x, y, LINREG_LAM)).abs().max()
        checked["max_abs_err_vs_f64"] = float(err)
    return {"name": sc.name, "m": sc.m, "n": sc.n, "dtype": sc.dtype,
            "path": _PATHS[sc.dtype], "exec_type": choice.exec_type,
            "tsmm_op": choice.tsmm_op, "mm_op": choice.mm_op,
            "est_ms": est_ms, "actual_ms": actual_ms,
            "ratio": est_ms / actual_ms,
            "est_part_ms": _estimated_parts_ms(costed),
            "actual_part_ms": parts, "tsmm_launches": launches, **checked}


def linreg_rows(device="cuda",
                scenarios: Optional[Sequence[Scenario]] = None) -> List[dict]:
    """One row per scenario, then the worst factor against the paper's 2x.
    The card runs :data:`H100_SCENARIOS`; on the CPU the caller passes
    small scenarios."""
    dev = require_device(device)
    if scenarios is None:
        if dev.type != "cuda":
            raise ValueError("pass small scenarios to run on the CPU")
        scenarios = H100_SCENARIOS
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    rows = [{**linreg_row(sc, dev), "device": name} for sc in scenarios]
    worst = max(max(r["ratio"], 1 / r["ratio"]) for r in rows)
    rows.append({"worst_factor": worst, "paper_claim": PAPER_CLAIM,
                 "verdict": "PASS" if worst <= PAPER_CLAIM else "FAIL"})
    return rows


def run(quick: bool = False, device="cuda") -> List[str]:
    """The reference's rows for the benchmark runner: one
    ``accuracy.<scenario>`` row (est / actual / ratio) per scenario of
    :func:`linreg_rows`, then the worst factor against the paper's 2x.  The
    card runs :data:`H100_SCENARIOS` (quick: the tsmm row and f64-S); the CPU
    runs their float64 rows (quick: f64-S), a smoke of the path, since the
    estimate is one H100's either way."""
    dev = require_device(device)
    if dev.type == "cuda":
        scenarios = H100_SCENARIOS[:2] if quick else H100_SCENARIOS
    else:
        scenarios = H100_SCENARIOS[1:2 if quick else 4]
    rows = linreg_rows(dev, scenarios)
    out = [f"accuracy.{r['name']},0,est={r['est_ms']:.1f}ms;"
           f"actual={r['actual_ms']:.1f}ms;ratio={r['ratio']:.2f};"
           f"path={r['path']};tsmm_launches={r['tsmm_launches']}"
           for r in rows[:-1]]
    summary = rows[-1]
    out.append(f"accuracy.worst_factor,0,{summary['worst_factor']:.2f};"
               f"paper_claim={PAPER_CLAIM};{summary['verdict']}")
    return out


def _breakdown_ms(costed) -> Dict[str, float]:
    b = costed.breakdown
    return {"total_ms": costed.total * 1e3, "io_ms": b.io * 1e3,
            "compute_ms": b.compute * 1e3,
            "collective_ms": b.collective * 1e3, "latency_ms": b.latency * 1e3}


def serve_estimates(cfg: ArchConfig, batch: int, prompt_len: int,
                    max_len: int, cc: Optional[ClusterConfig] = None) -> dict:
    """Estimated seconds of the serve engine's static prefill round (every
    prompt left-padded to the longest, ``prompt_len``) and of one decode
    step (attending over all ``max_len`` cache slots), for ``batch``
    requests on one H100 (``cc``, by default :func:`h100_single_config`;
    ``chip_smoke.py`` passes it again with a fitted calibration profile):
    under the plain data-parallel plan with fusion off, none and full, and
    under ``choose_plan``'s winner."""
    cc = cc or h100_single_config()
    shapes = {"prefill": ShapeConfig("prefill_gpu", prompt_len, batch,
                                     "prefill"),
              "decode": ShapeConfig("decode_gpu", max_len, batch, "decode")}
    out = {"chip_spec": cc.chip.name}
    for key, shape in shapes.items():
        row = {"seq_len": shape.seq_len, "batch": shape.global_batch}
        for fusion in ("off", "none", "full"):
            prog = build_step_program(cfg, shape,
                                      ShardingPlan(name="dp", fusion=fusion),
                                      cc)
            row[fusion] = _breakdown_ms(estimate(prog, cc))
        best = choose_plan(cfg, shape, cc)[0]
        row["choose_plan"] = {"plan": best.plan.describe(),
                              "fusion": best.plan.fusion,
                              "feasible": best.feasible,
                              **_breakdown_ms(best.cost)}
        out[key] = row
    return out



def train_estimates(cfg: ArchConfig, batch: int, seq_len: int,
                    plan: ShardingPlan,
                    cc: Optional[ClusterConfig] = None) -> dict:
    """Estimated time of one train step of ``batch`` sequences of
    ``seq_len`` tokens on one H100 (``cc`` as in :func:`serve_estimates`),
    under ``plan`` (the plan the step ran: its ``remat`` and
    ``microbatches``): ``build_step_program`` with the port's own GPU train
    shape, then ``estimate``."""
    cc = cc or h100_single_config()
    shape = ShapeConfig("h100_train", seq_len, batch, "train")
    prog = build_step_program(cfg, shape, plan, cc)
    return {"chip_spec": cc.chip.name, "seq_len": seq_len, "batch": batch,
            "remat": plan.remat, "microbatches": plan.microbatches,
            **_breakdown_ms(estimate(prog, cc))}
