"""The paper's running example, end to end (counterpart of the reference's
``examples/linreg_ds.py``).

1. Reproduces §2: generated runtime plans for the five Table-1 scenarios
   on the paper's 72-node CPU cluster (plan switches: tsmm vs mapmm vs
   cpmm, CP vs DIST, broadcast partition), and the costed plan of XS
   (:func:`show_scenarios`).
2. Executes a LinReg DS instance with the Gram matrix and its ridge shift
   from the hand-written ``tsmm`` kernel (``G = X^T X + lambda I``), ``X^T y``
   and the solve from PyTorch, and checks ``beta`` against a float64 solve
   of the same normal equations (:func:`execute_small`).
3. Costs the same solve (:func:`estimate_small`): on the CPU the
   reference's ``cpu_host_config`` with its ``CompilerBudgets``; on the card
   ``h100_single_config``, printed beside the measured seconds of a warm
   solve as est / measured (paper §3.4's 2x claim).

Run:  PYTHONPATH=src python -m repro_torch.examples.linreg_ds [--device cpu] [--m 8192 --n 256]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import torch

from repro_torch.core import estimate, explain
from repro_torch.core.cluster import (ClusterConfig, CPU_HOST, cpu_host_config,
                                      h100_single_config)
from repro_torch.core.linreg import (CompilerBudgets, SCENARIOS, Scenario,
                                     build_linreg_program, tpu_budgets)
from repro_torch.kernels import ops
from repro_torch.models.model import require_device

PAPER_CC = ClusterConfig(chip=CPU_HOST, mesh_shape=(72,), mesh_axes=("data",),
                         dispatch_latency=20.0)
# The reference's budgets for its CPU-sized estimate.
CPU_BUDGETS = CompilerBudgets(local_mem=8e9, broadcast_mem=2e9,
                              block_size=4096)


def show_scenarios() -> None:
    """The five Table-1 scenarios' generated plans and costs on the paper's
    cluster, then the EXPLAIN of scenario XS."""
    print("== §2: generated plans across Table-1 scenarios ==")
    for name, sc in SCENARIOS.items():
        prog, choice = build_linreg_program(sc, PAPER_CC)
        costed = estimate(prog, PAPER_CC)
        print(f"  {name:4s} X:{sc.m}x{sc.n}  exec={choice.exec_type:4s} "
              f"Gram={choice.tsmm_op:9s} mm={choice.mm_op:6s} "
              f"partition_y={choice.partition_y}  C={costed.total:9.2f}s")
    prog, _ = build_linreg_program(SCENARIOS["XS"], PAPER_CC)
    print("\n== costed plan, scenario XS (paper Fig. 4) ==")
    print(explain(estimate(prog, PAPER_CC)))


def make_problem(m: int, n: int, seed: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """X [m,n], y [m,1] = X beta_true + noise, beta_true [n,1]; float32, made
    on ``device`` from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, n), generator=gen, device=device, dtype=torch.float32)
    beta_true = torch.randn((n, 1), generator=gen, device=device,
                            dtype=torch.float32)
    noise = torch.randn((m, 1), generator=gen, device=device,
                        dtype=torch.float32)
    return x, x @ beta_true + 0.01 * noise, beta_true


def solve_linreg(x: torch.Tensor, y: torch.Tensor, lam: float) -> torch.Tensor:
    """beta = (X^T X + lam I)^-1 X^T y with the Gram matrix from ``tsmm``."""
    a = ops.tsmm(x, reg=lam)                     # half-compute Gram + ridge
    b = x.T @ y
    return torch.linalg.solve(a, b)


def solve_linreg_f64(x: torch.Tensor, y: torch.Tensor,
                     lam: float) -> torch.Tensor:
    """The same normal equations in float64 with plain PyTorch."""
    x64, y64 = x.to(torch.float64), y.to(torch.float64)
    a = x64.T @ x64 + lam * torch.eye(x.shape[1], dtype=torch.float64,
                                      device=x.device)
    return torch.linalg.solve(a, x64.T @ y64)


def execute_small(m: int = 8192, n: int = 256, lam: float = 1e-3,
                  seed: int = 0, device="cuda", x: torch.Tensor = None,
                  y: torch.Tensor = None) -> Dict[str, float]:
    """Solve one LinReg DS instance and check it.  ``x``/``y`` override the
    seeded problem (the tests pass numpy-made data)."""
    dev = require_device(device)
    beta_true = None
    if x is None:
        x, y, beta_true = make_problem(m, n, seed, dev)
    x, y = x.to(dev), y.to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    beta = solve_linreg(x, y, lam)
    sync()
    wall = time.perf_counter() - t0
    ref = solve_linreg_f64(x, y, lam)
    out = {"m": x.shape[0], "n": x.shape[1], "seconds": wall,
           "max_abs_err_vs_f64": float((beta.to(torch.float64) - ref)
                                       .abs().max()),
           "beta": beta}
    if beta_true is not None:
        out["max_abs_err_vs_true"] = float((beta - beta_true).abs().max())
    return out


def estimate_small(m: int, n: int, device="cuda") -> Dict[str, object]:
    """The compute-side estimate of one ``m x n`` solve: on the CPU the
    reference's (``cpu_host_config``, :data:`CPU_BUDGETS`, the float64
    scenario it costs), on the card one H100 (``h100_single_config``,
    ``tpu_budgets``, float32 as the solve runs)."""
    if torch.device(device).type == "cuda":
        cc = h100_single_config()
        sc = Scenario("exec", m, n, dtype="float32")
        budgets = tpu_budgets(cc)
    else:
        cc = cpu_host_config()
        sc = Scenario("exec", m, n, dtype="float64")
        budgets = CPU_BUDGETS
    prog, choice = build_linreg_program(sc, cc, budgets)
    costed = estimate(prog, cc)
    return {"chip_spec": cc.chip.name, "exec_type": choice.exec_type,
            "tsmm_op": choice.tsmm_op,
            "est_seconds": costed.breakdown.compute}


def main(argv=None) -> Dict[str, object]:
    """The scenario table, a cold and a warm solve (one ``tsmm`` launch
    each on the card), and the estimate; returns the warm solve's record
    with the estimate and the cold solve's seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--lam", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    show_scenarios()
    print("\n== executing LinReg DS with the tsmm kernel ==")
    cold, warm = (execute_small(args.m, args.n, args.lam, device=args.device)
                  for _ in range(2))
    for label, r in (("cold", cold), ("warm", warm)):
        print(f"  solved {r['m']}x{r['n']} in {r['seconds']*1e3:.1f}ms on "
              f"{args.device} ({label}) | max|beta - beta_f64| = "
              f"{r['max_abs_err_vs_f64']:.2e}  max|beta - true| = "
              f"{r['max_abs_err_vs_true']:.3f}")
    est = estimate_small(args.m, args.n, args.device)
    ratio = est["est_seconds"] / warm["seconds"]
    print(f"  cost model estimate (compute side): "
          f"{est['est_seconds']*1e3:.1f}ms on {est['chip_spec']} "
          f"({est['exec_type']}, {est['tsmm_op']}) | measured warm "
          f"{warm['seconds']*1e3:.1f}ms | est / measured = {ratio:.3f}")
    return {**warm, **est, "cold_seconds": cold["seconds"],
            "est_over_measured": ratio}


if __name__ == "__main__":
    main()
