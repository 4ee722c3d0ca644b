"""The paper's running example, executed: LinReg DS through the tsmm kernel.

Counterpart of ``execute_small`` in ``examples/linreg_ds.py``: the Gram
matrix with its ridge shift from the hand-written ``tsmm`` kernel
(``G = X^T X + lambda I``), ``X^T y`` and the solve from PyTorch, and
``beta`` checked against a float64 solve of the same normal equations.  The
scenario table and the cost estimate of the reference wait for the port of the
cost model.

Run:  PYTHONPATH=src python -m repro_torch.examples.linreg_ds [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.model import require_device


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--lam", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = execute_small(args.m, args.n, args.lam, device=args.device)
    print(f"solved {r['m']}x{r['n']} in {r['seconds']*1e3:.1f}ms on "
          f"{args.device} | max|beta - beta_f64| = "
          f"{r['max_abs_err_vs_f64']:.2e}  max|beta - true| = "
          f"{r['max_abs_err_vs_true']:.3f}")


if __name__ == "__main__":
    main()
