"""Calibration harvest, fit and drift gate on the H100: the counterpart of
the reference's ``benchmarks/bench_calibrate.py``.

Harvests ``(peak-rate features, measured wall seconds)`` pairs: bf16 matmul
microbenchmarks, one in each of the three shape classes of
``core.calibration`` (breakpoints 1e8 and 1e10 FLOPs); the streaming op
``a * 1.0001 + 1`` for the HBM fraction; the LinReg DS rows of
:mod:`repro_torch.benchmarks.bench_accuracy` (measured once, by the caller
or here); and the arch cells' ``model.loss`` forward (``ARCH_CELLS``: the
two smoke architectures, and on the card qwen1.5-4b at two batch x
length), costed through :func:`repro_torch.core.graph_cost.lower_and_cost`
at full width and depth; the fit's feature matrix and its condition number
(``calib.features`` rows).  Then least-squares a
:class:`repro_torch.core.calibration.CalibrationProfile` and re-estimates
every validation cell under ``cc.with_calibration(profile)``.

Rows (the reference's):
  * ``calib.fit``            - fitted terms / residual / sample counts
  * ``calib.features``       - the fit's term keys and condition numbers
                               (the port's), then one row of features per
                               accepted sample
  * ``calib.profile``        - the fitted factors themselves
  * ``calib.drift.<cell>``   - est/measured ratio, uncalibrated vs
                               calibrated, per validation cell
  * ``calib.drift``          - the gate: median |ratio - 1| must strictly
                               improve under the fitted profile and every
                               calibrated ratio must sit inside
                               :data:`RATIO_BAND`; reported PASS or FAIL.

What is measured is wall time with the host included (CUDA synchronised
around each call), as the reference's ``block_until_ready``; the features
are ideal seconds at the datasheet peaks.  The arch cells run the plain
program (``use_kernel=False``), the program ``graph_cost`` traces: the
reference too costs and times ``model.loss`` at its default, plain path.
A broken measurement path raises: a polluted or rejected arch or LinReg
sample, a time that is not finite and positive, an empty feature vector.

It runs on the card by default (:func:`h100_single_config`); on the CPU
with ``device="cpu"`` (:func:`cpu_host_config` and the reference's quick
sizes: ``.reduced()`` fp32 archs at B 2 x S 64).  CPU numbers are the host's
and say nothing of the card.

    python -m repro_torch.benchmarks.bench_calibrate [--device cpu] [--quick]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.benchmarks import bench_accuracy
from repro_torch.configs import get_config
from repro_torch.core import (ClusterConfig, cpu_host_config, estimate,
                              h100_single_config)
from repro_torch.core.calibration import (HBM_KEY, CalibrationSample,
                                          features_from_totals, fit_profile,
                                          mxu_key, shape_class)
from repro_torch.core.graph_cost import lower_and_cost
from repro_torch.core.hlo_cost import CompiledCost
from repro_torch.core.linreg import Scenario
from repro_torch.models.model import build_model, require_device

# Calibrated ratios outside this band fail the gate: the profile was
# fitted from these very measurements, so a wildly off ratio means the
# measurement path itself is broken, not that the hardware is slow.
RATIO_BAND = (0.25, 4.0)

# Square-matmul sides, one in each shape class (2n^3 FLOPs): on the card
# 6.6e7 / 9.2e9 / 1.1e12.  The small class (at most 1e8 FLOPs, 0.1 us at the
# bf16 peak) never times above the fixed 35 us of ``dispatch_latency`` with
# the host on an H100, and the fitter rejects it; the medium side is the
# largest multiple of 128 in its class (1664), whose bf16 product cleared
# that latency there (37.8 us; 1536 read 33.1, and 1700, off the 128 grid,
# 89.2: tools/calib_cells.py).  On the CPU the reference's fp32 sides
# (3.4e7 / 9.1e8 / 1.3e10).
MATMUL_SIDES = {"cuda": (320, 1664, 8192), "cpu": (256, 768, 1856)}
MATMUL_SIDES_QUICK = (256, 768)
STREAM_ELEMENTS = 48 * 2 ** 20          # fp32: 192 MB in, 192 MB out

# The reference's two cheap-to-compile smoke archs; on the card at full
# width and depth, bf16, B 8 x S 2048 (the train phase's batch).
SMOKE_ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b")
ARCH_BATCH = {"cuda": (8, 2048), "cpu": (2, 64)}
# The arch cells (arch, batch, length), each the plain program's
# ``model.loss`` forward as the reference harvests it.  On the CPU the
# reference's two.  On the card those two at full width and 8 x 2048 share
# nearly one mix of work (matmul over HBM seconds 0.042 and 0.046): the
# fit's columns were nearly collinear (condition number 51 with each column
# scaled to unit length), lstsq drove the bf16 term negative and the gate
# failed.  qwen1.5-4b, whose wider layers raise the matmul share, at 8 x
# 2048 (0.107) and 64 x 256 (0.201, fewer S^2 bytes of the plain path's
# attention) brings that number to 4.1 (tools/calib_cells.py on an H100).
ARCH_CELLS = {
    "cuda": tuple((a, *ARCH_BATCH["cuda"]) for a in SMOKE_ARCHS)
    + (("qwen1.5-4b", *ARCH_BATCH["cuda"]), ("qwen1.5-4b", 64, 256)),
    "cpu": tuple((a, *ARCH_BATCH["cpu"]) for a in SMOKE_ARCHS)}
SEED = 0


def cell_name(arch_id: str, batch: int, seq: int, device_type: str) -> str:
    """An arch cell's name: the arch id at the device's own batch x length
    (the reference's cells), else ``arch@BxS``."""
    if (batch, seq) == ARCH_BATCH[device_type]:
        return arch_id
    return f"{arch_id}@{batch}x{seq}"


def feature_matrix(samples: Sequence[CalibrationSample]):
    """The matrix ``fit_profile`` least-squares: its term keys, the labels of
    the samples it accepts, one row of features each, and the matrix's
    condition number, raw and with every column scaled to unit length (the
    second is blind to the terms' units and reads how nearly collinear the
    columns are)."""
    rows = [s for s in samples if not s.polluted and s.features
            and s.measured_seconds - s.fixed_seconds > 0]
    keys = sorted({k for s in rows for k, v in s.features.items() if v > 0})
    x = np.array([[s.features.get(k, 0.0) for k in keys] for s in rows],
                 dtype=float).reshape(len(rows), len(keys))
    norms = np.linalg.norm(x, axis=0)
    cond = float(np.linalg.cond(x)) if x.size else float("nan")
    cond_scaled = (float(np.linalg.cond(x / np.where(norms > 0, norms, 1.0)))
                   if x.size else float("nan"))
    return {"keys": keys, "labels": [s.label for s in rows],
            "matrix": x.tolist(), "cond": cond, "cond_scaled": cond_scaled}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(fn: Callable, args: Sequence, reps: int,
          dev: torch.device) -> float:
    """Median wall seconds of one call (the first call excluded), the
    device synchronised before and after each."""
    fn(*args)
    ts = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _graph_features(cost: CompiledCost, cc: ClusterConfig) -> Dict[str, float]:
    """A traced program's features, keyed as ``CompiledCost.time_breakdown``
    consults the profile: bf16-dominated matmul work by shape class, and
    HBM traffic."""
    feats = {mxu_key("bfloat16", shape_class(cost.flops_per_device)):
             cost.flops_per_device / cc.chip.peak("bfloat16")}
    if cost.bytes_per_device > 0:
        feats[HBM_KEY] = cost.bytes_per_device / cc.chip.hbm_bw
    return feats


def _graph_sample(label: str, fn: Callable, args: Sequence, cc, reps: int,
                  dev: torch.device, features=_graph_features
                  ) -> Tuple[CalibrationSample, CompiledCost, dict]:
    t0 = time.perf_counter()
    _, cost = lower_and_cost(label, fn, args)
    trace_s = time.perf_counter() - t0
    measured = _time(fn, args, reps, dev)
    sample = CalibrationSample(
        features=features(cost, cc), measured_seconds=measured,
        fixed_seconds=cc.dispatch_latency, label=label,
        polluted=bool(cost.unknown_dtypes))
    return sample, cost, {"trace_seconds": trace_s}


def _matmul_sample(n: int, cc, reps: int, dev: torch.device,
                   dtype: torch.dtype):
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    y = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    return _graph_sample(f"matmul{n}", lambda a, b: a @ b, (x, y), cc, reps,
                         dev)


def _stream_sample(cc, reps: int, dev: torch.device):
    """A bandwidth-bound elementwise op: pins the HBM fraction.  Eager runs
    it as two ops (a multiply, then an add), each reading and writing the
    whole vector; the trace counts both."""
    x = torch.ones((STREAM_ELEMENTS,), dtype=torch.float32, device=dev)
    return _graph_sample("stream", lambda a: a * 1.0001 + 1.0, (x,), cc,
                         reps, dev,
                         lambda cost, cc: {HBM_KEY: cost.bytes_per_device
                                           / cc.chip.hbm_bw})


def _scenario(row: dict) -> Scenario:
    return Scenario(row["name"], row["m"], row["n"], dtype=row["dtype"])


def _linreg_estimate(sc: Scenario, cc) -> float:
    """The compute-side estimate of the plan that runs (as
    ``bench_accuracy.linreg_row`` makes it)."""
    costed = estimate(bench_accuracy.linreg_program(sc, cc)[0], cc)
    return costed.breakdown.compute + costed.breakdown.collective


def _linreg_cell(row: dict, cc) -> CalibrationSample:
    """One executed LinReg DS row as a sample: its plan's work totals as
    features, its warm time as the measurement."""
    sc = _scenario(row)
    costed = estimate(bench_accuracy.linreg_program(sc, cc)[0], cc)
    return CalibrationSample(
        features=features_from_totals(costed.totals, cc),
        measured_seconds=row["actual_ms"] / 1e3,
        estimated_seconds=costed.breakdown.compute
        + costed.breakdown.collective,
        label=f"linreg:{sc.name}")


def _arch_cell(arch_id: str, cc, reps: int, dev: torch.device,
               batch: int, seq: int):
    """One arch's ``model.loss`` forward under ``no_grad`` on the plain path
    at ``batch`` x ``seq``, traced and costed, then timed on the same
    inputs; the real run's peak memory beside the trace's."""
    cfg = get_config(arch_id)
    if dev.type != "cuda":
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen, device=dev)}

    def loss(p, b):
        with torch.no_grad():
            return model.loss(p, b)[0]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sample, cost, info = _graph_sample(
        f"arch:{cell_name(arch_id, batch, seq, dev.type)}", loss,
        (params, tokens), cc, reps, dev)
    info.update(batch=[batch, seq], dtype=cfg.dtype,
                n_layers=cfg.n_layers, d_model=cfg.d_model,
                peak_memory_bytes_trace=cost.peak_memory_bytes,
                max_memory_allocated_bytes=(
                    torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None))
    del params, tokens
    return sample, cost, info


def _arch_estimate(cost: CompiledCost, cc) -> float:
    bd = cost.time_breakdown(cc)
    return bd.compute + bd.collective


def _median_abs_dev(ratios: List[float]) -> float:
    devs = sorted(abs(r - 1.0) for r in ratios)
    n = len(devs)
    return devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1] + devs[n // 2])


def gate(unc: List[float], cal: List[float]) -> dict:
    """The reference's drift gate over the cells' uncalibrated and
    calibrated ratios: the calibrated median |ratio - 1| strictly below the
    uncalibrated one, and every calibrated ratio inside RATIO_BAND."""
    in_band = all(RATIO_BAND[0] <= r <= RATIO_BAND[1] for r in cal)
    med_unc, med_cal = _median_abs_dev(unc), _median_abs_dev(cal)
    return {"median_uncal": med_unc, "median_cal": med_cal,
            "in_band": in_band,
            "verdict": "PASS" if in_band and med_cal < med_unc else "FAIL"}


def _check_sample(s: CalibrationSample, cell: bool) -> None:
    """Raise on a broken measurement path: a time that is not finite and
    positive or an empty feature vector (any sample); for a validation
    cell also a polluted sample or one the fitter would reject."""
    bad = (not (math.isfinite(s.measured_seconds)
                and s.measured_seconds > 0) or not s.features
           or not all(math.isfinite(v) for v in s.features.values()))
    if cell:
        bad = bad or s.polluted or s.measured_seconds <= s.fixed_seconds
    if bad:
        raise AssertionError(f"calibration sample {s.label} is broken: {s}")


def calibrate(device="cuda", quick: bool = False,
              linreg: Optional[List[dict]] = None) -> dict:
    """Harvest, fit and validate (see the module's docstring).  ``linreg``:
    rows of ``bench_accuracy.linreg_rows`` already measured on this device
    (its last, summary row may be included); by default they are measured
    here.  Returns the samples, the fit, the profile, each cell's drift and
    the gate, with the seconds the harvest and fit took."""
    t_start = time.perf_counter()
    dev = require_device(device)
    cc = h100_single_config() if dev.type == "cuda" else cpu_host_config()
    reps = 3 if quick else 5
    if linreg is None:
        scenarios = (bench_accuracy.H100_SCENARIOS if dev.type == "cuda"
                     else bench_accuracy.H100_SCENARIOS[1:2 if quick else 4])
        linreg = bench_accuracy.linreg_rows(dev, scenarios)
    linreg = [r for r in linreg if "name" in r]

    samples: List[CalibrationSample] = []
    cells: Dict[str, Tuple[Callable, float]] = {}
    arch_info: Dict[str, dict] = {}
    mm_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    sides = (MATMUL_SIDES_QUICK if quick and dev.type != "cuda"
             else MATMUL_SIDES[dev.type])
    for n in sides:
        s, _, _ = _matmul_sample(n, cc, reps, dev, mm_dtype)
        _check_sample(s, cell=False)
        samples.append(s)
    s, _, _ = _stream_sample(cc, reps, dev)
    _check_sample(s, cell=False)
    samples.append(s)
    for row in linreg:
        s = _linreg_cell(row, cc)
        _check_sample(s, cell=True)
        samples.append(s)
        cells[row["name"]] = (lambda c, sc=_scenario(row):
                              _linreg_estimate(sc, c), s.measured_seconds)
    for arch_id, batch, seq in ARCH_CELLS[dev.type]:
        name = cell_name(arch_id, batch, seq, dev.type)
        s, cost, info = _arch_cell(arch_id, cc, reps, dev, batch, seq)
        _check_sample(s, cell=True)
        samples.append(s)
        cells[name] = (lambda c, cost=cost: _arch_estimate(cost, c),
                       s.measured_seconds)
        arch_info[name] = {"flops": cost.flops_per_device,
                           "bytes": cost.bytes_per_device, **info}
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "chip_spec": cc.chip.name, "reps": reps,
        "samples": [{"label": s.label, "features": dict(s.features),
                     "measured_s": s.measured_seconds,
                     "fixed_s": s.fixed_seconds, "polluted": s.polluted}
                    for s in samples],
        "arch_cells": arch_info,
        **fit_and_gate(samples, cells, cc),
        "seconds": time.perf_counter() - t_start}


def fit_and_gate(samples: Sequence[CalibrationSample],
                 cells: Dict[str, Tuple[Callable, float]], cc) -> dict:
    """The fit over ``samples`` and each validation cell's drift under it:
    ``cells`` maps a cell's name to (its estimate under a config, its
    measured seconds).  Returns the fit, the calibrated config, the drift,
    the gate and the fit's feature matrix (:func:`feature_matrix`)."""
    fit = fit_profile(samples, chip_name=cc.chip.name)
    cc_cal = cc.with_calibration(fit.profile)
    drift = {}
    for name, (est_fn, measured) in cells.items():
        drift[name] = {"measured_s": measured,
                       "ratio_uncal": est_fn(cc) / measured,
                       "ratio_cal": est_fn(cc_cal) / measured}
    return {"fit": fit, "cc_cal": cc_cal, "drift": drift,
            "features": feature_matrix(samples),
            **gate([d["ratio_uncal"] for d in drift.values()],
                   [d["ratio_cal"] for d in drift.values()])}


def rows(result: dict) -> List[str]:
    """The reference's rows of one :func:`calibrate` result."""
    fit = result["fit"]
    feats = result["features"]
    out = [f"calib.fit,0,terms={len(fit.factors)};"
           f"residual={fit.residual:.3f};samples={fit.n_samples};"
           f"rejected={fit.n_rejected}",
           f"calib.features,0,keys={'/'.join(feats['keys'])};"
           f"cond={feats['cond']:.4g};cond_scaled={feats['cond_scaled']:.4g}"]
    for label, row in zip(feats["labels"], feats["matrix"]):
        out.append(f"calib.features.{label},0," + ";".join(
            f"{k}={v:.4g}" for k, v in zip(feats["keys"], row) if v > 0))
    out.append(f"calib.profile,0,{fit.profile.describe()}")
    for name, d in result["drift"].items():
        out.append(f"calib.drift.{name},0,ratio_uncal={d['ratio_uncal']:.3f};"
                   f"ratio_cal={d['ratio_cal']:.3f}")
    out.append(f"calib.drift,0,median_uncal={result['median_uncal']:.3f};"
               f"median_cal={result['median_cal']:.3f};"
               f"band=[{RATIO_BAND[0]:.2f},{RATIO_BAND[1]:.2f}];"
               f"{result['verdict']}")
    return out


def run(quick: bool = False, device="cuda") -> List[str]:
    return rows(calibrate(device, quick))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    for row in run(args.quick, args.device):
        print(row, flush=True)


if __name__ == "__main__":
    main()
