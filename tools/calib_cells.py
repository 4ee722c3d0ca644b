"""Candidate cells of the calibration harvest on the card, and the fit and
gate of each candidate set of them (GPU only).

    python3 tools/calib_cells.py

Measures, once each: the estimate phase's LinReg DS rows, the stream op,
bf16 square matmuls at the sides in ``SIDES`` and ``model.loss`` of each
arch cell in ``CELLS`` on the plain path (as ``bench_calibrate``
measures its own).  Then, for each set in ``SETS`` (matmul sides, arch
cells), fits the profile over that set's samples and prints one JSON line:
the fit's feature matrix and condition numbers, every cell's est /
measured before and after the fit, and the gate.  Each sample is printed
first, one JSON line each, with its features and measured seconds.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402,F401  (the allocator setting, before torch)
import torch  # noqa: E402

from repro_torch.benchmarks import bench_accuracy  # noqa: E402
from repro_torch.benchmarks import bench_calibrate as bc  # noqa: E402
from repro_torch.core import h100_single_config  # noqa: E402

SIDES = (320, 1536, 1600, 1664, 1700, 8192)
CELLS = (("qwen1.5-0.5b", 8, 2048), ("mamba2-1.3b", 8, 2048),
         ("qwen1.5-0.5b", 64, 256), ("mamba2-1.3b", 64, 256),
         ("qwen1.5-4b", 8, 2048), ("qwen1.5-4b", 64, 256))
SETS = {
    "smoke 8x2048": ((320, 1536, 8192), CELLS[:2]),
    "smoke 8x2048, side 1700": ((320, 1700, 8192), CELLS[:2]),
    "smoke 8x2048 + 64x256": ((320, 1700, 8192), CELLS[:4]),
    "smoke 8x2048 + qwen4b": ((320, 1700, 8192), CELLS[:2] + CELLS[4:5]),
    "smoke 8x2048 + qwen4b both": ((320, 1700, 8192),
                                   CELLS[:2] + CELLS[4:6]),
    "all": ((320, 1700, 8192), CELLS),
    # bench_calibrate's choice for the card (MATMUL_SIDES, ARCH_CELLS)
    "chosen": ((320, 1664, 8192), CELLS[:2] + CELLS[4:6]),
}


def main() -> None:
    dev = torch.device("cuda")
    cc = h100_single_config()
    reps = 5
    linreg = [r for r in bench_accuracy.linreg_rows() if "name" in r]
    lin = []
    for row in linreg:
        s = bc._linreg_cell(row, cc)
        lin.append((row["name"], s, (lambda c, sc=bc._scenario(row):
                                     bc._linreg_estimate(sc, c))))
    stream, _, _ = bc._stream_sample(cc, reps, dev)
    mm = {n: bc._matmul_sample(n, cc, reps, dev, torch.bfloat16)[0]
          for n in SIDES}
    arch = {}
    for a, b, sq in CELLS:
        s, cost, _ = bc._arch_cell(a, cc, reps, dev, b, sq)
        arch[(a, b, sq)] = (s, cost)
        torch.cuda.empty_cache()
    for s in [stream, *mm.values(), *(x[1] for x in lin),
              *(x[0] for x in arch.values())]:
        print(json.dumps({"sample": s.label, "features": dict(s.features),
                          "measured_s": s.measured_seconds}), flush=True)
    for name, (sides, cells) in SETS.items():
        samples = [mm[n] for n in sides] + [stream] + [x[1] for x in lin]
        est = {n: (fn, s.measured_seconds) for n, s, fn in lin}
        for a, b, sq in cells:
            s, cost = arch[(a, b, sq)]
            samples.append(s)
            est[bc.cell_name(a, b, sq, "cuda")] = (
                lambda c, cost=cost: bc._arch_estimate(cost, c),
                s.measured_seconds)
        r = bc.fit_and_gate(samples, est, cc)
        print(json.dumps({
            "set": name, "cond": r["features"]["cond"],
            "cond_scaled": r["features"]["cond_scaled"],
            "keys": r["features"]["keys"],
            "factors": r["fit"].factors, "rejected": r["fit"].n_rejected,
            "drift": r["drift"], "median_uncal": r["median_uncal"],
            "median_cal": r["median_cal"], "verdict": r["verdict"]}),
            flush=True)


if __name__ == "__main__":
    main()
