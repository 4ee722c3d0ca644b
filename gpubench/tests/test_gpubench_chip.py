"""On the card, at each cell's own size (``-m gpu``; these skip without a
GPU): a short run is correct; with the lower-precision control judged in
the program's place it is not; and for a train cell the planted half-batch
fault is caught.

    python -m pytest -q gpubench/tests/test_gpubench_chip.py -m gpu
"""
import json
import subprocess
import sys

import pytest

from gpubench.lib import spec

S = spec.load()
CELLS = [w["name"] for w in S["workloads"]]


def run(cell, seed, *extra):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "5", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=1200, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    extra_line = [x for x in out.stderr.splitlines()
                  if x.startswith("extra: ")]
    return (json.loads(out.stdout.strip().splitlines()[-1]),
            json.loads(extra_line[-1][len("extra: "):]))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell, need_gpu):
    line, _ = run(cell, 2_900_000_000)
    assert line["correct"], line["checks"]
    line, extra = run(cell, 2_900_000_001, "--control", "fp8")
    assert not line["correct"], line["checks"]
    assert all(c["of"] == "control fp8" for c in line["checks"].values())
    limits = spec.checks_file(cell)["limits"]
    assert all(extra["program"][k] <= limits[k] for k in limits), extra


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c])
def test_half_the_batch_is_caught(cell, need_gpu):
    line, _ = run(cell, 2_900_000_002, "--fault", "half_batch")
    assert not line["correct"], line["checks"]
