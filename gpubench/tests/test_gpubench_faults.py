"""A whole run on the CPU at a tiny size, the chip's look skipped: sound,
it comes out correct; with a fault planted under the timed path, not.
Train cells: the step that returns its state unchanged, and half of the
batch left out; prefill cells: the served token altered where the engine
samples it.  (One chip: no exchange between chips to leave out.)  The
tiny model runs in fp32, so that a sound run reads far under the cell's own
limits and only the fault can fail them."""
import time

import pytest
import torch

from conftest import tiny_checks, tiny_config, tiny_mix
from gpubench.lib import cli, spec

S = spec.load()
TRAIN = [w["name"] for w in S["workloads"] if "train" in w["traffic"]]
PREFILL = [w["name"] for w in S["workloads"] if "prefill" in w["traffic"]]


def run(cell, fault, seed=11, control=None):
    w = spec.cell(S, cell)
    cfg = tiny_config(spec.config_file(S, w["config"]))
    cfg["dtype"] = "float32"
    out, _ = cli.run_cell(
        S, cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter(),
        cfg=cfg,
        mix=tiny_mix(spec.traffic_file(w["traffic"])),
        checks=tiny_checks(spec.checks_file(cell)), fault=fault,
        control=control)
    return out


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN for f in (
    None, "unchanged", "half_batch")] + [(c, f) for c in PREFILL
                                          for f in (None, "token")])
def test_a_fault_comes_out_incorrect(cell, fault):
    out = run(cell, fault)
    assert out.correct is (fault is None), out.checks
    assert out.attempted > 0 and out.failed == 0
    for name, c in out.checks.items():
        assert set(c) >= {"value", "limit"}
    assert any(c["limit"] is not None for c in out.checks.values())


@pytest.mark.parametrize("cell", TRAIN + PREFILL)
def test_the_control_is_judged_in_the_programs_place(cell):
    """With ``control`` the checks are the lower precision's numbers, the
    verdict is theirs against the limits, and the program's own numbers
    come beside them."""
    out = run(cell, None, control="fp8")
    assert all(c["of"] == "control fp8" for c in out.checks.values())
    assert out.correct is all(
        c["limit"] is None or c["value"] <= c["limit"]
        for c in out.checks.values())
    assert set(out.extra["program"]) == set(out.checks)
