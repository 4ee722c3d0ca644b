"""The port's paper-§3.4 benchmark on the CPU at small sizes: the rows it
reports, its estimates against the reference cost model's for the same
scenario and the same H100 cluster, and its refusal to run on the card when
there is none."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core as ref
from repro.core import linreg as ref_linreg
from repro_torch.benchmarks import bench_accuracy as ba
from repro_torch.configs import get_config
import repro_torch.core as port
from repro_torch.core import H100_SXM, h100_single_config
from repro_torch.core import linreg as port_linreg
from repro_torch.core.linreg import Scenario
from repro_torch.examples import linreg_ds

SMALL = [Scenario("small-f32", 4096, 128, dtype="float32"),
         Scenario("small-f64", 3000, 96, dtype="float64")]
ROW_KEYS = {"name", "m", "n", "dtype", "path", "exec_type", "tsmm_op",
            "mm_op", "est_ms", "actual_ms", "ratio", "est_part_ms",
            "actual_part_ms", "tsmm_launches", "device"}


def ref_h100():
    """The reference's ClusterConfig for the port's H100 preset."""
    cc = ref.ClusterConfig(chip=ref.ChipSpec(**dataclasses.asdict(H100_SXM)),
                           mesh_shape=(1,), mesh_axes=("data",))
    assert cc.fingerprint() == h100_single_config().fingerprint()
    return cc


def test_linreg_rows_on_the_cpu():
    rows = ba.linreg_rows("cpu", scenarios=SMALL)
    assert len(rows) == len(SMALL) + 1
    for row, sc in zip(rows, SMALL):
        # only a float32 row's beta is held against a float64 solve
        assert set(row) == ROW_KEYS | ({"max_abs_err_vs_f64"}
                                       if sc.dtype == "float32" else set())
        assert (row["name"], row["m"], row["n"], row["dtype"]) == (
            sc.name, sc.m, sc.n, sc.dtype)
        assert row["path"] == {"float32": "tsmm kernel",
                               "float64": "x.T @ x"}[sc.dtype]
        assert (row["exec_type"], row["tsmm_op"], row["mm_op"]) == (
            "CP", "tsmm", "mm")
        assert row["device"] == "cpu"
        assert row["tsmm_launches"] == 0       # the plain version on the CPU
        assert row["actual_ms"] > 0 and row["est_ms"] > 0
        assert row["ratio"] == row["est_ms"] / row["actual_ms"]
        assert set(row["est_part_ms"]) == set(row["actual_part_ms"]) == {
            "gram", "xty", "solve"}
        assert all(v > 0 for v in row["actual_part_ms"].values())
        # the three products are most of the estimate (the rest: the ridge,
        # the transposes)
        assert 0.9 * row["est_ms"] < sum(row["est_part_ms"].values()) \
            <= row["est_ms"]
    summary = rows[-1]
    worst = max(max(r["ratio"], 1 / r["ratio"]) for r in rows[:-1])
    assert summary == {"worst_factor": worst, "paper_claim": 2.0,
                       "verdict": "PASS" if worst <= 2.0 else "FAIL"}


@pytest.mark.parametrize("sc", SMALL + ba.H100_SCENARIOS,
                         ids=lambda sc: sc.name)
def test_linreg_estimate_equals_the_reference(sc):
    """The estimate of each row is the reference model's for the same
    Scenario on the same H100 cluster, to the last bit, of the program that
    runs: a float64 row's Gram matrix is the whole product ``x.T @ x``, not
    the plan's half-product ``tsmm``.  The card's rows plan CP / tsmm."""
    cc = ref_h100()
    prog, choice = ref_linreg.build_linreg_program(
        ref_linreg.Scenario(sc.name, sc.m, sc.n, dtype=sc.dtype), cc,
        ref_linreg.tpu_budgets(cc))
    if sc.dtype == "float64":
        core = prog.blocks[-1].children
        i = [c.describe() for c in core].index("CP tsmm X -> _mVarA")
        core[i:i + 1] = [
            ref.CreateVar("_mVarXt", ref.TensorStat((sc.n, sc.m), sc.dtype)),
            ref.Compute("matmul", ("_mVarXt", "X"), "_mVarA")]
    b = ref.estimate(prog, cc).breakdown
    want = (b.compute + b.collective) * 1e3
    if sc in SMALL:
        row = ba.linreg_row(sc, torch.device("cpu"))
        assert row["est_ms"] == want
        assert (row["exec_type"], row["tsmm_op"], row["mm_op"]) == (
            choice.exec_type, choice.tsmm_op, choice.mm_op)
    else:
        assert (choice.exec_type, choice.tsmm_op) == ("CP", "tsmm")
        assert want > 0


@pytest.mark.parametrize("sc", [sc for sc in ba.H100_SCENARIOS
                                if sc.dtype == "float64"],
                         ids=lambda sc: sc.name)
def test_float64_rows_cost_the_whole_gram_product(sc):
    """``x.T @ x`` computes all of X^T X: the costed program's products do
    m * n^2 more operations (a multiply and an add each count one) than the
    plan's ``tsmm`` (half the product), and nothing else changes."""
    cc = h100_single_config()
    prog, _ = port_linreg.build_linreg_program(sc, cc,
                                               port_linreg.tpu_budgets(cc))
    half = port.estimate(prog, cc).totals
    full = port.estimate(ba.gram_as_full_product(prog, sc), cc).totals
    assert full.mxu_flops[sc.dtype] - half.mxu_flops[sc.dtype] == \
        pytest.approx(sc.m * sc.n ** 2, rel=1e-12)
    assert (full.vpu_flops, full.ici_bytes) == (half.vpu_flops,
                                                half.ici_bytes)


def test_linreg_beta_matches_a_float64_solve():
    rows = ba.linreg_rows("cpu", scenarios=SMALL)
    # fp32 normal equations of a well-conditioned 4096 x 128 problem
    assert rows[0]["max_abs_err_vs_f64"] < 5e-5
    assert "max_abs_err_vs_f64" not in rows[1]        # the float64 route
    x, y, _ = linreg_ds.make_problem(4096, 128, ba.SEED, torch.device("cpu"))
    x64, y64 = x.double().numpy(), y.double().numpy()
    beta64 = np.linalg.solve(x64.T @ x64 + ba.LINREG_LAM * np.eye(128),
                             x64.T @ y64)
    beta = linreg_ds.solve_linreg(x, y, ba.LINREG_LAM).numpy()
    assert np.abs(beta - beta64).max() < 5e-5


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "mamba2-1.3b",
                                     "zamba2-2.7b"])
def test_serve_estimates_equal_the_reference(arch_id):
    cfg = get_config(arch_id).reduced()
    ref_cfg = ref_configs.get_config(arch_id).reduced()
    cc = ref_h100()
    got = ba.serve_estimates(cfg, batch=2, prompt_len=64, max_len=128)
    assert got["chip_spec"] == "h100_sxm"
    shapes = {"prefill": ref_configs.ShapeConfig("prefill_gpu", 64, 2,
                                                 "prefill"),
              "decode": ref_configs.ShapeConfig("decode_gpu", 128, 2,
                                                "decode")}
    for key, shape in shapes.items():
        row = got[key]
        assert (row["seq_len"], row["batch"]) == (shape.seq_len,
                                                   shape.global_batch)
        for fusion in ("off", "none", "full"):
            c = ref.estimate(ref.build_step_program(
                ref_cfg, shape, ref.ShardingPlan(name="dp", fusion=fusion),
                cc), cc)
            assert row[fusion] == {
                "total_ms": c.total * 1e3, "io_ms": c.breakdown.io * 1e3,
                "compute_ms": c.breakdown.compute * 1e3,
                "collective_ms": c.breakdown.collective * 1e3,
                "latency_ms": c.breakdown.latency * 1e3}
            assert row[fusion]["total_ms"] > 0
        best = ref.choose_plan(ref_cfg, shape, cc)[0]
        assert row["choose_plan"]["plan"] == best.plan.describe()
        assert row["choose_plan"]["fusion"] == best.plan.fusion
        assert row["choose_plan"]["total_ms"] == best.time * 1e3


def test_linreg_rows_refuse_what_they_cannot_run():
    with pytest.raises(ValueError, match="small scenarios"):
        ba.linreg_rows("cpu")
    with pytest.raises(ValueError, match="no LinReg path"):
        ba.linreg_rows("cpu", scenarios=[Scenario("bf", 64, 8,
                                                  dtype="bfloat16")])


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ba.linreg_rows()
