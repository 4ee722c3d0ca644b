"""``repro_torch.benchmarks.bench_calibrate`` and ``bench_fusion`` against
the reference's ``benchmarks/bench_calibrate.py`` and
``benchmarks/bench_fusion.py`` on the CPU, at the reference's quick sizes.

Rows and fields are the reference's; the fit and the gate are the same
arithmetic on the same numbers (tolerance 0).  Measured times and fitted
factors of a CPU run are the host's and are not compared."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_calibrate as ref_calibrate  # noqa: E402
from benchmarks import bench_fusion as ref_fusion        # noqa: E402
from repro.core import calibration as ref_calibration    # noqa: E402
from repro_torch.benchmarks import bench_calibrate, bench_fusion  # noqa: E402
from repro_torch.core import calibration                 # noqa: E402

SEED = 0


def parse(row: str):
    """(name, {field: value}) of a ``name,us,derived`` row; a bare verdict
    (PASS, MATCH, ...) is kept under its own name."""
    name, _, derived = row.split(",", 2)
    fields = {}
    for part in derived.split(";"):
        key, eq, value = part.partition("=")
        fields[key if eq else part] = value if eq else None
    return name, fields


def test_calibrate_rows_have_the_reference_names_and_fields():
    """The reference's rows, names and fields; beside them the port's
    ``calib.features`` rows: the fit's term keys and its condition numbers,
    then one row of features for each sample the fit accepts."""
    rows = [parse(r) for r in bench_calibrate.run(quick=True, device="cpu")]
    ref = [parse(r) for r in ref_calibrate.run(quick=True)]
    feats = [(n, f) for n, f in rows if n.startswith("calib.features")]
    mine = [(n, f) for n, f in rows if not n.startswith("calib.features")]
    assert feats[0][0] == "calib.features"
    assert set(feats[0][1]) == {"keys", "cond", "cond_scaled"}
    assert float(feats[0][1]["cond"]) >= float(feats[0][1]["cond_scaled"]) \
        >= 1.0
    keys = set(feats[0][1]["keys"].split("/"))
    assert len(feats) - 1 == int(rows[0][1]["samples"])
    for _, f in feats[1:]:
        assert set(f) <= keys and all(float(v) > 0 for v in f.values())
    # the LinReg cell: the reference's "cpu-S" is the port's "f64-S", both
    # 20000 x 256 in float64
    assert [n.replace("f64-S", "cpu-S") for n, _ in mine] == [n for n, _ in
                                                              ref]
    for (name, fields), (_, ref_fields) in zip(mine, ref):
        if name == "calib.profile":
            continue                        # the fitted factors themselves
        keys = {k for k in fields if k not in ("PASS", "FAIL")}
        assert keys == {k for k in ref_fields if k not in ("PASS", "FAIL")}
        if name.startswith("calib.drift."):
            assert all(np.isfinite(float(v)) and float(v) > 0
                       for v in fields.values())
    assert mine[-1][1]["band"] == ref[-1][1]["band"] == "[0.25,4.00]"
    assert bench_calibrate.RATIO_BAND == ref_calibrate.RATIO_BAND


@pytest.mark.parametrize("n", [1, 2, 5, 6])
def test_gate_matches_the_reference(n):
    rng = np.random.default_rng(SEED + n)
    unc = list(rng.uniform(0.05, 6.0, n))
    cal = list(rng.uniform(0.2, 2.0, n))
    g = bench_calibrate.gate(unc, cal)
    assert g["median_uncal"] == ref_calibrate._median_abs_dev(unc)
    assert g["median_cal"] == ref_calibrate._median_abs_dev(cal)
    lo, hi = ref_calibrate.RATIO_BAND
    ref_ok = (all(lo <= r <= hi for r in cal)
              and ref_calibrate._median_abs_dev(cal)
              < ref_calibrate._median_abs_dev(unc))
    assert g["verdict"] == ("PASS" if ref_ok else "FAIL")
    # a calibrated ratio out of the band fails, however good the median
    assert bench_calibrate.gate(unc, [1.0] * (n - 1) + [4.5])["verdict"] \
        == "FAIL"


def test_fit_matches_the_reference():
    """A fit from samples made with numpy from a seed: the port's
    ``fit_profile`` (the reference's, copied) gives the same factors,
    residual and profile as the reference's."""
    rng = np.random.default_rng(SEED)
    keys = [calibration.mxu_key("bfloat16", c)
            for c in calibration.SHAPE_CLASSES] + [calibration.HBM_KEY]
    rows = []
    for i in range(10):
        feats = {k: float(v) for k, v in zip(keys, rng.uniform(0, 1e-3, 4))
                 if v > 2e-4}
        rows.append((feats, float(rng.uniform(1e-4, 5e-3)),
                     float(rng.uniform(0, 5e-5)), i == 3))
    fits = []
    for mod in (calibration, ref_calibration):
        samples = [mod.CalibrationSample(features=f, measured_seconds=m,
                                         fixed_seconds=x, label=str(i),
                                         polluted=p)
                   for i, (f, m, x, p) in enumerate(rows)]
        fits.append(mod.fit_profile(samples, chip_name="h100_sxm"))
    mine, ref = fits
    assert mine.factors == ref.factors and mine.factors
    assert mine.residual == ref.residual
    assert (mine.n_samples, mine.n_rejected) == (ref.n_samples,
                                                 ref.n_rejected) == (9, 1)
    assert mine.profile.describe() == ref.profile.describe()


def test_fusion_rows_match_the_reference():
    mine = dict(parse(r) for r in bench_fusion.run(quick=True, device="cpu"))
    ref = dict(parse(r) for r in ref_fusion.run(quick=True))
    flips = [n for n in mine if n.startswith(("fusion.flip.",
                                              "fusion.search."))]
    assert flips == ["fusion.flip.qwen1.5-0.5b|decode_32k|pod",
                     "fusion.search.qwen1.5-0.5b|decode_32k|pod",
                     "fusion.flip.gemma3-12b|decode_32k|pod",
                     "fusion.search.gemma3-12b|decode_32k|pod"]
    for name in flips:
        assert mine[name] == ref[name]
    graph = [n for n in mine if n.startswith("fusion.graph.")]
    assert len(graph) == 3
    for name in graph:
        theirs = ref[name.replace("fusion.graph.", "fusion.hlo.")]
        assert ("MATCH" in mine[name]) == ("MATCH" in theirs)
        assert "MATCH" in mine[name]
        assert (mine[name]["graph_fused"], mine[name]["graph_unfused"]) == (
            theirs["hlo_fused"], theirs["hlo_unfused"])
        assert (mine[name]["ana_fused"], mine[name]["ana_unfused"]) == (
            theirs["ana_fused"], theirs["ana_unfused"])
    gate = mine["resource_opt.fusion"]
    assert "PASS" in gate and gate["graph_match"] == "True"


def test_gemma_fusion_cells_match_the_reference(monkeypatch):
    """gemma3-12b's two decode cells of the full grid (``pod`` and
    ``v5p-pod``; the quick run takes the first), row for row against the
    reference's: each flips the winner to a fused plan, and beam and batched
    search find the exhaustive winner."""
    from repro.core.costmodel import PlanCostCache as RefPlanCostCache
    from repro_torch.core.costmodel import PlanCostCache
    cells = [c for c in ref_fusion.FLIP_CELLS if c[0] == "gemma3-12b"]
    assert cells == [c for c in bench_fusion.FLIP_CELLS
                     if c[0] == "gemma3-12b"]
    assert [c[2] for c in cells] == ["pod", "v5p-pod"]
    monkeypatch.setattr(ref_fusion, "FLIP_CELLS", cells)
    monkeypatch.setattr(bench_fusion, "FLIP_CELLS", cells)
    ref_rows, ref_flip, ref_match = ref_fusion._flip_rows(False,
                                                          RefPlanCostCache())
    rows, flip, match = bench_fusion._flip_rows(False, PlanCostCache())
    assert [parse(r) for r in rows] == [parse(r) for r in ref_rows]
    assert len(rows) == 4 and (flip, match) == (ref_flip, ref_match) == (
        True, True)
    assert all("FLIP" in r for r in rows if r.startswith("fusion.flip."))
