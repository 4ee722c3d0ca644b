"""The port's resource-optimizer gate table, ``bench_resource_opt``,
against the reference's ``benchmarks/bench_resource_opt.py``.

``run(quick=True)`` gives the reference's rows, names and fields (about 30
s a package on the CPU, so apart from ``tests/test_torch_paper_tables.py``);
what reads the host's clock is masked as there."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bench_resource_opt as ref_resource_opt    # noqa: E402
from repro_torch.benchmarks import bench_resource_opt            # noqa: E402
from test_torch_paper_tables import masked, rows_and_text       # noqa: E402


def test_resource_opt_rows_are_the_references():
    got, _ = rows_and_text(bench_resource_opt)
    want, _ = rows_and_text(ref_resource_opt)
    assert masked(got) == masked(want)
    assert not any("MISMATCH" in r for r in got)
    gates = {r.split(",")[0]: r.rsplit(";", 1)[-1] for r in got}
    for gate in ("torus3d", "pipeline", "decode_pruning", "cache"):
        assert gates[f"resource_opt.{gate}"] == "PASS"
