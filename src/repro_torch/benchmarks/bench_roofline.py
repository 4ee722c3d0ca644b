"""Roofline table of the dry run (counterpart of the reference's
``benchmarks/bench_roofline.py``): reads ``launch.dryrun``'s artifacts.

Per (arch x shape x mesh): the three roofline terms of the traced plan, the
dominant bottleneck, the MODEL_FLOPS / traced FLOPs usefulness ratio, and
the fits-HBM verdict from the traced step's per-device memory.  The HBM
budget is the cell's cluster's chip's (an H100's 80e9 bytes), not a
figure of another chip.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_roofline \\
        [--artifact-dir build/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

from repro_torch.launch.dryrun import ARTIFACT_DIR, cluster


def load_artifacts(artifact_dir: str = ARTIFACT_DIR,
                   mesh: Optional[str] = None,
                   tag: Optional[str] = "") -> List[dict]:
    """The artifacts in ``artifact_dir``, of one mesh kind when ``mesh`` is
    given and of one tag (``None``: every tag)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(artifact_dir,
                                              "dryrun_*.json"))):
        with open(path) as f:
            d = json.load(f)
        if mesh and d.get("mesh") != mesh:
            continue
        if tag is not None and d.get("tag", "") != tag:
            continue
        rows.append(d)
    return rows


def hbm_budget(d: dict) -> float:
    """The HBM of the cell's cluster's chip, in bytes."""
    return cluster(d["mesh"]).chip.hbm_bytes


def used_bytes(d: dict) -> float:
    """The traced step's per-device memory: its peak, or where the trace
    gave none, arguments + temporaries + outputs."""
    ma = d["memory_analysis"]
    return ma["peak_bytes"] or (ma["argument_bytes"] + ma["temp_bytes"]
                                + ma["output_bytes"])


def describe(d: dict) -> str:
    r = d["roofline"]
    used = used_bytes(d)
    ufr = d.get("useful_flops_ratio")
    parts = [
        f"dom={r['dominant'].replace('_s', '')}",
        f"compute={r['compute_s']*1e3:.2f}ms",
        f"mem={r['memory_s']*1e3:.2f}ms",
        f"coll={r['collective_s']*1e3:.2f}ms",
        f"useful={ufr:.2f}" if ufr else "useful=n/a",
        f"hbm={used/1e9:.1f}GB",
        f"fits={used <= hbm_budget(d)}",
    ]
    return ";".join(parts)


def run(quick: bool = False, artifact_dir: str = ARTIFACT_DIR) -> List[str]:
    rows = []
    for d in load_artifacts(artifact_dir):
        cell = f"{d['arch']}|{d['shape']}|{d['mesh']}"
        if d["status"] == "skip":
            rows.append(f"roofline.{cell},0,SKIP;{d['why'][:60]}")
        elif d["status"] != "ok":
            rows.append(f"roofline.{cell},0,FAIL;{d.get('error', '')[:80]}")
        else:
            bound_us = d["roofline"]["roofline_bound_s"] * 1e6
            rows.append(f"roofline.{cell},{bound_us:.1f},{describe(d)}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact-dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for row in run(artifact_dir=args.artifact_dir):
        print(row)


if __name__ == "__main__":
    main()
