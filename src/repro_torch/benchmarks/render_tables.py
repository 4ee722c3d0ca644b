"""Render the dry-run tables from the port's dry-run artifacts.

Counterpart of the reference's ``benchmarks/render_tables.py``.  It reads
``launch.dryrun``'s artifacts in ``build/dryrun/`` (the directory
:mod:`repro_torch.benchmarks.bench_roofline` reads) and prices them on the
card the port runs on: a cell fits when its traced per-device memory is
within :data:`HBM_BUDGET`, an H100's 80e9 bytes, and MFU at the roofline
bound is the model's FLOPs over the cell's cluster's cards at
:data:`PEAK`, the H100's dense bf16 rate.

Usage:  PYTHONPATH=src python -m repro_torch.benchmarks.render_tables \\
            [dryrun|roofline|perf|all] [--artifact-dir build/dryrun]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

from repro_torch.benchmarks.bench_roofline import load_artifacts, used_bytes
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.core.cluster import H100_SXM
from repro_torch.launch.dryrun import ARTIFACT_DIR, cluster

PEAK = H100_SXM.peak("bfloat16")
HBM_BUDGET = H100_SXM.hbm_bytes

ARCH_ORDER = list(ARCH_IDS)
SHAPE_ORDER = list(SHAPES)


def load(artifact_dir: str = ARTIFACT_DIR, mesh: Optional[str] = None,
         tag: str = "") -> Dict[Tuple[str, str, str], dict]:
    return {(d["arch"], d["shape"], d["mesh"]): d
            for d in load_artifacts(artifact_dir, mesh=mesh, tag=tag)}


def fmt_ms(x):
    return f"{x*1e3:.1f}" if x is not None else "-"


def dryrun_table(artifact_dir: str = ARTIFACT_DIR) -> List[str]:
    arts = load(artifact_dir)
    lines = ["| arch | shape | mesh | status | plan | peak HBM/dev | fits | "
             "trace s |",
             "|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            for m in ("single", "multi"):
                d = arts.get((a, s, m))
                if d is None:
                    continue
                if d["status"] == "skip":
                    lines.append(f"| {a} | {s} | {m} | SKIP | — | — | — | — |")
                    continue
                if d["status"] != "ok":
                    lines.append(f"| {a} | {s} | {m} | {d['status']} | — | "
                                 f"— | — | — |")
                    continue
                used = used_bytes(d)
                fits = "yes" if used <= HBM_BUDGET else "**no**"
                lines.append(f"| {a} | {s} | {m} | {d['status']} | "
                             f"{d['plan'].split('[')[0]} | {used/1e9:.1f} GB "
                             f"| {fits} | {d.get('trace_s', 0):.0f} |")
    return lines


def roofline_table(mesh: str = "single",
                   artifact_dir: str = ARTIFACT_DIR) -> List[str]:
    arts = load(artifact_dir, mesh=mesh)
    cards = cluster(mesh).num_chips
    lines = ["| arch | shape | compute s | memory s | collective s | dominant "
             "| MODEL_FLOPS | useful | MFU@bound | next lever |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            d = arts.get((a, s, mesh))
            if d is None or d["status"] != "ok":
                if d is not None and d["status"] == "skip":
                    lines.append(f"| {a} | {s} | — | — | — | SKIP | — | — | "
                                 f"— | {d['why'][:40]} |")
                continue
            r = d["roofline"]
            bound = r["roofline_bound_s"]
            mf = d.get("model_flops") or 0
            mfu = mf / (cards * PEAK * bound) if bound else 0
            ufr = d.get("useful_flops_ratio")
            dom = r["dominant"].replace("_s", "")
            lever = {"compute": "more useful-flop fraction / tensor-core util",
                     "memory": "fuse fp32 intermediates (flash kernel)",
                     "collective": "compress/overlap collectives"}[dom]
            lines.append(
                f"| {a} | {s} | {r['compute_s']:.4f} | {r['memory_s']:.4f}"
                f" | {r['collective_s']:.4f} | {dom} | {mf:.2e} | "
                f"{(1/ufr if ufr else 0):.2f} | {mfu:.3f} | {lever} |")
    return lines


def perf_rows(tag_prefix: str = "h",
              artifact_dir: str = ARTIFACT_DIR) -> List[str]:
    arts = [d for d in load_artifacts(artifact_dir, tag=None)
            if d.get("tag", "").startswith(tag_prefix)
            and d["status"] == "ok"]
    lines = []
    for d in sorted(arts, key=lambda x: (x["arch"], x["shape"], x["tag"])):
        r = d["roofline"]
        lines.append(
            f"{d['arch']} x {d['shape']} [{d['tag']}] plan={d['plan']}: "
            f"compute={fmt_ms(r['compute_s'])}ms "
            f"mem={fmt_ms(r['memory_s'])}ms "
            f"coll={fmt_ms(r['collective_s'])}ms dom={r['dominant']}")
    return lines


def render(which: str = "all", artifact_dir: str = ARTIFACT_DIR) -> str:
    parts = []
    if which in ("dryrun", "all"):
        parts += ["## Dry-run matrix (one H100 node; two nodes)", "",
                  *dryrun_table(artifact_dir)]
    if which in ("roofline", "all"):
        parts += ["", "## Roofline (one H100 node)", "",
                  *roofline_table("single", artifact_dir)]
    if which in ("perf", "all"):
        parts += ["", "## Perf iterations", "",
                  *perf_rows(artifact_dir=artifact_dir)]
    return "\n".join(parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=["dryrun", "roofline", "perf", "all"])
    ap.add_argument("--artifact-dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)
    print(render(args.which, args.artifact_dir))


if __name__ == "__main__":
    main()
