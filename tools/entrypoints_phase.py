#!/usr/bin/env python3
"""``chip_smoke.py``'s entrypoints phase alone: the kernels' build, then
``phase_entrypoints``: the LinReg DS example through ``tsmm`` with its
estimate, each cost-model example with ``--h100`` and the paper-table
modules at ``--quick``, while the mesh phase's dry-run cell (qwen1.5-0.5b
``train_4k`` on one H100 node's fake mesh) traces on the CPU in a
subprocess for ``render_tables``.  Prints the card's name and power limit, the
build's seconds, the phase's line and the total seconds.  Needs one GPU
(about 5 minutes).

    python3 tools/entrypoints_phase.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.device_line(), flush=True)
    cs.emit({"phase": "build", "seconds": cs._build.build()})
    mesh = {}
    entry = cs.phase_entrypoints(mesh)
    cs.emit({"dryrun": mesh["dryrun"]["status"],
             "trace_s": mesh["dryrun"]["trace_s"]})
    cs.emit(entry)
    cs.emit({"total_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
