#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phase alone: the kernels' build,
qwen1.5-0.5b's train phase, the trainer phase (whose losses and step times
the mesh phase is held against), then ``phase_mesh``: the sharded
``Trainer`` on a one-rank CUDA mesh, the restore onto its shardings and
one dry-run cell.  Prints the card's name and power limit, the build's
seconds, the train phase's step times, the trainer and mesh phases' lines
and the total seconds.  Needs one GPU (about 5 minutes).

    python3 tools/mesh_phase.py
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
    run = cs.phase_train(cs.TRAINER_ARCH, "none", 0.05)
    cs.emit({k: run[k] for k in ("arch", "step_ms", "warm_median_step_ms",
                                  "launches", "max_memory_allocated_bytes")})
    trainer_run = cs.phase_trainer({cs.TRAINER_ARCH: run})
    cs.emit(trainer_run)
    mesh = cs.phase_mesh({cs.TRAINER_ARCH: run}, trainer_run)
    mesh["dryrun"] = cs._mesh_dryrun_cell()
    cs.emit(mesh)
    cs.emit({"total_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
