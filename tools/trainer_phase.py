#!/usr/bin/env python3
"""``chip_smoke.py``'s trainer phase alone, without the serve, estimate
and calibrate phases before it: the kernels' build, qwen1.5-0.5b's train
phase (whose CUDA-event median the trainer phase's step times are held
against), then ``phase_trainer``.  Prints the card's name and power limit,
the build's seconds, the train phase's step times and launches, the
trainer phase's line and the total seconds.  Needs one GPU (about 3
minutes).

    python3 tools/trainer_phase.py
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
    cs.emit(cs.phase_trainer({cs.TRAINER_ARCH: run}))
    cs.emit({"total_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
