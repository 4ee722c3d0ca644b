#!/usr/bin/env python3
"""Where the train step's time goes on the GPU: profiles one warm step of
``make_train_step(use_kernel=True)`` for a ported arch (full width, the
depth of ``chip_smoke.py``'s train phase, bf16, random weights, the
reference's AdamW defaults) with
torch.profiler and prints device time by kernel, the device's busy share
and the peak memory; for a moe arch also the device time of each
``torch.einsum`` of the forward and of its rerun under remat
(``tools/profile_serve.py``'s ``einsum_ranges``; the backward's products
are not in them).

    python3 tools/profile_train.py \
        [--arch qwen1.5-0.5b|mamba2-1.3b|zamba2-2.7b|qwen1.5-4b|...]

The batch, sequence length and remat policy are those of ``chip_smoke.py``'s
train phase (``path_batch``, ``TRAIN_SEQ``, ``TRAIN_PATHS``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

# first: it sets the allocator's configuration before torch is imported
from chip_smoke import (TRAIN_PATHS, TRAIN_SEQ,  # noqa: E402
                        path_batch, path_config)
import torch                                                 # noqa: E402
from profile_serve import einsum_ranges, window             # noqa: E402
from repro_torch.core import ShardingPlan                    # noqa: E402
from repro_torch.models.model import build_model            # noqa: E402
from repro_torch.optim import adamw                         # noqa: E402
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402

REMAT = {arch: remat for arch, remat, _ in TRAIN_PATHS}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(REMAT))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = path_config(args.arch, "train")
    remat = REMAT[args.arch]
    model = build_model(cfg)
    params = model.init(0)
    opt_cfg = adamw.AdamWConfig()
    step = make_train_step(model, opt_cfg, ShardingPlan(remat=remat),
                           use_kernel=True, donate=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = path_batch(args.arch, "train")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, TRAIN_SEQ),
                                     generator=gen, device="cuda")}
    state = {"params": params, "opt": adamw.init(opt_cfg, params)}

    def one_step():
        state["params"], state["opt"], _, state["metrics"] = step(
            state["params"], state["opt"], None, batch)

    one_step()                       # warm up: build and load the kernels
    torch.cuda.reset_peak_memory_stats()
    one_step()
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"arch": args.arch, "layers": cfg.n_layers,
                      "batch": rows, "seq": TRAIN_SEQ, "remat": remat,
                      "max_memory_allocated_bytes": peak}), flush=True)
    with einsum_ranges(cfg):
        window("train step", one_step, 1)


if __name__ == "__main__":
    main()
