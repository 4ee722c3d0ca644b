#!/usr/bin/env python3
"""Whether a train path fits one GPU at a given cut: the arch at full
width and ``--layers`` layers (a moe arch's routed experts cut to
``--experts``, the batch to ``--batch`` rows; any field not given is the
train phase's own cut, ``chip_smoke.DEPTH_CUTS``), bf16, random weights,
the length and remat policy of ``chip_smoke.py``'s train phase, one
``value_and_grad``
(as the phase's first check runs it) and then ``--steps`` donated steps of
``make_train_step(use_kernel=True, donate=True)`` with the reference's
AdamW defaults.  Prints one JSON line: the card's name and power limit,
the cut, each step's ms by CUDA events and the peak memory, or
``"out_of_memory": true`` (exit 0 either way).

    python3 tools/train_depth.py --arch gemma3-12b --layers 12
    python3 tools/train_depth.py --arch deepseek-v3-671b --layers 2 \
        --experts 16 --batch 2

A window-pattern arch's depth must be a multiple of its pattern's period.
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

# first: it sets the allocator's configuration before torch is imported
from chip_smoke import (DEPTH_CUTS, TRAIN_PATHS,  # noqa: E402
                        TRAIN_SEQ, TRAIN_SEQS, path_batch, path_config,
                        random_batch)
import torch                                                 # noqa: E402
from repro_torch.core import ShardingPlan                    # noqa: E402
from repro_torch.models.model import build_model            # noqa: E402
from repro_torch.optim import adamw                         # noqa: E402
from repro_torch.runtime.train_loop import (make_train_step,  # noqa: E402
                                            value_and_grad)

REMAT = {arch: remat for arch, remat, _ in TRAIN_PATHS}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b", choices=sorted(REMAT))
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--experts", type=int, default=None,
                    help="routed experts of a moe arch")
    ap.add_argument("--batch", type=int, default=None, help="rows")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cut = dict(DEPTH_CUTS.get((args.arch, "train"), {}), reason="probe",
               n_layers=args.layers)
    for key, value in (("n_experts", args.experts), ("batch", args.batch)):
        if value is not None:
            cut[key] = value
    DEPTH_CUTS[(args.arch, "train")] = cut
    cfg = path_config(args.arch, "train")
    rows = path_batch(args.arch, "train")
    remat = REMAT[args.arch]
    seq = TRAIN_SEQS.get(args.arch, TRAIN_SEQ)
    out = {"device": smi, "arch": args.arch,
           "cut": {k: v for k, v in cut.items() if k != "reason"},
           "batch": rows, "seq_len": seq, "remat": remat}
    torch.cuda.reset_peak_memory_stats()
    try:
        model = build_model(cfg)
        params = model.init(0)
        batch = random_batch(cfg.vocab_size, rows, seq, cfg)
        grads = value_and_grad(model, params, batch, remat=remat,
                               use_kernel=True)[2]
        del grads
        torch.cuda.empty_cache()
        opt_cfg = adamw.AdamWConfig()
        step = make_train_step(model, opt_cfg, ShardingPlan(remat=remat),
                               use_kernel=True, donate=True)
        opt = adamw.init(opt_cfg, params)
        times = []
        for _ in range(args.steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, _, metrics = step(params, opt, None, batch)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out.update(out_of_memory=False, step_ms=times,
                   loss=float(metrics["loss"]))
    except torch.OutOfMemoryError as err:
        out.update(out_of_memory=True, error=str(err).splitlines()[0])
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
