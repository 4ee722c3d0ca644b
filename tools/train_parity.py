#!/usr/bin/env python3
"""Where the bf16 gradients of the kernel path part from the plain path's,
and which of the two is nearer the truth: for one arch cut to ``--layers``
layers (full width, random weights from the seed, B 2 x S 1024 as
``chip_smoke.py``'s gradient parity), the bf16 gradients of the kernel path
and of the plain path, each against the fp32 plain gradients of the same
weights, per leaf (largest error over the largest magnitude).  A sound
kernel path reads about as far from the fp32 gradients as the plain one.

    python3 tools/train_parity.py --arch zamba2-2.7b --layers 12 \\
        [--attn-every 6] [--remat full]

GPU only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (PARITY_BATCH, PARITY_SEQ, SEED,  # noqa: E402
                        TRAIN_PATHS, _named_leaves, random_batch)
import torch                                                  # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models.model import build_model              # noqa: E402
from repro_torch.optim.adamw import tree_map                  # noqa: E402
from repro_torch.runtime.train_loop import value_and_grad     # noqa: E402


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    top = float(ref.float().abs().max())
    return float((a.float() - ref.float()).abs().max()) / max(top, 1e-30)


def main() -> None:
    remats = {arch: remat for arch, remat, _ in TRAIN_PATHS}
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(remats))
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--attn-every", type=int,
                    help="the hybrid's layers a shared-block application")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers,
                              dtype="bfloat16")
    if args.attn_every:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, attn_every=args.attn_every))
    remat = remats[args.arch]
    model = build_model(cfg)
    params = model.init(SEED)
    batch = random_batch(cfg.vocab_size, PARITY_BATCH, PARITY_SEQ)
    grads = {}
    for use_kernel in (True, False):
        grads[use_kernel] = dict(_named_leaves(value_and_grad(
            model, params, batch, remat=remat, use_kernel=use_kernel)[2]))
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    truth = dict(_named_leaves(value_and_grad(model32, params32, batch,
                                              remat=remat)[2]))
    rows = {name: {"kernel_vs_plain": rel_err(grads[True][name],
                                              grads[False][name]),
                   "kernel_vs_fp32": rel_err(grads[True][name], ref),
                   "plain_vs_fp32": rel_err(grads[False][name], ref)}
            for name, ref in truth.items()}
    worst = sorted(rows.items(), key=lambda kv: -kv[1]["kernel_vs_plain"])
    print(json.dumps({"arch": args.arch, "layers": cfg.n_layers,
                      "attn_every": cfg.hybrid.attn_every if cfg.hybrid
                      else None, "remat": remat,
                      "batch": [PARITY_BATCH, PARITY_SEQ],
                      "max": {k: max(r[k] for r in rows.values())
                              for k in ("kernel_vs_plain", "kernel_vs_fp32",
                                        "plain_vs_fp32")},
                      "worst_leaves": dict(worst[:6])}), flush=True)


if __name__ == "__main__":
    main()
