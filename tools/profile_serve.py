#!/usr/bin/env python3
"""Where the serve path's time goes on the GPU: profiles one prefill and a few
decode steps of a ported arch (full width, bf16, random weights) with
torch.profiler and prints device time by kernel, the device's busy share and
the host time per step.

    python3 tools/profile_serve.py [--arch qwen1.5-0.5b|mamba2-1.3b|zamba2-2.7b]
                                   [--layers N]
                                   [--batch 8] [--prompt 2048] [--steps 8]
                                   [--max-len 4096]

``--layers`` defaults to the arch's full depth.  Prefill and decode take the
kernel path, as ``ServeEngine`` does on the GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.model import build_model            # noqa: E402


def window(name, fn, n_steps):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(json.dumps({
        "window": name, "steps": n_steps, "wall_ms": wall * 1e3,
        "wall_ms_per_step": wall * 1e3 / n_steps, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                        for k, ms, n in rows[:12]]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=PORTED_ARCH_IDS)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=4096)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (args.batch, args.prompt),
                         generator=gen, device="cuda")
    state = {}

    @torch.no_grad()
    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, toks, model.init_cache(args.batch, args.max_len),
            use_kernel=True)

    @torch.no_grad()
    def decode():
        for _ in range(args.steps):
            tok = torch.argmax(state["logits"], dim=-1)
            state["logits"], state["cache"] = model.decode_step(
                params, tok, state["cache"], use_kernel=True)
            tok.cpu()                    # the engine reads each token back

    prefill()                            # warm up: build and load the kernel
    window("prefill", prefill, 1)
    decode()
    window("decode", decode, args.steps)


if __name__ == "__main__":
    main()
