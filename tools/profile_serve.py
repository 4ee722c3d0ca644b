#!/usr/bin/env python3
"""Where the serve path's time goes on the GPU: profiles one prefill and a few
decode steps of a ported arch (full width, bf16, random weights) with
torch.profiler and prints device time by kernel, the device's busy share and
the host time per step.

    python3 tools/profile_serve.py [--arch qwen1.5-0.5b|mamba2-1.3b|...]
                                   [--layers N]
                                   [--batch 8] [--prompt 2048] [--steps 8]
                                   [--max-len 4096]

``--layers`` defaults to the depth ``chip_smoke.py``'s serve phase runs
(full depth, or its ``DEPTH_CUTS``).  Prefill and decode take the kernel
path, as ``ServeEngine`` does on the GPU.  For a moe arch every
``torch.einsum`` of ``repro_torch.models.layers`` runs in a profiler range
named by its equation, and each window also prints the device ms of the
kernels each product launched (``einsum_ranges``): the fp32 dispatch
(``gtd,gtec->gecd``) and combine (``gecd,gtec->gtd``) products beside the
expert products (``gecd,edf->gecf``, ``gecf,efd->gecd``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# first: it sets the allocator's configuration before torch is imported
from chip_smoke import path_config                           # noqa: E402
import torch                                                 # noqa: E402
from torch.profiler import (ProfilerActivity, profile,       # noqa: E402
                            record_function)
from repro_torch.configs import PORTED_ARCH_IDS             # noqa: E402
from repro_torch.models import layers as model_layers       # noqa: E402
from repro_torch.models.model import build_model            # noqa: E402


class _EinsumRanges:
    """Stands for ``torch`` in ``repro_torch.models.layers``: every
    ``torch.einsum`` runs inside a ``record_function`` range named
    ``einsum <equation>``; everything else is torch's own."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def einsum(self, equation, *operands):
        with record_function(f"einsum {equation}"):
            return self._real.einsum(equation, *operands)


@contextlib.contextmanager
def einsum_ranges(cfg):
    """For a moe arch, the ranges of :class:`_EinsumRanges` while the
    context lasts (a forward's products, and a checkpoint's rerun of them;
    autograd's backward products run outside them)."""
    if cfg.moe is None:
        yield
        return
    model_layers.torch = _EinsumRanges(torch)
    try:
        yield
    finally:
        model_layers.torch = torch


def window(name, fn, n_steps):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the einsum ranges appear on the device too (as annotations that span
    # their kernels): kept apart, so that no kernel is counted twice
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("einsum ")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ranges = {e.key: {"ms": e.device_time_total / 1e3, "calls": e.count}
              for e in prof.key_averages() if e.key.startswith("einsum ")
              and e.device_type == torch.autograd.DeviceType.CUDA}
    for r in ranges.values():
        r["share_of_busy"] = r["ms"] / busy if busy else None
    extra = {"einsum_ranges": ranges} if ranges else {}
    print(json.dumps({
        "window": name, "steps": n_steps, "wall_ms": wall * 1e3,
        "wall_ms_per_step": wall * 1e3 / n_steps, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                        for k, ms, n in rows[:12 if not extra else 24]],
        **extra}), flush=True)


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
    cfg = path_config(args.arch, "serve")
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
    with einsum_ranges(cfg):
        window("prefill", prefill, 1)
        decode()
        window("decode", decode, args.steps)


if __name__ == "__main__":
    main()
