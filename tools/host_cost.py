"""Host time of a ``matmul_epilogue`` call at the 8-row shapes of the serve
paths, beside its library call (GPU only).

A decode step is bound by the host, so what a call costs there matters as
much as its device time.  For each of the five 8-row products (the decode
gates of zamba2-2.7b and qwen1.5-0.5b, the heads of zamba2-2.7b,
mamba2-1.3b and qwen1.5-0.5b), bf16 with w cold (rotated over copies that
pass the 50 MB L2), this prints:

* ``host_us``: microseconds the host spends a call, the median of five
  rounds of 200 calls enqueued without a synchronisation (fewer than the
  launch queue holds, so the host never waits for the device);
* ``event_ms``: milliseconds a call between CUDA events over 20
  back-to-back calls, host included (as ``chip_smoke.py``'s ``event_ms``);

for the kernel and for the library call (``F.silu(x @ w)`` for a gate,
``(x @ w).float()`` for a head).  ``--src`` names the ``src`` directory whose
``repro_torch`` is timed (default this checkout's), so that two trees can
be compared in one run on one card:

    python3 tools/host_cost.py [--src PATH] [--label NAME]

Prints the card's name and power limit, then one JSON line per shape.  It
reads nothing of ``chip_smoke.py``, so an older tree's package can be timed
as it is.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
COLD_BYTES = 120e6
# name, m, n, k, epilogue, out dtype
SHAPES = (("zamba2 decode gate", 8, 10240, 2560, "silu", torch.bfloat16),
          ("qwen decode gate", 8, 2816, 1024, "silu", torch.bfloat16),
          ("zamba2 head", 8, 32000, 2560, None, torch.float32),
          ("mamba2 head", 8, 50280, 2048, None, torch.float32),
          ("qwen head", 8, 151936, 1024, None, torch.float32))


def host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def event_ms(fn, calls: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("host_cost: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.matmul_epilogue import matmul_epilogue

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, m, n, k, epilogue, out_dtype in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / k ** 0.5).bfloat16()
        copies = max(2, int(-(-COLD_BYTES // (w.numel() * 2))))
        ring = itertools.cycle([w] + [w.clone() for _ in range(copies - 1)])

        def kernel():
            return matmul_epilogue(x, next(ring), epilogue=epilogue,
                                   out_dtype=out_dtype)

        def library():
            y = x @ next(ring)
            return F.silu(y) if epilogue == "silu" else y.float()

        print(json.dumps({
            "tree": args.label, "shape": name, "w_copies": copies,
            "host_us": host_us(kernel), "library_host_us": host_us(library),
            "event_ms": event_ms(kernel),
            "library_event_ms": event_ms(library)}), flush=True)
        del x, w, ring


if __name__ == "__main__":
    main()
