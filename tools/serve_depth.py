#!/usr/bin/env python3
"""Whether a serve path fits one GPU at a given cut: ``chip_smoke.py``'s
serve phase for the arch at full width and ``--layers`` layers (a moe
arch's routed experts cut to ``--experts``, the round's requests to
``--batch``; bf16, random weights from the seed, the phase's requests,
static twice and continuous, the prefill logits with and without the
kernels, the controls, then the fp32 streams at the phase's fp32 depth),
with no bound on the bf16 prefill logits.  Prints the phase's lines (for a
moe arch its ``moe`` line too) and one JSON line: the card's name and power
limit, the cut, the peak memory, and ``"out_of_memory"`` (exit 0 either
way).

    python3 tools/serve_depth.py --arch deepseek-v3-671b --layers 5
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# first: it sets the allocator's configuration before torch is imported
import chip_smoke                                            # noqa: E402
import torch                                                 # noqa: E402

FP32_LAYERS = {arch: n for arch, _, n in chip_smoke.SERVE_PATHS}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=chip_smoke.DEEPSEEK,
                    choices=sorted(FP32_LAYERS))
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--experts", type=int, default=None,
                    help="routed experts of a moe arch (default: all)")
    ap.add_argument("--batch", type=int, default=None,
                    help="requests of a round (default: the phase's)")
    args = ap.parse_args()
    smi = chip_smoke.device_line()
    cut = {"n_layers": args.layers, "reason": "probe"}
    for key, value in (("n_experts", args.experts), ("batch", args.batch)):
        if value is not None:
            cut[key] = value
    chip_smoke.DEPTH_CUTS[(args.arch, "serve")] = cut
    out = {"device": smi, "arch": args.arch, "cut": cut}
    torch.cuda.reset_peak_memory_stats()
    try:
        line = chip_smoke.phase_serve(args.arch, float("inf"),
                                      FP32_LAYERS[args.arch])
        chip_smoke.emit(line)
        out.update(out_of_memory=False,
                   bf16_prefill_logits_max_abs_diff=line[
                       "bf16_prefill_logits_max_abs_diff"],
                   phase_max_memory_allocated_bytes=line[
                       "max_memory_allocated_bytes"])
    except torch.OutOfMemoryError as err:
        out.update(out_of_memory=True, error=str(err).splitlines()[0])
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
