"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Batched prefill+decode with the ServeEngine, on the GPU unless
``--device cpu`` is given (there is no silent fall back to the CPU).  An
arch with a frontend (pixtral-12b's patches, whisper-small's frames) gets
random embeddings from the seed, as the reference's serve script makes them.
``--arch`` takes every arch of the reference; ``--layers`` cuts the depth
of one that does not fit the card at full depth (``qwen1.5-110b``,
``phi3.5-moe-42b-a6.6b``, ``deepseek-v3-671b``, whose first 3 layers are
its dense ones), width and every other field kept.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import PORTED_ARCH_IDS, get_config
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=PORTED_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="default: the arch's own type (float32 with "
                         "--reduced)")
    args = ap.parse_args(argv)

    arch = get_config(args.arch)
    if args.reduced:
        arch = dataclasses.replace(arch.reduced(), dtype="float32")
    if args.dtype is not None:
        arch = dataclasses.replace(arch, dtype=args.dtype)
    if args.layers is not None:
        arch = dataclasses.replace(arch, n_layers=args.layers)
    model = build_model(arch, device=args.device)
    params = model.init(0)
    engine = ServeEngine(model, params, max_len=args.max_len,
                         temperature=args.temperature)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            rng.integers(1, arch.vocab_size,
                                         size=args.prompt_len)],
                    max_new_tokens=args.max_new)
            for _ in range(args.batch)]
    frontend = None
    fs = model.frontend_shape(args.batch)
    if fs is not None:
        frontend = torch.from_numpy(
            rng.standard_normal(fs).astype(np.float32)).to(model.device)
    outs = engine.generate(reqs, frontend)
    for i, c in enumerate(outs):
        print(f"req{i}: prompt[:8]={c.prompt[:8]} -> tokens={c.tokens}")
    print(f"prefill {outs[0].prefill_time_s*1e3:.1f}ms, "
          f"decode {outs[0].decode_time_s*1e3:.1f}ms "
          f"({args.max_new} steps, batch {args.batch}, "
          f"device {model.device}, kernels "
          f"{'on' if engine.use_kernel else 'off'})")


if __name__ == "__main__":
    main()
