"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Cost-model-driven: the planner enumerates sharding plans for the device,
ranks them with C(P, cc), and the winner configures the train step (the
paper's optimizer in the driver's seat).  ``--explain`` prints the costed
plan of the winner and exits.

One device: the GPU unless ``--device cpu`` is given (there is no silent
fall back to the CPU).  ``--mesh host`` costs the plans for that device
(``h100_single_config()`` on the GPU, ``cpu_host_config()`` on the CPU);
``--mesh single`` and ``--mesh multi`` need the multi-device launch, which
is ROADMAP item 14, and raise.  ``--layers`` cuts the depth of an arch that
does not fit the card at full depth, width and every other field kept.

On the GPU, ``main`` sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
(when it is unset) before torch first touches CUDA: without it the larger
archs' AdamW temporaries run out of memory in the reserved but unallocated
memory of the caching allocator.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --global-batch 8 --seq-len 2048
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --device cpu --reduced --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import PORTED_ARCH_IDS, SHAPES, get_config
from repro_torch.core.cluster import cpu_host_config, h100_single_config
from repro_torch.core.costmodel import estimate
from repro_torch.core.explain import explain
from repro_torch.core.planner import build_step_program, choose_plan
from repro_torch.models.model import require_device
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=PORTED_ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--explain", action="store_true",
                    help="print the costed analytical plan and exit")
    args = ap.parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: meshes of more than one device need the "
            "multi-device launch, ROADMAP item 14; use --mesh host")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

    arch = get_config(args.arch)
    if args.reduced:
        arch = arch.reduced()
        arch = dataclasses.replace(arch, dtype="float32")
    if args.layers is not None:
        arch = dataclasses.replace(arch, n_layers=args.layers)
    shape = SHAPES[args.shape]
    if args.global_batch or args.seq_len:
        shape = dataclasses.replace(
            shape, global_batch=args.global_batch or shape.global_batch,
            seq_len=args.seq_len or shape.seq_len)
    on_cpu = args.device.split(":")[0] == "cpu"
    cc = cpu_host_config() if on_cpu else h100_single_config()

    decisions = choose_plan(arch, shape, cc, top_k=3)
    print(f"== cost-based plan ranking ({cc.chip.name}) ==")
    for d in decisions:
        print(f"  {d.plan.describe():60s} T={d.time*1e3:9.2f}ms "
              f"hbm={d.hbm_est/1e9:6.2f}GB feasible={d.feasible}")
    best = decisions[0]
    if args.explain:
        prog = build_step_program(arch, shape, best.plan, cc)
        print(explain(estimate(prog, cc), max_depth=3))
        return

    device = require_device(args.device)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         compress_scheme=args.compress,
                         log_every=max(args.steps // 10, 1))
    opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    trainer = Trainer(arch, shape, cc, device, plan=best.plan, opt_cfg=opt,
                      tcfg=tcfg)
    result = trainer.run(on_metrics=lambda m: print(json.dumps(m)))
    hist = result["history"]
    if hist:
        print(f"\nloss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {len(hist)} logged steps (device {device}, kernels "
              f"{'on' if trainer.use_kernel else 'off'})")


if __name__ == "__main__":
    main()
