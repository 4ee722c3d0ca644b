"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Cost-model-driven: the planner enumerates sharding plans for the device,
ranks them with C(P, cc), and the winner configures the train step (the
paper's optimizer in the driver's seat).  ``--explain`` prints the costed
plan of the winner and exits.

``--mesh host`` (the default) runs on one device: the GPU unless
``--device cpu`` is given (there is no silent fall back to the CPU), the
plans costed for that device (``h100_single_config()`` on the GPU,
``cpu_host_config()`` on the CPU).  ``--mesh single`` (one H100 node, mesh
``(1, 8)``) and ``--mesh multi`` (two nodes, ``(2, 1, 8)``) run under
``torchrun``, one process per GPU: the driver initialises ``nccl`` from
the environment torchrun sets, builds the production mesh, costs the plans
for ``h100_node_config()`` / ``h100_multi_node_config()`` and runs the
sharded ``Trainer``; it raises when the world size differs from the
mesh's, and a production mesh never runs on the CPU.  Rank 0 prints.
``--layers`` cuts the depth of an arch that does not fit the card at full
depth, width and every other field kept.

On the GPU, ``main`` sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
(when it is unset) before torch first touches CUDA: without it the larger
archs' AdamW temporaries run out of memory in the reserved but unallocated
memory of the caching allocator.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --global-batch 8 --seq-len 2048
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --device cpu --reduced --steps 3
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch qwen1.5-4b --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

from repro_torch.configs import PORTED_ARCH_IDS, SHAPES, get_config
from repro_torch.core.cluster import (cpu_host_config, h100_multi_node_config,
                                      h100_node_config, h100_single_config)
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
    on_cpu = args.device.split(":")[0] == "cpu"
    if args.mesh != "host" and not args.explain:
        _check_launch(args.mesh, on_cpu)
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
    if args.mesh == "host":
        cc = cpu_host_config() if on_cpu else h100_single_config()
    else:
        cc = h100_multi_node_config() if args.mesh == "multi" \
            else h100_node_config()
    rank = int(os.environ.get("RANK", "0"))
    say = print if rank == 0 else (lambda *a, **k: None)

    decisions = choose_plan(arch, shape, cc, top_k=3)
    where = "" if args.mesh == "host" else \
        f", mesh {dict(zip(cc.mesh_axes, cc.mesh_shape))}"
    say(f"== cost-based plan ranking ({cc.chip.name}{where}) ==")
    for d in decisions:
        say(f"  {d.plan.describe():60s} T={d.time*1e3:9.2f}ms "
            f"hbm={d.hbm_est/1e9:6.2f}GB feasible={d.feasible}")
    best = decisions[0]
    if args.explain:
        prog = build_step_program(arch, shape, best.plan, cc)
        say(explain(estimate(prog, cc), max_depth=3))
        return

    if args.mesh == "host":
        where = device = require_device(args.device)
    else:
        where = _production_mesh(args.mesh == "multi")
        device = f"mesh {args.mesh}, {where.size()} GPUs"
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         compress_scheme=args.compress,
                         log_every=max(args.steps // 10, 1))
    opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    trainer = Trainer(arch, shape, cc, where, plan=best.plan, opt_cfg=opt,
                      tcfg=tcfg)
    result = trainer.run(on_metrics=lambda m: say(json.dumps(m)))
    hist = result["history"]
    if hist:
        say(f"\nloss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
            f"over {len(hist)} logged steps (device {device}, kernels "
            f"{'on' if trainer.use_kernel else 'off'})")
    if args.mesh != "host":
        import torch.distributed as dist
        dist.destroy_process_group()


def _check_launch(mesh: str, on_cpu: bool) -> None:
    """Raise unless this process is one of torchrun's, in a world the size
    of the production mesh, on a GPU."""
    from repro_torch.launch.mesh import production_layout

    if on_cpu:
        raise ValueError(f"--mesh {mesh} runs one process per GPU under "
                         "torchrun; --device cpu runs --mesh host")
    shape, axes = production_layout(mesh == "multi")
    need = math.prod(shape)
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"--mesh {mesh} runs under torchrun, one process per GPU "
            f"({need} of them): torchrun --nproc-per-node ... -m "
            "repro_torch.launch.train ... (WORLD_SIZE is unset)")
    world = int(os.environ["WORLD_SIZE"])
    if world != need:
        raise ValueError(f"--mesh {mesh} is {dict(zip(axes, shape))}, "
                         f"{need} GPUs; torchrun started {world} processes")


def _production_mesh(multi_node: bool):
    """nccl from torchrun's environment, then the production mesh, each
    process on its local GPU."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    require_device("cuda")
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl")
    return make_production_mesh(multi_node)


if __name__ == "__main__":
    main()
