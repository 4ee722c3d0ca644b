"""End-to-end training driver (counterpart of ``examples/train_lm.py``):
train a reduced-family LM with the full stack on one device: cost-based
plan selection, the prefetching data pipeline, AdamW, async checkpointing,
resume, the straggler monitor.  On the GPU unless ``--device cpu`` is
given; the model is always the arch's ``reduced()`` form in fp32.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cluster import cpu_host_config, h100_single_config
from repro_torch.models.model import require_device
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    device = require_device(args.device)

    arch = dataclasses.replace(get_config(args.arch).reduced(),
                               dtype="float32")
    shape = ShapeConfig("cpu_train", seq_len=64, global_batch=16,
                        mode="train")
    cc = cpu_host_config() if device.type == "cpu" else h100_single_config()
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    tcfg = TrainerConfig(steps=args.steps, log_every=20,
                         checkpoint_every=100, ckpt_dir=ckpt)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    trainer = Trainer(arch, shape, cc, device, opt_cfg=opt, tcfg=tcfg)
    print(f"plan: {trainer.plan.describe()}  params="
          f"{arch.n_params/1e6:.1f}M  ckpt={ckpt}  device={device}")
    result = trainer.run(on_metrics=lambda m: print(json.dumps(m)))
    hist = result["history"]
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({args.steps} steps); straggler verdict: "
          f"{trainer.monitor.detect().action}")


if __name__ == "__main__":
    main()
