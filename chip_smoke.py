#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is assumed
for the roofline bounds).

    python3 chip_smoke.py

Phases, each printing one JSON line: ``device`` (name and power limit),
``build`` (compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc),
``kernels`` (every hand-written kernel, the two backward kernels included,
against its plain PyTorch version on the card, faulty controls of the
epilogue kernel and of tsmm that the same check must catch, and the SSD
scan's rounding plans, forward and backward, against one bf16 rounding of
their state paths; every backward call again, bit for bit), with
``--ptxas`` a ``ptxas`` line (registers, shared memory and spills of every
kernel), ``train`` eleven times (qwen1.5-0.5b, mamba2-1.3b, zamba2-2.7b,
qwen1.5-4b and whisper-small at full width and depth, stablelm-12b,
qwen1.5-110b, pixtral-12b, gemma3-12b, phi3.5-moe-42b-a6.6b and
deepseek-v3-671b at the cut ``DEPTH_CUTS`` states (layers; deepseek's dense
layers, routed experts and batch too), in bf16 through
``make_train_step(use_kernel=True, donate=True)``, pixtral with its
1024 patch embeddings and whisper with its 1500 frame embeddings: one
step's gradients twice, which must be bit-identical, in bf16 at the path's
width and depth and in fp32 at the parity cut, then five steps on a
repeated batch, losses, step times, peak memory and every kernel's
launches against the count the path must give, then the gradients of the
kernel path against the plain path at two layers, or for zamba2 at one
application of each shared block, for gemma3-12b at one local and one
global layer over 2048 positions, for a moe arch one dense layer and one
moe layer), ``checkpoint`` (qwen1.5-0.5b at 2 layers: batches of the port's
``make_pipeline`` onto the card, two train steps, an
``AsyncCheckpointer.save`` of the weights and the AdamW state while step 3
runs, ``restore`` into a fresh tree, every leaf equal, step 3 again from
it bit-identical), ``serve`` eleven times (the same archs,
gemma3-12b at full depth, qwen1.5-110b, phi3.5-moe and deepseek-v3 at their
``DEPTH_CUTS`` cut, in
bf16 through ``ServeEngine``, static and continuous batching, with a
frontend the continuous run's second admission raising as the
reference's does, with the launch count of every kernel, of each body of
the epilogue kernel and of flash by mask and by window, held against the
count the arch's path must give (deepseek-v3's MLA takes no flash
launch: its Dk differs from its Dv), and the bf16 prefill logits with the
kernels against without them and against the controls; for each moe arch a
``moe`` line before each of its serve and train lines: the share of (token,
slot) expert choices and of drop decisions that differ between the kernel
path and the plain path on the same input, at the prefill and at the
gradient parity's cut, and the share of slots dropped, in the prefill
rounds, in the decode steps (8 tokens a group) and in a train step),
``linreg`` (the
LinReg DS example at 262144 x 1024 through the tsmm kernel, cold, then warm
and split into its parts), ``estimate`` (the paper's §3.4 check on the card:
the port's cost model, with the H100's datasheet constants, estimates four
LinReg DS plans, which then run warm, each serve path's prefill round
and decode step, held against what the serve phase measured, and each train
path's step, held against what the train phase measured; each also under
the calibrated profile of the next phase), ``calibrate`` (the reference's
calibration harvest on the card: matmul, stream, LinReg and full-width
arch cells costed through ``graph_cost``, a fitted H100 profile, each
cell's drift and the gate's PASS or FAIL; the fusion rows with the fusing
kernels' times; each train path's step costed component by component),
``trainer`` (the runtime through its entry points: qwen1.5-0.5b at full
size through ``Trainer.run`` on ``choose_plan``'s plan for one H100, ten
steps with the online recalibrator on, each step's time against the train
phase's, a run stopped after a checkpoint and resumed from it bit-identical
to the straight run, the recalibrator's events, and ``launch/train.py``
run in this process), ``mesh`` (the same ``Trainer`` built on a one-rank
CUDA mesh of nccl, ``Trainer(arch, shape, cc, mesh)``: every parameter a
``DTensor``, the kernels reached through ``local_map``, five steps whose
losses must equal the trainer phase's bit for bit, each timed by CUDA
events, a checkpoint at step 2 restored onto the shardings leaf for leaf,
and one dry-run cell, qwen1.5-0.5b ``train_4k`` on one H100 node's fake
8-rank mesh, traced in a subprocess during the entrypoints phase's
cost-model work; one card checks placements
and one-rank execution, nothing multi-GPU), ``entrypoints`` (the
cost-model entry points as a user runs them: the LinReg DS example at
262144 x 1024 through ``tsmm``, one launch a solve, with the Table-1 plans
and its estimate on one H100 beside the warm solve; the four cost-model
examples with ``--h100``, each winner feasible; the paper-table modules
that no earlier phase runs at ``--quick``, with no EXCEPTION, MISMATCH or
nonzero ``max_abs_err`` and their wall-clock claims reported; and
``render_tables`` over the mesh phase's dry-run cell).
Then one ``{"kernels": [...]}`` line with each kernel's time at its main-path
shape beside its roofline bound, the plain version's time and a PyTorch
library call's time (null where no single call computes the function), the
device line again, and last ``{"ok": true, "device": {...}}``.

Any failing phase raises: the script exits non-zero and prints no result.  It
needs a CUDA device and raises at once without one.  It imports the port
(``repro_torch``) and nothing of the JAX reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

# zamba2's train step runs within a few GB of the card's 80: AdamW's fp32
# temporaries of the stacked Mamba2 w_in (5.4 GiB each) found no room in the
# 15.5 GB the caching allocator held reserved but unallocated.  Expandable
# segments let it reuse that memory.  Set before torch touches the card.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.benchmarks import (bench_accuracy,  # noqa: E402
                                    bench_calibrate, bench_fusion)
from repro_torch.checkpoint import store                         # noqa: E402
from repro_torch.configs import get_config                       # noqa: E402
from repro_torch.configs.base import ShapeConfig                 # noqa: E402
from repro_torch.examples import linreg_ds                       # noqa: E402
from repro_torch.kernels import _build, ops                      # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod     # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BACKWARD_HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain,
    flash_body, flash_bwd_body, flash_lse_plain)
from repro_torch.kernels.matmul_epilogue import (  # noqa: E402
    LN_MAX_N, matmul_body, matmul_epilogue, matmul_epilogue_plain)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_bwd_body, ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain,
    ssd_scan_bwd_split_plain, ssd_scan_plain, ssd_scan_split_plain)
from repro_torch.kernels.tsmm import tsmm_upper, tsmm_upper_plain  # noqa: E402
from repro_torch.core import (ShardingPlan, choose_plan,  # noqa: E402
                              h100_single_config)
from repro_torch.data.pipeline import SyntheticLM, make_pipeline  # noqa: E402
from repro_torch.launch import train as train_driver            # noqa: E402
from repro_torch.launch.component_cost import (  # noqa: E402
    aggregate, component_costs)
from repro_torch.models import layers as model_layers           # noqa: E402
from repro_torch.models.layers import _band_mask                 # noqa: E402
from repro_torch.models.model import build_model                 # noqa: E402
from repro_torch.optim import adamw                              # noqa: E402
from repro_torch.runtime.serve_engine import (EngineConfig, Request,  # noqa: E402
                                              ServeEngine)
from repro_torch.runtime.train_loop import (Trainer,  # noqa: E402
                                            TrainerConfig, make_train_step,
                                            value_and_grad)

# Published dense peaks of one H100 SXM at its full power limit (NVIDIA's
# data sheet): bf16 and TF32 on the tensor cores, fp32 on the FMA units.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

SEED = 0
FLASH_MAIN = dict(b=8, hq=16, hkv=16, s=2048, d=64, causal=True, window=None)
# zamba2-2.7b's shared attention blocks: 32 heads of 80
FLASH_D80 = dict(b=8, hq=32, hkv=32, s=2048, d=80, causal=True, window=None)
LINREG_M, LINREG_N, LINREG_LAM = 262144, 1024, 1e-3

# (b, hq, hkv, s, d, causal, window): the reference's kernel test cases,
# then the head dims and GQA ratios of the dense archs (qwen1.5-4b: D = 128
# MHA; qwen1.5-110b: D = 128, GQA 8; stablelm-12b: D = 160, GQA 4;
# gemma3-12b: D = 256, GQA 2), causal and windowed, ragged S among them
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, None),
    (1, 4, 4, 256, 32, False, None),
    (2, 8, 2, 512, 64, True, 128),
    (1, 2, 1, 512, 128, True, None),
    (1, 4, 1, 256, 64, False, 64),
    (2, 4, 4, 384, 128, True, None),
    (1, 8, 1, 300, 128, True, 100),
    (1, 8, 2, 333, 160, True, None),
    (2, 8, 2, 256, 160, False, 64),
    (1, 4, 1, 200, 160, True, 32),
    (2, 4, 2, 256, 256, True, None),
    (1, 4, 2, 300, 256, False, 64),
]
# The dense archs of this port at the train phase's B 8 x S 2048, bf16
WIDE_ARCHS = ("qwen1.5-4b", "qwen1.5-110b", "stablelm-12b")
# The archs with a frontend: pixtral-12b prepends 1024 patch embeddings to
# its 2048 tokens; whisper-small's encoder reads 1500 frame embeddings, and
# its decoder is served and trained at its published context of 448 tokens
# (arXiv:2212.04356)
FRONTEND_ARCHS = ("pixtral-12b", "whisper-small")
WHISPER_CTX = 448
# The moe archs: phi3.5-moe's GQA blocks whose MLP is 16 routed experts
# (top-2, GShard capacity routing, plain batched products; its kernels are
# flash and the epilogue's head), and deepseek-v3's MLA blocks, 3 dense
# layers first, then 256 routed experts (top-8) beside a shared expert, and
# an MTP head (its kernel is the epilogue's, on the dense and shared-expert
# gates and the heads: MLA's Dk != Dv keeps its attention off flash)
PHI, DEEPSEEK = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"
MOE_ARCHS = (PHI, DEEPSEEK)
TSMM_CASES = [(512, 256), (1024, 512), (768, 384), (2048, 128)]
# (b, s, h, p, n, chunk): the reference's kernel test cases
SSD_CASES = [(2, 128, 4, 16, 32, 32), (1, 256, 2, 64, 128, 64),
             (2, 64, 8, 32, 16, 16)]
SSD_MAIN = dict(b=8, s=2048, h=64, p=64, g=1, n=128, chunk=256)
# zamba2-2.7b's Mamba2 layers: 80 heads of 64, state 64
SSD_ZAMBA = dict(b=8, s=2048, h=80, p=64, g=1, n=64, chunk=256)
# (m, n, k): the reference's kernel test shapes
MM_CASES = [(512, 256, 256), (256, 512, 384)]
# zamba2-2.7b's path: the MLP gate silu(x @ w_gate) of a prefill round of
# 8 x 2048 tokens, bf16 out; the head at one token a request, fp32 logits
MM_GATE = dict(m=8 * 2048, n=10240, k=2560, epilogue="silu",
               dtype=torch.bfloat16, out_dtype=torch.bfloat16)
MM_HEAD = dict(m=8, n=32000, k=2560, epilogue=None, dtype=torch.bfloat16,
               out_dtype=torch.float32)
# qwen1.5-0.5b's path: the gate of a prefill round and the head of the widest
# vocabulary of the three archs (151936), fp32 logits
MM_QWEN_GATE = dict(m=8 * 2048, n=2816, k=1024, epilogue="silu",
                    dtype=torch.bfloat16, out_dtype=torch.bfloat16)
MM_QWEN_HEAD = dict(m=8, n=151936, k=1024, epilogue=None,
                    dtype=torch.bfloat16, out_dtype=torch.float32)
MM_MAMBA_HEAD = dict(m=8, n=50280, k=2048, epilogue=None,
                     dtype=torch.bfloat16, out_dtype=torch.float32)
# the MLP gates of a decode step, 8 requests a step: most of the epilogue
# kernel's launches on the serve paths
MM_DECODE_GATE = dict(m=8, n=10240, k=2560, epilogue="silu",
                      dtype=torch.bfloat16, out_dtype=torch.bfloat16)
MM_QWEN_DECODE_GATE = dict(m=8, n=2816, k=1024, epilogue="silu",
                           dtype=torch.bfloat16, out_dtype=torch.bfloat16)

# Tolerances.  fp32: the kernels multiply in full fp32 and differ from the
# plain version only in the order of the sums (the reference's own kernel
# tests use the same numbers).  bf16: inputs and P carry 8 bits of mantissa.
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


# The backward kernels against their plain versions, per output, as a
# relative tolerance: atol is rtol x the output's largest magnitude (a
# gradient is a long sum whose terms cancel, so an element near zero carries
# the absolute error of the sum, not of itself).  fp32 outputs: both sides
# multiply in full fp32 and differ in the order of sums of up to 2048 (flash)
# or 256 x 128 (SSD) terms, and flash's dQ in the order of its atomic adds:
# 1e-4.  bf16 outputs: both round one fp32 value, which may fall either side
# of a rounding boundary: one bf16 step, 2^-7 relative, and a little: 1e-2.
# The log-sum-exp that the forward writes: fp32 on both sides, atol 1e-4 on
# values of order log(S) + max score.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


def compare_rel(out: torch.Tensor, ref: torch.Tensor, rtol: float) -> dict:
    """:func:`compare` with atol = rtol x max|ref|."""
    return compare(out, ref, rtol, rtol * float(ref.abs().max()))


def tsmm_tol(dtype: torch.dtype, m: int) -> dict:
    """The reference's tolerances (m <= 2048); the absolute rounding error of
    an fp32 sum grows with its length, so atol scales with m beyond 512."""
    grow = max(1.0, m / 512)
    if dtype == torch.float32:
        return dict(rtol=2e-5, atol=2e-4 * grow)
    return dict(rtol=3e-2, atol=0.9 * grow)


def mm_tol(out_dtype: torch.dtype, k: int) -> dict:
    """fp32 out: the reference's rtol 2e-5 / atol 2e-4 (K <= 384); kernel and
    plain version differ in the order of the fp32 sums, whose absolute error
    grows with K, so atol scales with K beyond 256.  bf16 out: both round an
    fp32 value once, and two values a sum-order apart may round to
    neighbouring bf16 numbers, 2^-8 to 2^-7 apart relative: rtol 1e-2."""
    atol = 2e-4 * max(1.0, k / 256)
    if out_dtype == torch.float32:
        return dict(rtol=2e-5, atol=atol)
    return dict(rtol=1e-2, atol=1e-2 + atol)


# The bf16 body's state against ``ssd_scan_split_plain`` at the served
# shapes: the largest error over the state's largest element.  Both make
# the same products with the same roundings and differ in the order of fp32
# sums and in the exponentials.  On an H100 the kernel read 2.3e-5
# (mamba2's shape) and 3.1e-5 (zamba2's), the state's operand rounded once
# to bf16 8.5e-4 and 1.7e-3; the limit is the geometric mean of the largest
# of the first and the smallest of the second, 1.6e-4, rounded down to one
# digit.
SSD_SPLIT_STATE_LIMIT = 1e-4


def ssd_tol(dtype: torch.dtype, log_a: torch.Tensor, chunk: int,
            y_ref: torch.Tensor, st_ref: torch.Tensor) -> dict:
    """fp32: the reference's rtol = atol = 2e-4.  Each decay
    exp(cum_i - cum_j) carries an absolute error near eps * |cum| from the
    fp32 cumsum, whatever the order of its sums; where 4 * eps * max|cum|
    over a chunk exceeds 2e-4 (the serve path's decays reach |cum| ~ 2000)
    it takes rtol's place, and atol becomes rtol * max|ref|, for the
    elements whose terms cancel to near zero.  bf16: y is rounded to 8 bits
    of mantissa on both sides, and the two fp32 values it is rounded from may
    fall either side of a rounding boundary: one bf16 step is 2^-7 relative;
    the state stays fp32."""
    b, s, h = log_a.shape
    pad = (-s) % chunk
    la = F.pad(log_a.abs(), (0, 0, 0, pad)).reshape(b, -1, chunk, h)
    rel = 4 * 2.0 ** -23 * float(la.sum(dim=2).max())

    def tol(ref):
        if rel <= 2e-4:
            return dict(rtol=2e-4, atol=2e-4)
        return dict(rtol=rel, atol=rel * float(ref.abs().max()))
    out = {"y": tol(y_ref), "state": tol(st_ref)}
    if dtype == torch.bfloat16:
        out["y"] = dict(rtol=max(1e-2, out["y"]["rtol"]),
                        atol=max(1e-2, out["y"]["atol"]))
    return out


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(out: torch.Tensor, ref: torch.Tensor, rtol: float,
            atol: float) -> dict:
    """Max abs / rel error of ``out`` against ``ref``; raises beyond
    ``atol + rtol * |ref|``."""
    o, r = out.to(torch.float64), ref.to(torch.float64)
    if o.shape != r.shape or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"shape {tuple(o.shape)} vs {tuple(r.shape)} or "
                             f"non-finite values")
    err = (o - r).abs()
    excess = float((err - (atol + rtol * r.abs())).max())
    res = {"max_abs_err": float(err.max()),
           "max_rel_err": float((err / r.abs().clamp_min(1e-6)).max()),
           "ref_max_abs": float(r.abs().max()),
           "rtol": rtol, "atol": atol}
    if excess > 0:
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    return res


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def arch_flash(arch: str, s: int = 2048, causal: bool = True) -> dict:
    """``arch``'s attention at B 8 x ``s`` positions: heads, kv heads, head
    dim."""
    cfg = get_config(arch)
    return dict(b=8, hq=cfg.n_heads, hkv=cfg.n_kv_heads, s=s,
                d=cfg.head_dim_, causal=causal, window=None)


def path_flash() -> list:
    """(tag, shape) of every wide main-path flash shape: the dense archs'
    and phi3.5-moe's (32 heads x 128 over 8) at 2048; gemma3-12b's global
    layers (causal) and local layers (causal, window 1024) at 2048;
    pixtral's layers over 1024 patches + 2048 tokens, causal; whisper's encoder over its 1500 frames, not causal (ragged
    against every tile); whisper's decoder over its 448-token context,
    causal."""
    pix, whi = get_config("pixtral-12b"), get_config("whisper-small")
    gemma = arch_flash("gemma3-12b")
    return [*((a, arch_flash(a)) for a in WIDE_ARCHS),
            (PHI, arch_flash(PHI)),
            ("gemma3-12b global", gemma),
            ("gemma3-12b local",
             {**gemma, "window": get_config("gemma3-12b").local_window}),
            ("pixtral-12b", arch_flash("pixtral-12b",
                                       2048 + pix.frontend_seq)),
            ("whisper-small encoder", arch_flash(
                "whisper-small", whi.enc_dec.encoder_seq, causal=False)),
            ("whisper-small decoder", arch_flash("whisper-small",
                                                 WHISPER_CTX))]


def arch_gate(arch: str, m: int = 8 * 2048) -> dict:
    """``arch``'s MLP gate silu(x @ w) over ``m`` rows (a prefill round of
    8 x 2048 tokens by default), bf16 out."""
    cfg = get_config(arch)
    return dict(m=m, n=cfg.d_ff, k=cfg.d_model, epilogue="silu",
                dtype=torch.bfloat16, out_dtype=torch.bfloat16)


def arch_head(arch: str) -> dict:
    """``arch``'s head at one token of each of 8 requests, fp32 logits."""
    cfg = get_config(arch)
    return dict(m=8, n=cfg.vocab_size, k=cfg.d_model, epilogue=None,
                dtype=torch.bfloat16, out_dtype=torch.float32)


def path_mm() -> list:
    """(tag, shape) of the wide archs' epilogue products: each dense arch's
    prefill gate and head, phi3.5-moe's head (its experts take no kernel),
    deepseek-v3's dense-layer gate (``d_ff_dense``) and shared-expert gate,
    each at a prefill round and a decode step, and its head,
    gemma3-12b's prefill gate, decode gate and head
    (vocab 262144), pixtral's prefill gate over 8 x (1024 + 2048) rows,
    decode gate and head, and whisper's head (its MLP is not gated: no
    epilogue)."""
    pix = get_config("pixtral-12b")
    return [*((f"{a} {kind}", fn(a)) for a in WIDE_ARCHS
              for kind, fn in (("gate", arch_gate), ("head", arch_head))),
            (f"{PHI} head", arch_head(PHI)),
            *((f"{DEEPSEEK} {kind}", {**arch_gate(DEEPSEEK, m), "n": n})
              for kind, m, n in deepseek_gates()),
            (f"{DEEPSEEK} head", arch_head(DEEPSEEK)),
            ("gemma3-12b gate", arch_gate("gemma3-12b")),
            ("gemma3-12b decode gate", arch_gate("gemma3-12b", 8)),
            ("gemma3-12b head", arch_head("gemma3-12b")),
            ("pixtral-12b gate",
             arch_gate("pixtral-12b", 8 * (2048 + pix.frontend_seq))),
            ("pixtral-12b decode gate", arch_gate("pixtral-12b", 8)),
            ("pixtral-12b head", arch_head("pixtral-12b")),
            ("whisper-small head", arch_head("whisper-small"))]


def deepseek_gates() -> list:
    """(tag, rows, width) of deepseek-v3's gates on the epilogue kernel:
    its dense layers' (``d_ff_dense``) and its shared expert's, at a
    prefill round of 8 x 2048 tokens and at a decode step of 8."""
    moe = get_config(DEEPSEEK).moe
    shared = moe.n_shared_experts * moe.d_ff_expert
    return [("gate", 8 * 2048, moe.d_ff_dense),
            ("shared gate", 8 * 2048, shared),
            ("decode gate", 8, moe.d_ff_dense),
            ("decode shared gate", 8, shared)]


def sdpa_call(q, k, v, causal: bool, window, gqa: bool):
    """(fn, note): one ``F.scaled_dot_product_attention`` call that computes
    the kernel's function on q, k, v, a yardstick the port never calls:
    ``is_causal`` without a window; with one, an explicit band mask [Sq,
    Skv] bool, with which PyTorch may pick another backend
    (``library_kernels_ms`` names the kernels it ran)."""
    kw = {"enable_gqa": True} if gqa else {}
    note = "F.scaled_dot_product_attention" + (", enable_gqa" if gqa else "")
    if window is None:
        return (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, **kw)), note
    mask = _band_mask(torch.arange(q.shape[2], device=q.device),
                      torch.arange(k.shape[2], device=q.device), causal,
                      window)
    return (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   **kw),
            note + f", attn_mask: the band of window {window} as a bool "
                   f"[{q.shape[2]},{k.shape[2]}] mask")


def by_batch(fn, *args, **kw):
    """``fn`` on each batch row of ``args`` alone, the outputs (a tensor or
    a tuple) concatenated: a plain version at a main-path shape whose fp32
    scores for the whole batch would not fit beside the rest."""
    outs = [fn(*(a[i:i + 1] for a in args), **kw)
            for i in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def flash_inputs(b, hq, hkv, s, d, dtype, gen, views=False):
    """Seeded q, k, v [B,H,S,D]; with ``views`` they are ``transpose(1, 2)``
    views of [B,S,H,D] tensors, as the model hands them to the kernel."""
    def one(h):
        shape = (b, s, h, d) if views else (b, h, s, d)
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        return t.transpose(1, 2) if views else t
    return one(hq), one(hkv), one(hkv)


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """Number of (query, key) pairs inside the band."""
    q = torch.arange(sq, dtype=torch.int64)
    hi = torch.minimum(q, torch.tensor(skv - 1)) if causal \
        else torch.full_like(q, skv - 1)
    lo = (q - window + 1).clamp_min(0) if window else torch.zeros_like(q)
    return int((hi - lo + 1).clamp_min(0).sum())


def flash_bound_ms(b, hq, hkv, s, d, causal, window, dtype) -> dict:
    esize = torch.empty((), dtype=dtype).element_size()
    flops = 4.0 * d * visible_pairs(s, s, causal, window) * b * hq
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * esize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flops, "bytes": nbytes}


def tsmm_bound_ms(m, n, dtype) -> dict:
    """The kernel's bound: fp32 runs three tf32 products of each pair of
    values on the tensor cores (3xTF32), bf16 one bf16 product.
    ``fma_bound_ms`` is fp32's bound on the FMA units, which only the
    tensor cores can pass."""
    esize = torch.empty((), dtype=dtype).element_size()
    flops = float(m) * n * (n + 1)          # 2 flop x n(n+1)/2 pairs x m
    nbytes = (m * n + n * n) * esize
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3 * flops / PEAK_TF32 if dtype == torch.float32 \
        else flops / PEAK_FLOPS[dtype]
    out = {"bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flop": flops, "bytes": nbytes}
    if dtype == torch.float32:
        out["fma_bound_ms"] = 1e3 * max(flops / PEAK_FLOPS[dtype], t_bytes)
    return out


def check_flash(gen) -> list:
    cases = []

    def run(tag, b, hq, hkv, s, d, causal, window, dtype, views=False):
        q, k, v = flash_inputs(b, hq, hkv, s, d, dtype, gen, views)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = by_batch(flash_attention_plain, q, k, v, causal=causal,
                       window=window)
        res = compare(out, ref, **FLASH_TOL[dtype])
        res.update(case=tag, shape=[b, hq, hkv, s, d], causal=causal,
                   window=window, dtype=str(dtype).split(".")[-1],
                   body=flash_body(dtype, d))
        cases.append(res)

    for c in FLASH_CASES:
        run("reference case fp32", *c, torch.float32)
        run("reference case bf16", *c, torch.bfloat16)
    run("bf16 case of the reference", 1, 2, 2, 256, 64, True, None,
        torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        run("ragged S", 2, 4, 2, 600, 64, True, None, dtype)
        run("ragged S, window, strided views", 1, 4, 4, 333, 128, True, 100,
            dtype, views=True)
    run("main path", **FLASH_MAIN, dtype=torch.bfloat16, views=True)
    for dtype in (torch.float32, torch.bfloat16):
        run("D = 80, GQA", 2, 4, 2, 256, 80, True, None, dtype)
        run("D = 80, ragged S, window, strided views", 1, 4, 4, 333, 80,
            True, 100, dtype, views=True)
        run("D = 80, not causal", 1, 2, 2, 130, 80, False, None, dtype)
        run("D = 256, ragged S, window, strided views", 1, 4, 2, 333, 256,
            True, 100, dtype, views=True)
    run("zamba2 main path, D = 80", **FLASH_D80, dtype=torch.bfloat16,
        views=True)
    for arch, m in path_flash():
        run(f"{arch} main path", **m, dtype=torch.bfloat16, views=True)
        torch.cuda.empty_cache()

    def run_odd(tag, q, k, v, causal, dtype, window=None):
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        res = compare(out, flash_attention_plain(q, k, v, causal=causal,
                                                 window=window),
                      **FLASH_TOL[dtype])
        res.update(case=tag, shape=[list(q.shape), list(k.shape)],
                   causal=causal, window=window,
                   dtype=str(dtype).split(".")[-1],
                   body=flash_body(dtype, q.shape[-1]))
        cases.append(res)

    for dtype in (torch.float32, torch.bfloat16):
        # more keys than queries, and the other way round
        q, _, _ = flash_inputs(2, 4, 2, 100, 64, dtype, gen)
        _, k, v = flash_inputs(2, 4, 2, 300, 64, dtype, gen)
        run_odd("Sq < Skv", q, k, v, False, dtype)
        run_odd("Sq < Skv, causal", q, k, v, True, dtype)
        q, _, _ = flash_inputs(1, 2, 2, 200, 32, dtype, gen)
        _, k, v = flash_inputs(1, 2, 2, 70, 32, dtype, gen)
        run_odd("Sq > Skv, causal", q, k, v, True, dtype)
        # query tiles wholly past Skv + window see no key: zeros
        for d in (64, 80, 256):
            q, _, _ = flash_inputs(1, 2, 2, 512, d, dtype, gen)
            _, k, v = flash_inputs(1, 2, 2, 64, d, dtype, gen)
            run_odd(f"Sq > Skv, causal, window, D = {d}", q, k, v, True,
                    dtype, window=64)
            run_odd(f"Sq > Skv, window, D = {d}", q, k, v, False, dtype,
                    window=32)
        # rows off the 16-byte grid: the wrapper copies before it launches
        wide = [t[..., 4:68] for t in flash_inputs(1, 2, 2, 130, 72, dtype,
                                                   gen)]
        run_odd("misaligned views", *wide, True, dtype)
    # unsupported shapes raise, they do not fall back
    q, k, v = flash_inputs(1, 2, 2, 64, 48, torch.float32, gen)
    for bad in (lambda: flash_attention(q, k, v),
                lambda: flash_attention(q.half(), k.half(), v.half())):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("an unsupported flash_attention call did not "
                             "raise")
    return cases


def repeats(first, again, dtype) -> bool:
    """Whether ``again()`` gives outputs bit-identical to ``first`` (None
    entries skipped); raises if not: every body sums in a fixed order."""
    same = all(a is None or torch.equal(a, b)
               for a, b in zip(first, again()))
    if not same:
        raise AssertionError(f"a {str(dtype).split('.')[-1]} backward call "
                             f"did not repeat bit for bit")
    return same


def in_runs_of_one_tile(fn):
    """``fn()`` with the fp32 backward body's dQ scratch held to one key
    tile's slice, so that it takes its key tiles one run each."""
    bytes_ = flash_mod.FMA_DQ_SCRATCH_BYTES
    flash_mod.FMA_DQ_SCRATCH_BYTES = 0
    try:
        return fn()
    finally:
        flash_mod.FMA_DQ_SCRATCH_BYTES = bytes_


def check_flash_bwd(gen) -> list:
    """The forward's log-sum-exp against :func:`flash_lse_plain`, and the
    backward kernel against :func:`flash_attention_bwd_plain` on the same
    q, k, v, o, lse and dO (o and lse from the forward kernel); a call again
    must repeat bit for bit, in fp32 also when the body takes its key tiles
    in runs of one (:func:`in_runs_of_one_tile`)."""
    cases = []

    def run(tag, q, k, v, causal, window, dtype):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     with_lse=True)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        torch.cuda.synchronize()
        res = {"case": tag, "shape": [list(q.shape), list(k.shape)],
               "causal": causal, "window": window,
               "dtype": str(dtype).split(".")[-1],
               "body": flash_bwd_body(dtype, q.shape[-1]),
               "lse": compare(lse, by_batch(flash_lse_plain, q, k,
                                            causal=causal, window=window),
                              **LSE_TOL)}
        ref = by_batch(flash_attention_bwd_plain, q, k, v, o, lse, do,
                       causal=causal, window=window)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            res[name] = compare_rel(a, r, BWD_RTOL[dtype])
        again = lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, window=window)
        res["rerun_bit_identical"] = repeats(got, again, dtype)
        if dtype == torch.float32:
            res["runs_of_one_tile_bit_identical"] = repeats(
                got, lambda: in_runs_of_one_tile(again), dtype)
        res["max_abs_err"] = max(res[n]["max_abs_err"]
                                 for n in ("dq", "dk", "dv"))
        cases.append(res)
        del o, lse, do, got, ref

    for dtype in (torch.float32, torch.bfloat16):
        for tag, shape, causal, window, views in (
                ("GQA", (2, 4, 2, 256, 64), True, None, False),
                ("ragged S, window, strided views", (1, 4, 4, 333, 80), True,
                 100, True),
                ("not causal, D = 80", (1, 2, 2, 130, 80), False, None,
                 False),
                ("GQA 4, window, not causal", (1, 4, 1, 300, 64), False, 64,
                 False),
                ("D = 256, ragged S, window, strided views",
                 (1, 4, 2, 333, 256), True, 100, True)):
            run(tag, *flash_inputs(*shape, dtype, gen, views), causal,
                window, dtype)
        q, _, _ = flash_inputs(2, 4, 2, 100, 64, dtype, gen)
        _, k, v = flash_inputs(2, 4, 2, 300, 64, dtype, gen)
        run("Sq < Skv, causal", q, k, v, True, None, dtype)
        q, _, _ = flash_inputs(1, 2, 2, 200, 80, dtype, gen)
        _, k, v = flash_inputs(1, 2, 2, 70, 80, dtype, gen)
        run("Sq > Skv, causal, window", q, k, v, True, 32, dtype)
        q, _, _ = flash_inputs(1, 4, 2, 200, 256, dtype, gen)
        _, k, v = flash_inputs(1, 4, 2, 70, 256, dtype, gen)
        run("Sq > Skv, causal, window, D = 256", q, k, v, True, 32, dtype)
        for b, hq, hkv, s, d, causal, window in FLASH_CASES:
            if d in BACKWARD_HEAD_DIMS:
                run("reference case", *flash_inputs(b, hq, hkv, s, d, dtype,
                                                    gen), causal, window,
                    dtype)
    for tag, m in (("main path", FLASH_MAIN), ("D = 80", FLASH_D80),
                   *((f"{a} main path", m) for a, m in path_flash())):
        q, k, v = flash_inputs(m["b"], m["hq"], m["hkv"], m["s"], m["d"],
                               torch.bfloat16, gen, views=True)
        run(tag, q, k, v, m["causal"], m["window"], torch.bfloat16)
        del q, k, v
        torch.cuda.empty_cache()
    # the backward takes BACKWARD_HEAD_DIMS only: a gradient at D = 32 raises
    q, k, v = (t.requires_grad_() for t in flash_inputs(
        1, 2, 2, 64, 32, torch.bfloat16, gen))
    try:
        flash_attention(q, k, v)
    except ValueError:
        return cases
    raise AssertionError("flash_attention with a gradient at D = 32 did not "
                         "raise")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it (nearest,
    ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def check_tsmm(gen) -> list:
    """Each case against the plain version and the float64 Gram matrix
    with ``tsmm_tol``.  At every fp32 case a control, one tf32 product of
    the rounded inputs (the kernel without its lo parts, as plain TF32 gives
    it), must fail the same check."""
    cases = []

    def run(tag, m, n, dtype, reg=0.0, x=None):
        if x is None:
            x = torch.randn((m, n), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
        out = tsmm_upper(x, reg=reg)
        torch.cuda.synchronize()
        tol = tsmm_tol(dtype, m)
        plain = tsmm_upper_plain(x, reg=reg)
        res = compare(out, plain, **tol)
        # and against the float64 Gram matrix, which no fp32 sum touches
        x64 = x.to(torch.float64)
        g64 = x64.T @ x64 + reg * torch.eye(n, dtype=torch.float64,
                                            device="cuda")
        blk = torch.arange(n, device="cuda") // 128
        g64 = g64 * (blk[:, None] <= blk[None, :])
        res["max_abs_err_vs_f64"] = compare(out, g64, **tol)["max_abs_err"]
        del x64, g64
        if dtype == torch.float32:
            control = tsmm_upper_plain(tf32_round(x), reg=reg).double()
            p64 = plain.double()
            err = (control - p64).abs()
            res["tf32_control_max_abs_err"] = float(err.max())
            if not bool((err > tol["atol"] + tol["rtol"] * p64.abs()).any()):
                raise AssertionError(f"tsmm {tag}: the one-product tf32 "
                                     f"control passes the kernel's check")
            del control, p64, err
        full = ops.tsmm(x, reg=reg)
        if not torch.equal(full, full.T):
            raise AssertionError("ops.tsmm is not symmetric")
        res.update(case=tag, shape=[m, n], stride=list(x.stride()), reg=reg,
                   dtype=str(dtype).split(".")[-1])
        cases.append(res)
        return x, out

    for m, n in TSMM_CASES:
        run("reference case fp32", m, n, torch.float32)
    run("bf16 case of the reference", 512, 256, torch.bfloat16)
    run("ridge", 512, 256, torch.float32, reg=7.25)
    run("ragged m and n, split over m", 5000, 200, torch.float32, reg=0.5)
    run("ragged m and n, split over m", 5000, 200, torch.bfloat16, reg=0.5)
    run("m below one slab", 20, 256, torch.float32)
    run("m not a multiple of the slab", 3001, 384, torch.float32)
    run("n = 1536, 78 upper tiles", 4096, 1536, torch.float32, reg=1.5)
    run("n = 100, one partial tile", 2000, 100, torch.float32, reg=0.5)
    wide = torch.randn((3001, 400), generator=gen, device="cuda")
    run("row-strided view", 3001, 384, torch.float32, x=wide[:, 8:392])
    run("misaligned view, copied", 3001, 384, torch.float32,
        x=wide[:, 1:385])
    run("bf16 with reg, m not a multiple of the slab", 3001, 384,
        torch.bfloat16, reg=2.5)
    del wide
    x, out = run("LinReg DS", LINREG_M, LINREG_N, torch.float32,
                 reg=LINREG_LAM)
    if not torch.equal(tsmm_upper(x, reg=LINREG_LAM), out):
        raise AssertionError("tsmm: two calls differ at the LinReg DS shape")
    del x, out
    # a NaN with every payload bit set (as CUDA's arithmetic makes it)
    # reaches the same elements as in the plain version
    x = torch.randn((512, 256), generator=gen, device="cuda")
    x.view(torch.int32)[7, 100] = 0x7FFFFFFF
    nan_out, nan_plain = tsmm_upper(x).isnan(), tsmm_upper_plain(x).isnan()
    if not nan_plain.any() or not torch.equal(nan_out, nan_plain):
        raise AssertionError("tsmm: a NaN in x does not reach the elements "
                             "it reaches in the plain version")
    cases.append({"case": "NaN in x", "shape": [512, 256],
                  "nan_elements": int(nan_out.sum())})
    x = torch.randn((64, 30), generator=gen, device="cuda")
    try:
        tsmm_upper(x)
    except ValueError:
        pass
    else:
        raise AssertionError("an unsupported tsmm_upper call did not raise")
    return cases


def mm_inputs(m, n, k, dtype, gen, epilogue=None, model_like=False,
              w_transposed=False):
    """Seeded x [m, k], w [k, n] (a transposed view of an [n, k] tensor with
    ``w_transposed``), bias [n] for the bias epilogue.  By default unit
    normals, as the reference's kernel tests draw them; ``model_like``
    scales w by k^-0.5, as the model's init does."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32)
    x = rand(m, k).to(dtype)
    w = rand(n, k).T if w_transposed else rand(k, n)
    w = (w * (k ** -0.5 if model_like else 1.0)).to(dtype)
    bias = rand(n).to(dtype) if epilogue == "bias" else None
    return x, w, bias


def mm_bound_ms(m, n, k, dtype, out_dtype, **_) -> dict:
    """2 m n k flop; x and w read once, out written once."""
    esize = torch.empty((), dtype=dtype).element_size()
    osize = torch.empty((), dtype=out_dtype).element_size()
    flops = 2.0 * m * n * k
    nbytes = (m * k + k * n) * esize + m * n * osize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flops, "bytes": nbytes}


def bf16_accumulator_fault(x, w, bias=None, *, epilogue=None,
                           out_dtype=None):
    """A control, not a kernel: ``epilogue(x @ w)`` with the accumulator
    kept in the operands' type and rounded after every 32-deep step over K,
    as a kernel that lost its fp32 accumulator would give it."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    for k0 in range(0, x.shape[1], 32):
        acc += x[:, k0:k0 + 32] @ w[k0:k0 + 32]
    out = acc.float()
    if epilogue == "silu":
        out = F.silu(out)
    elif epilogue is not None:
        raise ValueError(f"control: epilogue {epilogue!r} is on no path")
    return out.to(out_dtype or x.dtype)


def coarse_flush_fault(x, w, bias=None, *, epilogue=None, out_dtype=None):
    """A control, not a kernel: the plain version with its one flush rounded
    to 6 bits of mantissa, one fewer than bf16 keeps."""
    out = matmul_epilogue_plain(x, w, bias, epilogue=epilogue,
                                out_dtype=torch.float32)
    bits = (out.view(torch.int32) + (1 << 16)) & -(1 << 17)
    return bits.view(torch.float32).to(out_dtype or x.dtype)


# Faults the epilogue kernel could have.  ``check_mm`` holds each against the
# plain version at the path shapes, as it holds the kernel; ``phase_serve``
# runs the kernel path with each in the kernel's place and reports how far it
# moves the bf16 prefill logits, beside the bound those logits are held to.
CONTROLS = {"bf16_accumulator": bf16_accumulator_fault,
            "flush_one_bit_coarser": coarse_flush_fault}


def check_controls(gen) -> list:
    """Each control against the plain version at each path shape, with the
    kernel's tolerance.  A bf16 accumulator must fail everywhere, a coarser
    flush wherever the output is fp32; a coarser flush to bf16 stays within
    one bf16 step of the plain version, which no check of a bf16 output can
    tell from sound rounding."""
    cases = []
    for tag, c in (("zamba2 gate", MM_GATE), ("zamba2 head", MM_HEAD),
                   ("qwen gate", MM_QWEN_GATE), ("qwen head", MM_QWEN_HEAD),
                   ("mamba2 head", MM_MAMBA_HEAD)):
        x, w, _ = mm_inputs(c["m"], c["n"], c["k"], c["dtype"], gen,
                            model_like=True)
        kw = dict(epilogue=c["epilogue"], out_dtype=c["out_dtype"])
        ref = matmul_epilogue_plain(x, w, **kw).to(torch.float64)
        tol = mm_tol(c["out_dtype"], c["k"])
        for name, fault in CONTROLS.items():
            err = (fault(x, w, **kw).to(torch.float64) - ref).abs()
            caught = bool((err > tol["atol"] + tol["rtol"] * ref.abs()).any())
            must = name == "bf16_accumulator" \
                or c["out_dtype"] == torch.float32
            if must and not caught:
                raise AssertionError(f"control {name} at the {tag} shape "
                                     f"passes the kernel's check")
            cases.append({"case": f"control {name}, {tag} path shape",
                          "caught": caught, "max_abs_err": float(err.max()),
                          "ref_max_abs": float(ref.abs().max()), **tol})
        del x, w, ref, err
    return cases


def check_mm(gen) -> list:
    cases = []

    def run(tag, m, n, k, dtype, epilogue=None, out_dtype=None, body=None,
            **kw):
        x, w, bias = mm_inputs(m, n, k, dtype, gen, epilogue, **kw)
        took = matmul_body(x, w, out_dtype, epilogue)
        if body is not None and took != body:
            raise AssertionError(f"matmul_epilogue {tag}: body {took}, "
                                 f"expected {body}")
        before = matmul_epilogue.body_launches[took]
        out = matmul_epilogue(x, w, bias, epilogue=epilogue,
                              out_dtype=out_dtype)
        torch.cuda.synchronize()
        if matmul_epilogue.body_launches[took] != before + 1:
            raise AssertionError(f"matmul_epilogue {tag}: body {took} not "
                                 f"counted")
        ref = matmul_epilogue_plain(x, w, bias, epilogue=epilogue,
                                    out_dtype=out_dtype)
        if out.dtype != ref.dtype or not out.is_contiguous():
            raise AssertionError(f"matmul_epilogue: output {out.dtype}, "
                                 f"contiguous {out.is_contiguous()}")
        res = compare(out, ref, **mm_tol(out.dtype, k))
        res.update(case=tag, shape=[m, n, k], epilogue=epilogue,
                   dtype=str(dtype).split(".")[-1],
                   out_dtype=str(out.dtype).split(".")[-1], body=took)
        cases.append(res)

    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in MM_CASES:
            for epi in (None, "bias", "silu", "gelu"):
                run("reference case", m, n, k, dtype, epi)
        run("layernorm, full row", 256, 256, 256, dtype, "layernorm")
        run(f"layernorm at the widest row, {LN_MAX_N}", 40, LN_MAX_N, 200,
            dtype, "layernorm", model_like=True)
        for epi in (None, "bias", "silu", "gelu", "layernorm"):
            run("ragged m, n and k, transposed w", 77, 131, 45, dtype, epi,
                w_transposed=True)
        run("ragged, odd n (unaligned rows)", 1000, 1001, 520, dtype, "silu",
            model_like=True,
            body="fma" if dtype == torch.float32 else "mma_sync")
    run("cast sinking fp32 -> bf16", 256, 256, 256, torch.float32, "silu",
        torch.bfloat16)
    run("cast sinking bf16 -> fp32", 256, 256, 256, torch.bfloat16, "gelu",
        torch.float32)
    g = MM_DECODE_GATE
    run("decode-step gate, 8 rows", g["m"], g["n"], g["k"], g["dtype"],
        g["epilogue"], g["out_dtype"], model_like=True)
    h = MM_MAMBA_HEAD
    run("mamba2 head, vocab 50280", h["m"], h["n"], h["k"], h["dtype"],
        h["epilogue"], h["out_dtype"], model_like=True)
    g, h = MM_GATE, MM_HEAD
    run("zamba2 gate main path", g["m"], g["n"], g["k"], g["dtype"],
        g["epilogue"], g["out_dtype"], model_like=True)
    run("zamba2 head main path", h["m"], h["n"], h["k"], h["dtype"],
        h["epilogue"], h["out_dtype"], model_like=True)
    g, h = MM_QWEN_GATE, MM_QWEN_HEAD
    run("qwen gate main path", g["m"], g["n"], g["k"], g["dtype"],
        g["epilogue"], g["out_dtype"], model_like=True)
    d = MM_QWEN_DECODE_GATE
    run("qwen decode-step gate, 8 rows", d["m"], d["n"], d["k"], d["dtype"],
        d["epilogue"], d["out_dtype"], model_like=True)
    run("qwen head main path, vocab 151936", h["m"], h["n"], h["k"],
        h["dtype"], h["epilogue"], h["out_dtype"], model_like=True)
    for tag, c in path_mm():
        run(f"{tag} main path", c["m"], c["n"], c["k"], c["dtype"],
            c["epilogue"], c["out_dtype"], model_like=True)
        torch.cuda.empty_cache()
    # the wgmma body's edges: one 128-row tile and a row, two and a row; w
    # transposed (a K-major operand); ragged M, N and K; fp32 out (the
    # 128 x 128 tile)
    for m in (65, 129):
        run(f"wgmma, ragged m = {m}", m, 2816, 1024, torch.bfloat16, "silu",
            model_like=True, body="wgmma")
    run("wgmma, aligned transposed w (K-major B)", 1024, 4096, 2048,
        torch.bfloat16, "silu", model_like=True, w_transposed=True,
        body="wgmma")
    run("wgmma, ragged m, n and k, bias", 333, 200, 104, torch.bfloat16,
        "bias", body="wgmma")
    run("wgmma, ragged, fp32 out", 333, 200, 104, torch.bfloat16, "gelu",
        torch.float32, body="wgmma")
    run("wgmma, transposed w, ragged, fp32 out", 200, 136, 72,
        torch.bfloat16, None, torch.float32, w_transposed=True,
        body="wgmma")
    # the small-M body: 1, 8 and 64 rows at qwen's gate width (slabs shared
    # by blocks); ragged everywhere, x read element-wise; a transposed w
    # (read element-wise)
    for m in (1, 8, 64):
        run(f"small_m, {m} rows", m, 2816, 1024, torch.bfloat16, "silu",
            model_like=True, body="small_m")
    run("small_m, ragged m, n and k, bias, fp32 out", 5, 1000, 777,
        torch.bfloat16, "bias", torch.float32, body="small_m")
    run("small_m, transposed w", 8, 200, 136, torch.bfloat16, "gelu",
        w_transposed=True, body="small_m")
    # 128-column slabs (at most 8 rows, more 64-column slabs than the card
    # holds blocks): ragged n and k by TMA, and a transposed w by cp.async
    run("small_m, wide slabs, ragged", 3, 45000, 200, torch.bfloat16, "gelu",
        body="small_m")
    run("small_m, wide slabs, transposed w", 8, 50280, 256, torch.bfloat16,
        None, torch.float32, w_transposed=True, body="small_m")
    # unsupported calls raise, they do not fall back
    x, w, _ = mm_inputs(16, LN_MAX_N + 1, 32, torch.float32, gen)
    for bad in (lambda: matmul_epilogue(x, w, epilogue="layernorm"),
                lambda: matmul_epilogue(x.half(), w.half()),
                lambda: matmul_epilogue(x, w.bfloat16()),
                lambda: matmul_epilogue(x, w, out_dtype=torch.float16)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("an unsupported matmul_epilogue call did not "
                             "raise")
    return cases


def ssd_inputs(b, s, h, p, g, n, dtype, gen, model_like=False, init=False,
               views=False):
    """Pre-scaled inputs of the scan on the card.  By default drawn as the
    reference's kernel tests draw x, dt and A_log (dt in [0.01, 0.2], A_log
    in [-1, 1]); ``model_like`` draws them as the serve path makes them
    (dt = softplus of a unit normal, A_log = log(linspace(1, 16))).  With
    ``views`` B and C are views into one [b, s, h*p + 2*g*n] tensor, as the
    model hands them over."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32)
    x = rand(b, s, h, p).to(dtype)
    if model_like:
        dt = F.softplus(rand(b, s, h))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    else:
        dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device="cuda")
        a_log = 2 * torch.rand((h,), generator=gen, device="cuda") - 1
    log_a = dt * -torch.exp(a_log)
    xbar = x * dt[..., None].to(dtype)
    if views:
        proj = rand(b, s, h * p + 2 * g * n).to(dtype)
        bm = proj[..., h * p:h * p + g * n].reshape(b, s, g, n)
        cm = proj[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        bm, cm = rand(b, s, g, n).to(dtype), rand(b, s, g, n).to(dtype)
    st = rand(b, h, p, n) if init else None
    return xbar, log_a, bm, cm, st


def ssd_bound_ms(b, s, h, p, g, n, chunk, dtype, init=False) -> dict:
    """flop: the lower-triangle pairs of each chunk, C B^T once per group and
    P Xbar once per head, then C S^T and the state update per head; bytes:
    xbar, y, B and C by group, log_a, the states; each read or written
    once."""
    esize = torch.empty((), dtype=dtype).element_size()
    flops = 0.0
    for r0 in range(0, s, chunk):
        ln = min(chunk, s - r0)
        flops += b * g * ln * (ln + 1) * n \
            + b * h * (ln * (ln + 1) * p + 4 * ln * p * n)
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * esize \
        + 4 * b * s * h + 4 * b * h * p * n * (2 if init else 1)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flops, "bytes": nbytes}


def check_ssd(gen) -> list:
    cases = []

    def run(tag, b, s, h, p, g, n, chunk, dtype, **kw):
        xbar, log_a, bm, cm, st = ssd_inputs(b, s, h, p, g, n, dtype, gen,
                                             **kw)
        y, state = ssd_scan(xbar, log_a, bm, cm, chunk=chunk, init_state=st)
        torch.cuda.synchronize()
        y_ref, st_ref = ssd_scan_plain(xbar, log_a, bm, cm, chunk=chunk,
                                       init_state=st)
        tol = ssd_tol(dtype, log_a, chunk, y_ref, st_ref)
        res = compare(y, y_ref, **tol["y"])
        res["state"] = compare(state, st_ref, **tol["state"])
        res.update(case=tag, shape=[b, s, h, p, g, n], chunk=chunk,
                   dtype=str(dtype).split(".")[-1])
        cases.append(res)

    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, p, n, chunk in SSD_CASES:
            run("reference case", b, s, h, p, 1, n, chunk, dtype)
        run("ragged S", 2, 600, 4, 64, 1, 128, 256, dtype)
        run("ragged S, B/C views", 1, 333, 4, 32, 1, 64, 64, dtype,
            views=True)
        run("groups G = 2", 2, 256, 8, 64, 2, 128, 64, dtype)
        run("initial state", 2, 300, 4, 64, 1, 128, 128, dtype, init=True)
        run("initial state, decays of the serve path", 1, 700, 4, 64, 1, 128,
            256, dtype, init=True, model_like=True)
    for tag, m in (("main path", SSD_MAIN), ("zamba2 main path", SSD_ZAMBA)):
        run(tag, m["b"], m["s"], m["h"], m["p"], m["g"], m["n"], m["chunk"],
            torch.bfloat16, model_like=True, views=True)
    # unsupported calls raise, they do not fall back
    xbar, log_a, bm, cm, _ = ssd_inputs(1, 64, 2, 48, 1, 16, torch.float32,
                                        gen)
    good = ssd_inputs(1, 64, 2, 16, 1, 16, torch.float32, gen)
    for bad in (lambda: ssd_scan(xbar, log_a, bm, cm, chunk=16),
                lambda: ssd_scan(good[0].half(), good[1], good[2].half(),
                                 good[3].half(), chunk=16),
                lambda: ssd_scan(good[0], good[1].bfloat16(), good[2],
                                 good[3], chunk=16),
                lambda: ssd_scan(*good[:4], chunk=4096)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("an unsupported ssd_scan call did not raise")
    return cases


def check_ssd_bwd(gen) -> list:
    """The backward kernel against :func:`ssd_scan_bwd_plain` on the same
    inputs, random dy and d final_state."""
    cases = []

    def run(tag, b, s, h, p, g, n, chunk, dtype, **kw):
        xbar, log_a, bm, cm, st = ssd_inputs(b, s, h, p, g, n, dtype, gen,
                                             **kw)
        dy = torch.randn(xbar.shape, generator=gen, device="cuda").to(dtype)
        dfin = torch.randn((b, h, p, n), generator=gen, device="cuda")
        got = ssd_scan_bwd(xbar, log_a, bm, cm, dy, dfin, chunk=chunk,
                           init_state=st)
        torch.cuda.synchronize()
        ref = ssd_scan_bwd_plain(xbar, log_a, bm, cm, dy, dfin, chunk=chunk,
                                 init_state=st)
        res = {"case": tag, "shape": [b, s, h, p, g, n], "chunk": chunk,
               "dtype": str(dtype).split(".")[-1],
               "body": ssd_bwd_body(dtype)}
        for name, a, r in zip(("dxbar", "dlog_a", "dB", "dC", "dinit"), got,
                              ref):
            if r is not None:
                res[name] = compare_rel(a, r, BWD_RTOL[a.dtype])
        res["max_abs_err"] = max(v["max_abs_err"] for v in res.values()
                                 if isinstance(v, dict))
        res["rerun_bit_identical"] = repeats(got, lambda: ssd_scan_bwd(
            xbar, log_a, bm, cm, dy, dfin, chunk=chunk, init_state=st), dtype)
        cases.append(res)
        del xbar, log_a, bm, cm, st, dy, dfin, got, ref

    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, p, n, chunk in SSD_CASES:
            run("reference case", b, s, h, p, 1, n, chunk, dtype)
        run("ragged S", 2, 600, 4, 64, 1, 128, 256, dtype)
        run("ragged S, B/C views", 1, 333, 4, 32, 1, 64, 64, dtype,
            views=True)
        run("groups G = 2", 2, 256, 8, 64, 2, 128, 64, dtype)
        run("initial state", 2, 300, 4, 64, 1, 128, 128, dtype, init=True)
        # the tensor-core body runs chunks of at most 256 rows
        run("chunk 512, ragged S", 1, 600, 2, 32, 1, 64, 512, dtype)
    for tag, m in (("main path", SSD_MAIN), ("zamba2 main path", SSD_ZAMBA)):
        run(tag, m["b"], m["s"], m["h"], m["p"], m["g"], m["n"], m["chunk"],
            torch.bfloat16, model_like=True, views=True)
    torch.cuda.empty_cache()
    return cases


def check_ssd_control(gen) -> list:
    """The state path's rounding plan against its control:
    ``ssd_scan_split_plain`` as the kernel splits the decayed Xbar (hi +
    lo), then with it rounded once to bf16, each held to the state's
    tolerance against the plain version.  The split must pass everywhere; at
    a reference case, where the state's tolerance is the fp32 2e-4, the
    single rounding must be caught.  At the served shapes, with the serve
    path's decays, ``ssd_tol`` is too loose to catch it, so there the
    kernel's state is also held against the split plain version, which makes
    the same products with the same roundings: its largest error, over the
    state's largest element, must stay within ``SSD_SPLIT_STATE_LIMIT`` and
    the rounded-once control's must exceed it."""
    cases, faults = [], []
    for tag, m, served in (
            ("main path", SSD_MAIN, True),
            ("zamba2 main path", SSD_ZAMBA, True),
            ("reference case", dict(b=1, s=256, h=2, p=64, g=1, n=128,
                                    chunk=64), False)):
        xbar, log_a, bm, cm, _ = ssd_inputs(m["b"], m["s"], m["h"], m["p"],
                                            m["g"], m["n"], torch.bfloat16,
                                            gen, model_like=served,
                                            views=served)
        y_ref, st_ref = ssd_scan_plain(xbar, log_a, bm, cm, chunk=m["chunk"])
        tol = ssd_tol(torch.bfloat16, log_a, m["chunk"], y_ref,
                      st_ref)["state"]
        ref = st_ref.to(torch.float64)
        del y_ref, st_ref
        out = {"case": f"state operand: hi + lo against one bf16 rounding, "
                       f"{tag}", "shape": [m[k] for k in "bshpgn"], **tol}
        states = {}
        for name, split in (("split", True), ("rounded_once", False)):
            _, st = ssd_scan_split_plain(xbar, log_a, bm, cm,
                                         chunk=m["chunk"], split_state=split)
            err = (st.to(torch.float64) - ref).abs()
            beyond = err > tol["atol"] + tol["rtol"] * ref.abs()
            out[name] = {"caught": bool(beyond.any()),
                         "n_beyond": int(beyond.sum()),
                         "max_abs_err": float(err.max())}
            states[name] = st.to(torch.float64)
            del st, err, beyond
        if out["split"]["caught"]:
            faults.append(f"the split state path fails its tolerance, {tag}")
        if not served and not out["rounded_once"]["caught"]:
            faults.append("one bf16 rounding of the state path passes the "
                          "fp32 tolerance")
        if served:
            _, st = ssd_scan(xbar, log_a, bm, cm, chunk=m["chunk"])
            torch.cuda.synchronize()
            split = states["split"]
            top = float(split.abs().max())
            vs = {"limit": SSD_SPLIT_STATE_LIMIT, "split_max_abs": top}
            for name, s_out in (("kernel", st.to(torch.float64)),
                                ("rounded_once", states["rounded_once"])):
                vs[name] = float((s_out - split).abs().max()) / top
            out["vs_split"] = vs
            if not vs["kernel"] <= SSD_SPLIT_STATE_LIMIT:
                faults.append(f"the kernel's state is {vs['kernel']} from "
                              f"the split plain version, {tag}")
            if not vs["rounded_once"] > SSD_SPLIT_STATE_LIMIT:
                faults.append(f"one bf16 rounding of the state path passes "
                              f"the split check, {tag}")
            del st, split
        del states, ref
        cases.append(out)
    if faults:
        raise AssertionError(f"{'; '.join(faults)}: {cases}")
    return cases


# The bf16 backward body's dlog_a against ``ssd_scan_bwd_split_plain`` at
# mamba2's served shape: the largest error over dlog_a's largest magnitude.
# Both make the same products with the same roundings and differ in the
# order of fp32 sums and in the exponentials (a block scan's cumsum and
# torch.cumsum's differ in order: at the serve path's |cum| of about 2000 the
# decays differ by about eps * |cum|, so the kernel scans in torch.cumsum's
# order).  On an H100 the kernel read 4.8e-7 to 6.2e-7 (3.2e-5 with a block
# scan), the fp32 operands rounded once to bf16 4.2e-4 to 7.3e-4; the limit
# is the geometric mean of the largest of the first and the smallest of the
# second, 1.6e-5, rounded down to one digit, as for ``SSD_SPLIT_STATE_LIMIT``.
SSD_BWD_SPLIT_LIMIT = 1e-5
SSD_BWD_CASES = [("reference case", (1, 256, 2, 64, 1, 128, 64), {}),
                 ("sweep 1", (2, 128, 4, 16, 1, 32, 32), {}),
                 ("sweep 3", (2, 64, 8, 32, 1, 16, 16), {}),
                 ("ragged S", (2, 600, 4, 64, 1, 128, 256), {}),
                 ("groups G = 2", (2, 256, 8, 64, 2, 128, 64), {}),
                 ("initial state", (2, 300, 4, 64, 1, 128, 128),
                  dict(init=True))]


def check_ssd_bwd_control(gen) -> list:
    """The SSD backward's rounding plan against its control, on the card:
    ``ssd_scan_bwd_split_plain`` as the tensor-core body splits every fp32
    operand (hi + lo), then with each rounded once to bf16, both held to
    ``BWD_RTOL`` against :func:`ssd_scan_bwd_plain`.  The split must pass at
    every case; at the reference case the single rounding must be caught
    (dlog_a, fp32, 1e-4).  At mamba2's served shape, where ``BWD_RTOL`` is
    the check of the kernel, the kernel's dlog_a is also held against the
    split plan's (``SSD_BWD_SPLIT_LIMIT``), and the rounded-once plan's must
    miss that limit."""
    cases, faults = [], []
    m = SSD_MAIN
    served = ("main path", (m["b"], m["s"], m["h"], m["p"], m["g"], m["n"],
                            m["chunk"]), dict(model_like=True, views=True))
    names = ("dxbar", "dlog_a", "dB", "dC", "dinit")
    for tag, (b, s, h, p, g, n, chunk), kw in SSD_BWD_CASES + [served]:
        xbar, log_a, bm, cm, st = ssd_inputs(b, s, h, p, g, n, torch.bfloat16,
                                             gen, **kw)
        dy = torch.randn(xbar.shape, generator=gen, device="cuda").to(
            xbar.dtype)
        dfin = torch.randn((b, h, p, n), generator=gen, device="cuda")
        args = (xbar, log_a, bm, cm, dy, dfin)
        ref = ssd_scan_bwd_plain(*args, chunk=chunk, init_state=st)
        out = {"case": f"rounding plan: hi + lo against one bf16 rounding, "
                       f"{tag}", "shape": [b, s, h, p, g, n], "chunk": chunk}
        plans = {}
        for name, split in (("split", True), ("rounded_once", False)):
            got = ssd_scan_bwd_split_plain(*args, chunk=chunk, init_state=st,
                                           split=split)
            caught = []
            for o_name, a, r in zip(names, got, ref):
                if r is None:
                    continue
                try:
                    compare_rel(a, r, BWD_RTOL[a.dtype])
                except AssertionError:
                    caught.append(o_name)
            out[name] = {"caught": caught,
                         "dlog_a_rel_err": float((got[1] - ref[1]).abs().max()
                                                 / ref[1].abs().max())}
            plans[name] = got[1]
            del got
        if out["split"]["caught"]:
            faults.append(f"the split plan fails {out['split']['caught']}, "
                          f"{tag}")
        if tag == "reference case" and \
                "dlog_a" not in out["rounded_once"]["caught"]:
            faults.append("one bf16 rounding of the backward's fp32 operands "
                          "passes dlog_a's tolerance")
        if tag == "main path":
            got = ssd_scan_bwd(*args, chunk=chunk, init_state=st)
            torch.cuda.synchronize()
            split = plans["split"].to(torch.float64)
            top = float(split.abs().max())
            vs = {"limit": SSD_BWD_SPLIT_LIMIT, "split_max_abs": top}
            for name, d in (("kernel", got[1]),
                            ("rounded_once", plans["rounded_once"])):
                vs[name] = float((d.to(torch.float64) - split).abs().max()) \
                    / top
            out["dlog_a_vs_split"] = vs
            if not vs["kernel"] <= SSD_BWD_SPLIT_LIMIT:
                faults.append(f"the kernel's dlog_a is {vs['kernel']} from "
                              f"the split plan, {tag}")
            if not vs["rounded_once"] > SSD_BWD_SPLIT_LIMIT:
                faults.append(f"one bf16 rounding passes the split check of "
                              f"dlog_a, {tag}")
            del got, split
        cases.append(out)
        del xbar, log_a, bm, cm, st, dy, dfin, args, ref, plans
        torch.cuda.empty_cache()
    if faults:
        raise AssertionError(f"{'; '.join(faults)}: {cases}")
    return cases


def device_kernel_ms(fn) -> dict:
    """Device milliseconds of each CUDA kernel one call of ``fn`` runs, by
    torch.profiler (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds a call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events; no host time
    between launches, the graph's gaps between kernels included.  The
    allocator's cache is emptied 0.3 s before the capture (which empties
    it too): for a while after the driver takes back gigabytes, an 8-row
    head timed on an H100 read slower than the same call timed later."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    time.sleep(0.3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps, 1) / calls


# w of an 8-row call is cold when the copies it rotates over exceed the
# 50 MB L2 more than twice over
COLD_BYTES = 120e6


def time_kernels(gen) -> dict:
    """Each kernel at its main-path shape: kernel, plain version, and one
    PyTorch library call (a yardstick; the port never calls it)."""
    m = FLASH_MAIN
    q, k, v = flash_inputs(m["b"], m["hq"], m["hkv"], m["s"], m["d"],
                           torch.bfloat16, gen, views=True)
    flash = {
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True), 20, 3),
        "plain_ms": time_ms(
            lambda: flash_attention_plain(q, k, v, causal=True), 2),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            20, 3),
        "shape": "q,k,v [8,16,2048,64] bf16 causal, transposed views",
        "body": flash_body(torch.bfloat16, 64),
    }
    flash["ratio_to_library"] = flash["ms"] / flash["library_ms"]
    q32, k32, v32 = q.float(), k.float(), v.float()
    flash["fp32_body_ms"] = time_ms(
        lambda: flash_attention(q32, k32, v32, causal=True), 3)
    del q, k, v, q32, k32, v32
    x = torch.randn((LINREG_M, LINREG_N), generator=gen, device="cuda",
                    dtype=torch.float32)
    tsmm = {
        "ms": time_ms(lambda: tsmm_upper(x, reg=LINREG_LAM), 5),
        "plain_ms": time_ms(lambda: tsmm_upper_plain(x, reg=LINREG_LAM), 3),
        "library_ms": time_ms(lambda: x.T @ x, 5),
        "shape": f"x [{LINREG_M},{LINREG_N}] fp32",
    }
    tsmm["ratio_to_library"] = tsmm["ms"] / tsmm["library_ms"]
    del x
    ssd = {}
    for name, m in (("mamba2", SSD_MAIN), ("zamba2", SSD_ZAMBA)):
        xbar, log_a, bm, cm, _ = ssd_inputs(m["b"], m["s"], m["h"], m["p"],
                                            m["g"], m["n"], torch.bfloat16,
                                            gen, model_like=True, views=True)
        ssd[name] = {
            "ms": time_ms(lambda: ssd_scan(xbar, log_a, bm, cm,
                                           chunk=m["chunk"]), 10, 2),
            "plain_ms": time_ms(lambda: ssd_scan_plain(
                xbar, log_a, bm, cm, chunk=m["chunk"]), 2),
            "library_ms": None,
            "library_note": "no single PyTorch call computes an SSD scan",
            "shape": f"xbar [8,2048,{m['h']},64] bf16, B/C "
                     f"[8,2048,1,{m['n']}] views, chunk 256",
            "cuda_kernels_ms": device_kernel_ms(
                lambda: ssd_scan(xbar, log_a, bm, cm, chunk=m["chunk"])),
            **ssd_bound_ms(**m, dtype=torch.bfloat16),
        }
        x32, b32, c32 = xbar.float(), bm.float(), cm.float()
        ssd[name]["fp32_body_ms"] = time_ms(
            lambda: ssd_scan(x32, log_a, b32, c32, chunk=m["chunk"]), 3)
        del xbar, log_a, bm, cm, x32, b32, c32
    m = FLASH_D80
    q, k, v = flash_inputs(m["b"], m["hq"], m["hkv"], m["s"], m["d"],
                           torch.bfloat16, gen, views=True)
    flash["d80"] = {
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True), 20, 3),
        "plain_ms": time_ms(
            lambda: flash_attention_plain(q, k, v, causal=True), 2),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            20, 3),
        "shape": "q,k,v [8,32,2048,80] bf16 causal, transposed views "
                 "(zamba2-2.7b)",
        "body": flash_body(torch.bfloat16, 80),
    }
    flash["d80"]["ratio_to_library"] = (flash["d80"]["ms"]
                                        / flash["d80"]["library_ms"])
    del q, k, v
    for arch, m in path_flash():
        q, k, v = flash_inputs(m["b"], m["hq"], m["hkv"], m["s"], m["d"],
                               torch.bfloat16, gen, views=True)
        gqa, causal, window = m["hq"] != m["hkv"], m["causal"], m["window"]
        lib, lib_note = sdpa_call(q, k, v, causal, window, gqa)
        flash[arch] = {
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                  window=window), 10, 2),
            "plain_ms": time_ms(lambda: by_batch(
                flash_attention_plain, q, k, v, causal=causal,
                window=window), 1),
            "plain_note": "the plain version one batch row at a time",
            "library_ms": time_ms(lib, 10, 2),
            "library_note": lib_note,
            "library_kernels_ms": device_kernel_ms(lib),
            "shape": f"q [8,{m['hq']},{m['s']},{m['d']}], k,v "
                     f"[8,{m['hkv']},{m['s']},{m['d']}] bf16 "
                     f"{'causal' if causal else 'not causal'}"
                     f"{f', window {window}' if window else ''}, "
                     f"transposed views ({arch})",
            "body": flash_body(torch.bfloat16, m["d"]),
            **flash_bound_ms(**m, dtype=torch.bfloat16)}
        flash[arch]["ratio_to_library"] = (flash[arch]["ms"]
                                           / flash[arch]["library_ms"])
        del q, k, v
        torch.cuda.empty_cache()
    mm = {}
    gate_lib = (lambda x, w: F.silu(x @ w),
                "two calls: x @ w (bf16 out), then F.silu")
    head_lib = (lambda x, w: (x @ w).float(),
                "two calls: x @ w (bf16 out), then .float()")
    for name, c, (lib_fn, lib_note) in (
            ("gate", MM_GATE, gate_lib), ("head", MM_HEAD, head_lib),
            ("qwen_gate", MM_QWEN_GATE, gate_lib),
            ("qwen_head", MM_QWEN_HEAD, head_lib),
            ("mamba_head", MM_MAMBA_HEAD, head_lib),
            ("decode_gate", MM_DECODE_GATE, gate_lib),
            ("qwen_decode_gate", MM_QWEN_DECODE_GATE, gate_lib),
            *((tag, c, head_lib if c["epilogue"] is None else gate_lib)
              for tag, c in path_mm())):
        x, w, _ = mm_inputs(c["m"], c["n"], c["k"], c["dtype"], gen,
                            model_like=True)
        kw = dict(epilogue=c["epilogue"], out_dtype=c["out_dtype"])
        entry = {"body": matmul_body(x, w, c["out_dtype"], c["epilogue"]),
                 "library_note": lib_note,
                 "shape": f"x [{c['m']},{c['k']}] w [{c['k']},{c['n']}] "
                          f"{str(c['dtype']).split('.')[-1]}, "
                          f"{c['epilogue'] or 'no'} epilogue, "
                          f"{str(c['out_dtype']).split('.')[-1]} out",
                 **mm_bound_ms(**c)}
        if c["m"] > 8:
            entry.update(
                ms=time_ms(lambda: matmul_epilogue(x, w, **kw), 20, 3),
                plain_ms=time_ms(lambda: matmul_epilogue_plain(x, w, **kw),
                                 3),
                library_ms=time_ms(lambda: lib_fn(x, w), 20, 3),
                timing="CUDA events over back-to-back calls")
        else:
            # a decode step's product: w cold, kernel and library alike
            n_w = max(2, int(-(-COLD_BYTES // (w.numel() * w.element_size()))))
            ring = itertools.cycle([w] + [w.clone() for _ in range(n_w - 1)])
            entry.update(
                ms=graph_ms(lambda: matmul_epilogue(x, next(ring), **kw)),
                plain_ms=time_ms(
                    lambda: matmul_epilogue_plain(x, next(ring), **kw), 3),
                library_ms=graph_ms(lambda: lib_fn(x, next(ring))),
                event_ms=time_ms(lambda: matmul_epilogue(x, next(ring), **kw),
                                 20, 3),
                library_event_ms=time_ms(lambda: lib_fn(x, next(ring)), 20,
                                         3),
                w_copies=n_w,
                timing="device time of a CUDA graph of 20 calls (kernel "
                       "and library alike), w rotated over w_copies copies "
                       "(cold); event_ms: CUDA events over back-to-back "
                       "calls, host included")
            del ring
        entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
        x32, w32 = x.float(), w.float()
        entry["fp32_body_ms"] = time_ms(
            lambda: matmul_epilogue(x32, w32, **kw), 3)
        mm[name] = entry
        del x, w, x32, w32
        torch.cuda.empty_cache()
    return {"flash_attention": flash, "tsmm_upper": tsmm, "ssd_scan": ssd,
            "matmul_epilogue": mm}


def flash_bwd_bound_ms(b, hq, hkv, s, d, causal, window, dtype) -> dict:
    """The backward's five products (S again, dP, dV, dK, dQ: 2 x D flop
    each a visible pair) at the dense peak of the type; bytes: q, k, v, o,
    dO and the lse read once, dq, dk, dv written once."""
    esize = torch.empty((), dtype=dtype).element_size()
    flops = 10.0 * d * visible_pairs(s, s, causal, window) * b * hq
    nbytes = (5 * b * hq * s * d + 2 * b * hkv * s * d) * esize \
        + 4 * b * hq * s
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flops, "bytes": nbytes}


def ssd_bwd_bound_ms(b, s, h, p, g, n, chunk, dtype) -> dict:
    """bytes: xbar, dy, B, C (by group) and log_a read once, dxbar, dB, dC
    and dlog_a written once, the final state's gradient read; flop: the
    lower-triangle pairs of each chunk for C B^T (once per group), dY
    Xbar^T, M^T dY, Wd^T C and Wd B (per head), and five products of a
    chunk's rows with a state (the two state passes, and the state terms
    of dXbar, dB and dC), at the dense peak of the type."""
    esize = torch.empty((), dtype=dtype).element_size()
    flops = 0.0
    for r0 in range(0, s, chunk):
        ln = min(chunk, s - r0)
        pairs = ln * (ln + 1)
        flops += b * g * pairs * n + b * h * (
            pairs * (2 * p + 2 * n) + 10 * ln * p * n)
    nbytes = (3 * b * s * h * p + 4 * b * s * g * n) * esize \
        + 8 * b * s * h + 4 * b * h * p * n
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flops, "bytes": nbytes}


def time_bwd_kernels(gen) -> dict:
    """The two backward kernels at their main-path shapes: kernel, plain
    version and, for flash, SDPA's backward alone (a yardstick; the port
    never calls it)."""
    out = {}
    for name, m in (("flash_attention_bwd", FLASH_MAIN),
                    ("flash_attention_bwd_d80", FLASH_D80),
                    *((f"flash_attention_bwd {a}", m)
                      for a, m in path_flash())):
        q, k, v = flash_inputs(m["b"], m["hq"], m["hkv"], m["s"], m["d"],
                               torch.bfloat16, gen, views=True)
        causal, window = m["causal"], m["window"]
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     with_lse=True)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        gqa = m["hq"] != m["hkv"]
        lib, lib_note = sdpa_call(qs, ks, vs, causal, window, gqa)
        sdpa = lib()
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            sdpa, (qs, ks, vs), do, retain_graph=True)
        kernel = lambda: flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, causal=causal, window=window)
        out[name] = {
            "ms": time_ms(kernel, 20, 3),
            "plain_ms": time_ms(lambda: by_batch(
                flash_attention_bwd_plain, q, k, v, o, lse, do,
                causal=causal, window=window), 1),
            "plain_note": "the plain version one batch row at a time",
            "library_ms": time_ms(lib_bwd, 10, 2),
            "library_note": lib_note.replace(
                "F.scaled_dot_product_attention",
                "F.scaled_dot_product_attention's backward alone "
                "(autograd.grad of its output), forward excluded", 1),
            "library_kernels_ms": device_kernel_ms(lib_bwd),
            "shape": f"q [{m['b']},{m['hq']},{m['s']},{m['d']}], k,v "
                     f"[{m['b']},{m['hkv']},{m['s']},{m['d']}] bf16 "
                     f"{'causal' if causal else 'not causal'}"
                     f"{f', window {window}' if window else ''}, transposed "
                     f"views",
            "body": flash_bwd_body(torch.bfloat16, m["d"]),
            "cuda_kernels_ms": device_kernel_ms(kernel),
            **flash_bwd_bound_ms(**m, dtype=torch.bfloat16)}
        out[name]["ratio_to_library"] = (out[name]["ms"]
                                         / out[name]["library_ms"])
        if m is FLASH_MAIN:     # the FMA body, which the fp32 steps run
            q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
            o32, lse32 = flash_attention_fwd(q32, k32, v32, causal=True,
                                             with_lse=True)
            out[name]["fp32_body_ms"] = time_ms(lambda: flash_attention_bwd(
                q32, k32, v32, o32, lse32, do32), 3)
            del q32, k32, v32, do32, o32, lse32
        del q, k, v, o, lse, do, qs, ks, vs, sdpa
        torch.cuda.empty_cache()
    for name, m in (("ssd_scan_bwd", SSD_MAIN),
                    ("ssd_scan_bwd_zamba2", SSD_ZAMBA)):
        xbar, log_a, bm, cm, _ = ssd_inputs(m["b"], m["s"], m["h"], m["p"],
                                            m["g"], m["n"], torch.bfloat16,
                                            gen, model_like=True, views=True)
        dy = torch.randn(xbar.shape, generator=gen,
                         device="cuda").to(xbar.dtype)
        args = (xbar, log_a, bm, cm, dy, None)
        out[name] = {
            "ms": time_ms(lambda: ssd_scan_bwd(*args, chunk=m["chunk"]),
                          10, 2),
            "plain_ms": time_ms(lambda: ssd_scan_bwd_plain(
                *args, chunk=m["chunk"]), 1),
            "library_ms": None,
            "library_note": "no single PyTorch call computes an SSD scan or "
                            "its gradient",
            "shape": f"xbar [{m['b']},{m['s']},{m['h']},{m['p']}] bf16, B/C "
                     f"[{m['b']},{m['s']},{m['g']},{m['n']}] views, chunk "
                     f"{m['chunk']}",
            "body": ssd_bwd_body(torch.bfloat16),
            "cuda_kernels_ms": device_kernel_ms(
                lambda: ssd_scan_bwd(*args, chunk=m["chunk"])),
            **ssd_bwd_bound_ms(**m, dtype=torch.bfloat16)}
        if m is SSD_MAIN:       # the FMA body, which the fp32 steps run
            args32 = tuple(t.float() if t is not None else None
                           for t in args)
            out[name]["fp32_body_ms"] = time_ms(lambda: ssd_scan_bwd(
                *args32, chunk=m["chunk"]), 3)
            del args32
        del xbar, log_a, bm, cm, dy, args
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# moe routing
# ---------------------------------------------------------------------------


class RoutingRecorder:
    """While active, each ``layers.moe_route`` call's expert choices
    ``gate_idx`` and drop decisions ``keep`` (``[G, Tg, k]``, on the card;
    nothing is read back until asked) are kept, in call order.  It adds no
    launch of a kernel and no copy to the host.  With ``replay`` (another
    recorder's calls) call ``i``'s top-k (``layers.stable_top_k``) returns
    the experts call ``i`` of that run chose and this run's probabilities
    at them: the same choices, hence the same queues and drops, with this
    run's own gates."""

    def __init__(self, replay=None):
        self.calls = []
        self.replay = replay
        self._real = None

    def __enter__(self):
        self._real = (model_layers.moe_route, model_layers.stable_top_k)
        route, _ = self._real

        def recorded(*args, **kwargs):
            r = route(*args, **kwargs)
            self.calls.append((r["gate_idx"].detach(), r["keep"].detach()))
            return r

        def replayed(probs, k):
            idx = self.replay[len(self.calls)][0]     # the call under way
            return torch.gather(probs, -1, idx), idx
        model_layers.moe_route = recorded
        if self.replay is not None:
            model_layers.stable_top_k = replayed
        return self

    def __exit__(self, *exc):
        model_layers.moe_route, model_layers.stable_top_k = self._real


def routed(cfg) -> bool:
    """Whether ``cfg`` has a layer of routed experts (a moe arch cut to its
    dense layers has none)."""
    return cfg.moe is not None and cfg.n_layers > cfg.moe.first_dense_layers


def routing(cfg, replay=None):
    """A :class:`RoutingRecorder` (replaying ``replay``'s choices when
    given) for a config with routed experts, else a context that records
    nothing."""
    if not routed(cfg):
        return contextlib.nullcontext()
    return RoutingRecorder(replay)


# Routing is discontinuous: one rounding of difference near a tie sends a
# token to another expert, or past its expert's capacity, and moves its
# output by O(1).  The kernel path and the plain path round at other places
# (flash's P in bf16, the head's fp32 flush), so on the moe arch they route
# some tokens apart (the moe line's ``choice_flip_share``), and the bf16
# plain path parts from fp32 by as much (an H100 read 0.35 at the 2-layer
# parity cut: tools/train_parity.py).  The moe arch's kernel path is
# therefore held to each bound with the plain path's expert choices
# replayed (``RoutingRecorder(replay=...)``): the same queues and drops, so
# the difference is the kernels' own, as on every other arch.  The
# free-running comparison is reported beside it against the same bound,
# PASS or FAIL, not raised: a FAIL there is the routing's discontinuity.
def bound_verdict(value: float, bound: float) -> str:
    return "PASS" if value <= bound else "FAIL"


def routing_flips(a: RoutingRecorder, b: RoutingRecorder) -> dict:
    """Between two runs of the same moe_route calls (the kernel path's and
    the plain path's on the same input): the share of (token, slot) expert
    choices that differ, and of keep / drop decisions that differ, over all
    the calls and per call (one a layer, and again where a checkpoint
    reruns it), and each run's share of dropped slots."""
    if len(a.calls) != len(b.calls):
        raise AssertionError(f"routing: {len(a.calls)} moe_route calls "
                             f"against {len(b.calls)}")
    slots = choice = keep = 0
    per_call = []
    for (ia, ka), (ib, kb) in zip(a.calls, b.calls):
        c = int((ia != ib).sum())
        slots += ia.numel()
        choice += c
        keep += int((ka != kb).sum())
        per_call.append(c / ia.numel())
    return {"calls": len(a.calls), "slots": slots,
            "choice_flip_share": choice / slots,
            "keep_flip_share": keep / slots,
            "choice_flip_share_by_call": per_call,
            "drop_share": [drop_share(r.calls) for r in (a, b)]}


def drop_share(calls) -> float:
    """Share of (token, slot) pairs dropped by their expert's capacity."""
    kept = sum(int(k.sum()) for _, k in calls)
    return 1.0 - kept / max(sum(k.numel() for _, k in calls), 1)


# serve
# ---------------------------------------------------------------------------


def make_requests(vocab: int, n: int = 8, max_new: int = 32,
                  lo: int = 256, hi: int = 2048) -> list:
    """``n`` requests of random tokens from the seed, prompts of ``lo`` to
    ``hi`` tokens (the first ``hi``, the last ``lo``)."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(lo, hi + 1, size=n)
    lengths[0], lengths[-1] = hi, lo
    return [Request(prompt=[int(t) for t in rng.integers(1, vocab, size=ln)],
                    max_new_tokens=max_new) for ln in lengths]


def padded_batch(reqs, device) -> torch.Tensor:
    plen = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), plen), np.int64)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = r.prompt
    return torch.from_numpy(toks).to(device)


def expected_launches(cfg, rounds: int, steps: int) -> dict:
    """Launches of each kernel that ``rounds`` admission rounds and ``steps``
    decode steps of ``cfg``'s kernel path must make.  Per round: flash once
    for each self-attention layer (or application of a shared block; an
    encoder-decoder's encoder layers and decoder layers both; none for MLA:
    :func:`_n_flash`), the SSD scan
    once for each Mamba2 layer, the epilogue kernel once for each gated
    dense MLP (:func:`_n_gate`: a moe layer's experts are plain batched
    products) and once for the head.  Per decode step: the MLP gates and
    the head (decode attention, cross-attention and the one-token SSM step
    are plain)."""
    n_attn = _n_flash(cfg)
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_gate = _n_gate(cfg)
    return {"flash_attention": n_attn * rounds, "flash_attention_bwd": 0,
            "tsmm_upper": 0, "ssd_scan": n_ssd * rounds, "ssd_scan_bwd": 0,
            "matmul_epilogue": (n_gate + 1) * (rounds + steps)}


def expected_flash_masks(cfg, expected: dict) -> dict:
    """The flash forward and backward launches of ``expected`` (a path's
    counts) split by mask, as ``ops.flash_mask_launches`` counts them: an
    encoder-decoder's encoder layers are not causal, every other
    self-attention is."""
    enc = cfg.enc_dec.n_encoder_layers if cfg.enc_dec is not None else 0
    out = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        n = expected[name]
        not_causal = n * enc // _n_attention(cfg) if n else 0
        out[name] = {"causal": n - not_causal, "not_causal": not_causal}
    return out


def expected_flash_windows(cfg, expected: dict) -> dict:
    """The flash forward and backward launches of ``expected`` split by
    window, as ``ops.flash_window_launches`` counts them (keys with no
    launch left out): a window-pattern arch's layers by their position's
    window (gemma3-12b: 5 of every 6 at ``w1024``), every other
    self-attention ``global``."""
    out = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        n = expected[name]
        pattern = cfg.window_pattern or (None,)
        counts = {}
        for w in pattern:
            key = flash_mod.window_key(w)
            counts[key] = counts.get(key, 0) + n // len(pattern)
        out[name] = {k: v for k, v in counts.items() if v}
    return out


def _n_attention(cfg) -> int:
    """Self-attention layers (an encoder-decoder's encoder and decoder
    layers), or applications of a shared block, a forward."""
    if cfg.enc_dec is not None:
        return cfg.n_layers + cfg.enc_dec.n_encoder_layers
    return {"dense": cfg.n_layers, "vlm": cfg.n_layers, "moe": cfg.n_layers,
            "hybrid": cfg.n_layers // cfg.hybrid.attn_every
            if cfg.hybrid else 0}.get(cfg.family, 0)


def _n_flash(cfg) -> int:
    """Flash launches a forward makes: one for each self-attention layer
    (:func:`_n_attention`), none for MLA, whose Dk (``qk_head_dim``)
    differs from its Dv and keeps it on dense attention, as the reference's
    dispatch does."""
    return 0 if cfg.mla is not None else _n_attention(cfg)


def _n_gate(cfg) -> int:
    """Gated MLPs a forward runs through the epilogue kernel: one for each
    self-attention layer (or application of a shared block) of a gated
    arch; of a moe arch only its dense layers' and its shared experts' (its
    routed experts are plain batched products, as the reference's; the MTP
    head's block runs without the kernels, as the reference's
    ``mtp_hidden`` calls it)."""
    if not cfg.gated_mlp:
        return 0
    if cfg.moe is not None:
        nd = cfg.moe.first_dense_layers
        return nd + ((cfg.n_layers - nd) if cfg.moe.n_shared_experts else 0)
    return _n_attention(cfg)


def expected_bodies(cfg, rounds: int, steps: int) -> dict:
    """Launches of each body of the epilogue kernel on that path (bodies
    with none left out).  bf16: a round's gates (M = requests x prompt
    length > 64) take ``wgmma``; the heads (one row a request) and a decode
    step's gates take ``small_m``.  fp32: every call takes ``fma``."""
    n_gate = _n_gate(cfg)
    if cfg.dtype == "float32":
        bodies = {"fma": (n_gate + 1) * (rounds + steps)}
    else:
        bodies = {"wgmma": n_gate * rounds,
                  "small_m": rounds + (n_gate + 1) * steps}
    return {body: n for body, n in bodies.items() if n}


def serve_run(engine: ServeEngine, reqs, frontend=None) -> dict:
    """One ``generate`` (with ``frontend``, the requests' patch or frame
    embeddings) with every kernel's count set to 0 just before it and read
    just after; each count must be the one the path must give (all 0
    without ``use_kernel``)."""
    ops.reset_launch_counts()
    for key in engine.stats:
        engine.stats[key] = 0
    t0 = time.perf_counter()
    outs = engine.generate(reqs, frontend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    masks = ops.flash_mask_launches()
    windows = ops.flash_window_launches()
    bodies = {b: n for b, n in ops.matmul_body_launches().items() if n}
    rounds, steps = (engine.stats["admission_rounds"],
                     engine.stats["decode_steps"])
    expected = expected_launches(engine.model.cfg, rounds, steps)
    expected_b = expected_bodies(engine.model.cfg, rounds, steps)
    if not engine.use_kernel:
        expected = {name: 0 for name in expected}
        expected_b = {}
    expected_m = expected_flash_masks(engine.model.cfg, expected)
    expected_w = expected_flash_windows(engine.model.cfg, expected)
    if any(len(c.tokens) != r.max_new_tokens for c, r in zip(outs, reqs)):
        raise AssertionError("a request did not complete with all its tokens")
    if launches != expected:
        raise AssertionError(f"launches {launches} in {rounds} admission "
                             f"rounds, expected {expected}")
    if bodies != expected_b:
        raise AssertionError(f"matmul_epilogue bodies {bodies} in {rounds} "
                             f"admission rounds, expected {expected_b}")
    if masks != expected_m:
        raise AssertionError(f"flash launches by mask {masks} in {rounds} "
                             f"admission rounds, expected {expected_m}")
    if windows != expected_w:
        raise AssertionError(f"flash launches by window {windows} in "
                             f"{rounds} admission rounds, expected "
                             f"{expected_w}")
    new_tokens = sum(len(c.tokens) for c in outs)
    return {"tokens": [c.tokens for c in outs], "wall_s": wall,
            "launches": launches, "flash_mask_launches": masks,
            "flash_window_launches": windows,
            "matmul_epilogue_bodies": bodies,
            "stats": dict(engine.stats),
            "prefill_s": max(c.prefill_time_s for c in outs),
            "decode_s": max(c.decode_time_s for c in outs),
            "new_tokens": new_tokens, "tokens_per_s": new_tokens / wall}


def _summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "tokens"}


def prefill_logits(model, params, toks, max_len: int, frontend=None):
    """The last-token prefill logits of the plain path (``False``), of the
    kernel path (``True``) and of the kernel path with the plain path's
    expert choices replayed (``"replayed"``; on an arch without experts the
    kernel path's own), with a moe arch's routing recorders."""
    cfg = model.cfg
    lg, recs = {}, {}
    with torch.no_grad():
        for key in [False, True] + (["replayed"] if routed(cfg) else []):
            replay = recs[False].calls if key == "replayed" else None
            with routing(cfg, replay) as recs[key]:
                lg[key], _ = model.prefill(params, toks,
                                           model.init_cache(len(toks),
                                                            max_len),
                                           frontend,
                                           use_kernel=key is not False)
    torch.cuda.synchronize()
    lg.setdefault("replayed", lg[True])
    return lg, recs


def control_logits(model, params, toks, fault, max_len: int,
                   frontend=None, replay=None) -> torch.Tensor:
    """Prefill logits of the kernel path with ``ops.matmul_epilogue`` (the
    MLP gates and the head) replaced by ``fault`` for this one call (a moe
    arch replaying the expert choices ``replay``)."""
    real = ops.matmul_epilogue
    ops.matmul_epilogue = fault
    try:
        with torch.no_grad(), routing(model.cfg, replay):
            logits, _ = model.prefill(params, toks,
                                      model.init_cache(len(toks), max_len),
                                      frontend, use_kernel=True)
        torch.cuda.synchronize()
    finally:
        ops.matmul_epilogue = real
    return logits


# Each serve path: the arch, then the bound on its bf16 prefill logits, kernel
# path against plain path at full depth (logits have a standard deviation
# near 1).  The two paths round at other places in every layer: qwen, P and
# the attention output, and the MLP gate rounded once instead of twice;
# mamba2, x * dt and the D * x residual in bf16 on the kernel path, as the
# reference's kernel wrapper does, in fp32 on the plain one; zamba2, both;
# and the epilogue kernel's head writes fp32 logits where the plain head
# rounds them to bf16 first.  Each bound is 1.5 x the largest reading of
# these sound paths on an H100 (qwen 0.104, mamba2 0.305, zamba2 0.254;
# qwen1.5-4b 0.110, stablelm-12b 0.120, qwen1.5-110b at 10 layers 0.062;
# pixtral-12b 0.125, whisper-small 0.054; gemma3-12b 0.131, its controls
# 0.219 and 0.145; phi3.5-moe at 24 layers 0.081 with the plain path's
# expert choices replayed, its controls 0.156 and 0.082, free-running 0.504:
# ``bound_verdict``'s note; deepseek-v3 at 5 layers 0.0454, replayed, its
# controls 0.281 and 0.047, free-running 0.170), rounded up to a multiple
# of 0.05.
# No such bound tells a subtle rounding fault from the sound paths' own
# rounding: the CONTROLS move the readings by less than 0.05, so
# ``check_controls`` holds them at the kernel's level.  Last,
# the depth of the fp32 comparison of greedy streams with and without the
# kernels: 4 layers, for zamba2 12, the least depth with two applications
# of shared blocks (attn_every 6), and for qwen1.5-110b 2 (its fp32 weights
# are 5.4 GB a layer and 10 GB the embedding and head), and for gemma3-12b 6,
# one whole cycle of its window pattern (five local layers and a global
# one; prompts past its 1024-slot rings), and for phi3.5-moe 4 (5.2 GB of
# fp32 weights a layer), and for deepseek-v3 3, its dense layers (one moe
# layer of 256 experts is 45 GB in fp32).
SERVE_PATHS = [("qwen1.5-0.5b", 0.2, 4), ("mamba2-1.3b", 0.5, 4),
               ("zamba2-2.7b", 0.4, 12), ("qwen1.5-4b", 0.2, 4),
               ("stablelm-12b", 0.2, 4), ("qwen1.5-110b", 0.1, 2),
               ("pixtral-12b", 0.2, 4), ("whisper-small", 0.1, 12),
               ("gemma3-12b", 0.2, 6), (PHI, 0.15, 4), (DEEPSEEK, 0.1, 3)]
# Prompt lengths and cache length of each serve path: 256-2048 tokens in a
# 4096-slot cache (pixtral's 1024 patches, prepended, fit beside them;
# gemma3-12b's local layers keep rings of 1024 slots, which most prompts
# overrun);
# whisper's decoder at its published context of 448 tokens, prompts of
# 32-416 and 32 new tokens (its 1500 frames live in the cross cache)
SERVE_SHAPE = dict(lo=256, hi=2048, max_len=4096)
SERVE_SHAPES = {"whisper-small": dict(lo=32, hi=WHISPER_CTX - 32,
                                      max_len=WHISPER_CTX)}

# Cuts of the paths that do not fit one H100's 80 GB at full size (bf16,
# B 8 x S 2048), each with its reason and measured peak: ``n_layers``, and
# for a moe arch its dense layers first (``first_dense_layers``) and its
# routed experts (``n_experts``; top-k kept), and the requests of a serve
# round or the rows of a train batch (``batch``).  Every other path runs at
# full width and depth; widths, heads, the MLA ranks, d_ff, top-k, the
# capacity factor and every other field stay.  Each phase's line prints its
# cut (:func:`depth_cut`).
DEPTH_CUTS = {
    (PHI, "serve"): dict(
        n_layers=24, reason="2.60 GB of bf16 weights a layer (the 16 "
        "experts 16 x 3 x 4096 x 6400), 0.53 GB the embedding and head; "
        "beside them the serve phase holds the plain path's prefill, whose "
        "fp32 scores at 32 heads x 2048 x 2048 take 4.3 GB a tensor, and a "
        "layer's MoE transients (the fp32 dispatch and combine [4, 4096, "
        "16, 640] 671 MB each): 24 layers peak at 81.0 GB (H100 80GB HBM3, "
        "700 W)"),
    (PHI, "train"): dict(
        n_layers=2, reason="weights, gradients and the fp32 AdamW moments "
        "take 12 bytes a parameter (15.6 GB a layer), and AdamW's fp32 "
        "temporaries of a stacked expert leaf (0.42B parameters a layer) "
        "come on top: 3 layers run out of memory at 80.2 GB allocating one "
        "(4.69 GiB), 4 at 79.1 GB, 2 peak at 57.9 GB (tools/train_depth.py; "
        "H100 80GB HBM3, 700 W)"),
    (DEEPSEEK, "serve"): dict(
        n_layers=5, reason="the 3 dense layers and 2 of the 58 moe layers, "
        "all 256 experts: 23.0 GB of bf16 weights a moe layer, 1.17 GB a "
        "dense layer, 3.7 GB the embedding and head, 1.4 GB the MTP head; "
        "beside them the plain path's prefill holds one fp32 score tensor "
        "of 128 heads x 2048 x 2048, 17.2 GB (in place under no_grad), and "
        "a moe layer's fp32 dispatch and combine [4, 4096, 256, 160] take "
        "2.7 GB each: 5 layers peak at 81.0 GB (tools/serve_depth.py; H100 "
        "80GB HBM3, 700 W)"),
    (DEEPSEEK, "train"): dict(
        n_layers=2, first_dense_layers=1, n_experts=16, batch=1,
        reason="one dense and one moe layer, as .reduced() cuts "
        "first_dense_layers, and 16 of the 256 routed experts (top-8 "
        "kept): one moe layer with all 256 holds 11.3B parameters, 135 GB "
        "of weights, gradients and fp32 AdamW moments; at 16 the tree with "
        "the MTP head is 4.06B parameters, 49 GB at 12 bytes a parameter; "
        "B 1: the plain dense attention's fp32 scores take 2.1 GB a "
        "sequence at 128 heads x 2048 x 2048, and the MTP block keeps them "
        "for its backward: B 2 ran out of memory in the donated step's "
        "backward at 83.3 GB, allocating 4 GiB; B 1 peaks at 74.7 GB "
        "(tools/train_depth.py; H100 80GB HBM3, 700 W)"),
    ("gemma3-12b", "train"): dict(
        n_layers=6, reason="weights, gradients and the fp32 AdamW moments "
        "take 12 bytes a parameter (2.69 GB a layer, 24.2 GB the embedding "
        "and head), AdamW's fp32 temporaries of the embedding and the head "
        "(1.0B parameters each) and a cycle's recomputed activations come "
        "on top: 6 layers peak at 69.0 GB, 12 (two cycles) run out of "
        "memory at 80.7 GB (tools/train_depth.py; H100 80GB HBM3, 700 W)"),
    ("qwen1.5-110b", "serve"): dict(
        n_layers=10, reason="2.72 GB of bf16 weights a layer; beside them "
        "the serve phase holds the plain path's prefill (the logits it "
        "compares with), whose fp32 scores at 64 heads x 2048 x 2048 take "
        "8.6 GB a tensor"),
    ("stablelm-12b", "train"): dict(
        n_layers=12, reason="weights, gradients and the fp32 AdamW moments "
        "take 12 bytes a parameter (3.3 GB a layer, 12.3 GB the embedding "
        "and head), and AdamW's fp32 temporaries of the stacked MLP leaves "
        "(about 17 GB at 12 layers) and the saved activations come on "
        "top"),
    ("qwen1.5-110b", "train"): dict(
        n_layers=1, reason="16.3 GB of weights, gradients and fp32 moments "
        "a layer, 29.9 GB the embedding and head, and AdamW's fp32 "
        "temporaries of the embedding or the head (1.25B parameters: about "
        "25 GB)"),
    ("pixtral-12b", "train"): dict(
        n_layers=12, reason="weights, gradients and the fp32 AdamW moments "
        "take 12 bytes a parameter (3.27 GB a layer, 16.1 GB the embedding "
        "and head), AdamW's fp32 temporaries of the stacked MLP leaves and "
        "the activations saved over 1024 patches + 2048 tokens come on "
        "top: 12 layers peak at 80.2 GB (74.7 GiB of the card's 79.2), 13 "
        "run out of memory in AdamW's update (H100 80GB HBM3, 700 W)"),
}
SERVE_BATCH = 8


def path_config(arch: str, phase: str):
    """``arch``'s config as the ``phase`` ("serve" or "train") runs it: at
    full size, or cut as :data:`DEPTH_CUTS` says (layers; a moe arch's
    dense layers and routed experts)."""
    cfg = get_config(arch)
    cut = DEPTH_CUTS.get((arch, phase), {})
    if "n_layers" in cut:
        cfg = dataclasses.replace(cfg, n_layers=cut["n_layers"])
    moe = {k: cut[k] for k in ("first_dense_layers", "n_experts")
           if k in cut}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def path_batch(arch: str, phase: str) -> int:
    """Requests of a serve round or rows of a train batch of that path."""
    full = SERVE_BATCH if phase == "serve" else TRAIN_BATCH
    return DEPTH_CUTS.get((arch, phase), {}).get("batch", full)


def depth_cut(arch: str, phase: str):
    """The cut of that path, as its phase line prints it (each field beside
    its full value, then the reason), or None."""
    cut = DEPTH_CUTS.get((arch, phase))
    if cut is None:
        return None
    cfg = get_config(arch)
    full = {"n_layers": cfg.n_layers,
            "batch": SERVE_BATCH if phase == "serve" else TRAIN_BATCH}
    out = {}
    for key, value in cut.items():
        if key != "reason":
            out[key] = value
            out[f"{key}_full"] = full[key] if key in full else getattr(
                cfg.moe, key)
    out["reason"] = cut["reason"]
    return out


def frontend_embeddings(cfg, batch: int, dtype=None):
    """Random patch or frame embeddings ``[batch, F, d]`` from the seed on
    the card, in ``dtype`` (default the model's), or None for an arch
    without a frontend."""
    if cfg.frontend == "none" or not cfg.frontend_seq:
        return None
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return torch.randn((batch, cfg.frontend_seq, cfg.d_model), generator=gen,
                       device="cuda").to(dtype or getattr(torch, cfg.dtype))


def single_admission(model, params, reqs, frontend, max_len: int) -> dict:
    """Continuous batching with 4 slots and a frontend, as the reference
    allows it: the first admission round takes the embeddings of the first
    4 requests; a later round must raise the reference's
    ``NotImplementedError`` (frontend features are single-admission only).
    The requests' lengths are staggered (8 to 32 new tokens) so that a lane
    frees while the others still decode, which makes the second round."""
    engine = ServeEngine(model, params, EngineConfig(
        max_len=max_len, batching="continuous", slots=4))
    for i, r in enumerate(reqs):
        engine.submit(dataclasses.replace(r, max_new_tokens=8 + 8 * (i % 4)))
    try:
        for _ in range(sum(r.max_new_tokens for r in reqs)):
            engine.step(frontend[:4])
    except NotImplementedError as err:
        if engine.stats["admission_rounds"] != 1:
            raise AssertionError(f"the raise came after "
                                 f"{engine.stats['admission_rounds']} "
                                 f"admission rounds, not 1") from err
        return {"slots": 4, "raised": f"NotImplementedError: {err}",
                "admission_rounds": 1,
                "decode_steps": engine.stats["decode_steps"]}
    raise AssertionError("continuous batching with a frontend made a second "
                         "admission round without raising")


def phase_serve(arch: str, bf16_tol: float, fp32_layers: int) -> dict:
    """``arch`` at full width and depth, or its :data:`DEPTH_CUTS` (bf16,
    random weights from the seed) through ServeEngine, static twice and
    continuous with 4 slots (with a frontend: the second admission must
    raise), with the launches of every kernel; then its prefill logits and,
    at ``fp32_layers`` layers in fp32, its greedy streams with the kernels
    against without them.  A frontend arch gets random embeddings from the
    seed in the model's type (bf16, so that the bf16 bodies run; fp32 for
    the fp32 model)."""
    cfg = path_config(arch, "serve")
    shape = SERVE_SHAPES.get(arch, SERVE_SHAPE)
    n_req = path_batch(arch, "serve")
    reqs = make_requests(cfg.vocab_size, n_req, lo=shape["lo"],
                         hi=shape["hi"])
    max_len = shape["max_len"]
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(SEED)
    n_params = sum(t.numel() for t in _leaves(params))
    fe = frontend_embeddings(cfg, len(reqs))

    static = ServeEngine(model, params, EngineConfig(max_len=max_len))
    with routing(cfg) as rec_run1:
        run1 = serve_run(static, reqs, fe)
    main_launches = run1["launches"]                  # the main path's count
    run2 = serve_run(static, reqs, fe)
    if run1["tokens"] != run2["tokens"]:
        raise AssertionError("two generate runs gave different tokens")
    if fe is None:
        continuous = _summary(serve_run(ServeEngine(
            model, params, EngineConfig(max_len=max_len,
                                        batching="continuous", slots=4)),
            reqs))
        if continuous["stats"]["admission_rounds"] < 2:
            raise AssertionError("continuous batching made no refill round")
    else:
        continuous = single_admission(model, params, reqs, fe, max_len)

    # prefill logits with the kernels against without, bf16, full depth
    toks = padded_batch(reqs, model.device)
    lg, recs = prefill_logits(model, params, toks, max_len, fe)
    lg_k, lg_p = lg["replayed"], lg[False]
    if routed(cfg):
        decode = [c for c in rec_run1.calls if c[0].shape[:2] == (1, n_req)]
        prefill = [c for c in rec_run1.calls
                   if c[0].shape[:2] != (1, n_req)]
        moe = {"phase": "moe", "path": "serve", "arch": cfg.name,
               "n_layers": cfg.n_layers,
               "capacity_factor": cfg.moe.capacity_factor,
               "prefill_kernel_vs_plain": routing_flips(recs[True],
                                                        recs[False]),
               "static_run": {
                   "prefill_calls": len(prefill),
                   "prefill_drop_share": drop_share(prefill),
                   "decode_calls": len(decode),
                   "decode_tokens_a_group": n_req,
                   "decode_capacity": max(int(
                       cfg.moe.capacity_factor * cfg.moe.top_k * n_req
                       / cfg.moe.n_experts), 1),
                   "decode_drop_share": drop_share(decode)}}
        moe["prefill_kernel_vs_plain"].pop("choice_flip_share_by_call")
        free = float((lg[True] - lg_p).abs().max())
        moe["bf16_prefill_logits"] = {
            "free_running_max_abs_diff": free, "bound": bf16_tol,
            "verdict": bound_verdict(free, bf16_tol),
            "replayed_max_abs_diff": float((lg_k - lg_p).abs().max())}
        emit(moe)            # before the bound is checked: a miss shows why
    # the plain path's expert choices, which the controls replay
    replay = recs[False].calls if routed(cfg) else None
    del recs, rec_run1, lg
    if lg_k.shape != (n_req, cfg.vocab_size) or not bool(
            torch.isfinite(lg_k).all()):
        raise AssertionError("prefill logits: wrong shape or non-finite")
    bf16_err = float((lg_k - lg_p).abs().max())
    if bf16_err > bf16_tol:
        raise AssertionError(f"bf16 prefill logits differ by {bf16_err}")
    logit_std = float(lg_p.std())
    peak_bytes = torch.cuda.max_memory_allocated()
    controls = {name: float((control_logits(
        model, params, toks, fault, max_len, fe, replay) - lg_p).abs().max())
        for name, fault in CONTROLS.items()}
    del replay
    del params, static, lg_k, lg_p
    torch.cuda.empty_cache()

    # fp32, fewer layers, full width: greedy streams with and without kernels
    cfg_s = dataclasses.replace(cfg, n_layers=fp32_layers, dtype="float32")
    model_s = build_model(cfg_s)
    params_s = model_s.init(SEED)
    fe32 = fe.float() if fe is not None else None
    with_k = serve_run(ServeEngine(model_s, params_s,
                                   EngineConfig(max_len=max_len),
                                   use_kernel=True), reqs, fe32)
    without = serve_run(ServeEngine(model_s, params_s,
                                    EngineConfig(max_len=max_len),
                                    use_kernel=False), reqs, fe32)
    if with_k["tokens"] != without["tokens"]:
        raise AssertionError("fp32 greedy streams with and without the "
                             "kernels differ")
    ls, recs = prefill_logits(model_s, params_s, toks, max_len, fe32)
    fp32_err = float((ls["replayed"] - ls[False]).abs().max())
    fp32_free = None
    if routed(cfg_s):
        free = float((ls[True] - ls[False]).abs().max())
        fp32_free = {"free_running_max_abs_diff": free, "bound": 1e-3,
                     "verdict": bound_verdict(free, 1e-3),
                     "routing": routing_flips(recs[True], recs[False])}
        fp32_free["routing"].pop("choice_flip_share_by_call")
        emit({"phase": "moe", "path": "serve fp32", "arch": cfg.name,
              "n_layers": fp32_layers, "fp32_prefill_logits": fp32_free})
    del ls, recs
    if fp32_err > 1e-3:       # fp32 sums in another order, a few layers
        raise AssertionError(f"fp32 prefill logits differ by {fp32_err}")
    del params_s
    torch.cuda.empty_cache()
    prefill_positions = max(len(r.prompt) for r in reqs)
    if fe is not None and cfg.enc_dec is None:
        prefill_positions += fe.shape[1]           # the prepended patches
    return {"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "depth_cut": depth_cut(arch, "serve"),
            "n_params": n_params,
            "frontend": None if fe is None else {
                "shape": list(fe.shape),
                "dtype": str(fe.dtype).split(".")[-1],
                "note": "random embeddings from the seed in the model's "
                        "type, so that the bf16 bodies run"},
            "prompt_lens": [len(r.prompt) for r in reqs],
            "prefill_positions": prefill_positions,
            "max_len": max_len,
            "main_path_launches": main_launches,
            "main_path_flash_mask_launches": run1["flash_mask_launches"],
            "main_path_flash_window_launches": run1["flash_window_launches"],
            "main_path_matmul_epilogue_bodies": run1["matmul_epilogue_bodies"],
            "static": _summary(run1), "static_again": _summary(run2),
            "continuous_slots4": continuous,
            "bf16_prefill_logits_max_abs_diff": bf16_err,
            "bf16_prefill_logits_tol": bf16_tol,
            "bf16_prefill_logits_std": logit_std,
            "bf16_prefill_logits_max_abs_diff_of_controls": controls,
            "fp32_layers": fp32_layers,
            "fp32_streams_identical": True,
            "fp32_prefill_logits_max_abs_diff": fp32_err,
            "prefill_logits_routing_replayed": routed(cfg),
            "fp32_with_kernels": _summary(with_k),
            "fp32_without_kernels": _summary(without),
            "max_memory_allocated_bytes": peak_bytes}


def _named_leaves(tree, prefix=""):
    """(dotted path, tensor) of each leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _leaves(tree):
    return (leaf for _, leaf in _named_leaves(tree))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

# Each train path: the arch, its remat policy (qwen keeps every activation;
# mamba2 without remat would keep about 72 GB, so it recomputes each layer,
# and so does zamba2, each Mamba2 layer and each application of a shared
# block), and the coarse bound on the bf16 gradients, kernel path against
# plain path at the depth of parity_config (each leaf's largest error over
# its largest magnitude; gross faults only: the two paths round at other
# places, as the serve paths' bf16 logits do).  Each bound is 1.5 x the
# largest reading of the sound qwen and mamba2 paths on an H100 (0.0113,
# 0.0114), rounded up to a multiple of 0.05, as the serve paths' bounds
# are; zamba2 takes the same bound (it read 0.0197 there).  The fp32
# gradients of the same comparison are held to TRAIN_FP32_BOUND: both paths
# multiply in fp32 and differ in the order of sums (the H100 read 1.5e-6,
# 8.4e-5 and 1.2e-4).  The moe arch's kernel path is held to both with the
# plain path's expert choices replayed (``bound_verdict``'s note; free
# running, an H100 read 0.40 in bf16, where the plain path itself parts
# from fp32 by 0.35: tools/train_parity.py).
TRAIN_PATHS = [("qwen1.5-0.5b", "none", 0.05), ("mamba2-1.3b", "full", 0.05),
               ("zamba2-2.7b", "full", 0.05), ("qwen1.5-4b", "full", 0.05),
               ("stablelm-12b", "full", 0.05), ("qwen1.5-110b", "full", 0.05),
               ("pixtral-12b", "full", 0.05), ("whisper-small", "none", 0.05),
               ("gemma3-12b", "full", 0.05), (PHI, "full", 0.05),
               (DEEPSEEK, "full", 0.05)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 5
# tokens a row where an arch's own context is shorter than TRAIN_SEQ
TRAIN_SEQS = {"whisper-small": WHISPER_CTX}
# Leaves whose gradient is zero in exact arithmetic: the cross-attention's
# key bias shifts every score of a query row alike, which its softmax
# ignores, so both paths hold rounding only.  Such a leaf is not required
# to have a nonzero gradient, and its parity error is taken over the
# tree's largest gradient instead of its own.
ZERO_GRAD_LEAVES = ("cross.b_k",)
TRAIN_FP32_BOUND = 1e-3
PARITY_BATCH, PARITY_SEQ = 2, 1024
# a window-pattern arch's parity cut runs past its window (1024 for gemma:
# at 1024 positions the window would mask nothing)
PARITY_SEQ_WINDOWED = 2048


def parity_seq(cfg) -> int:
    """Tokens a row of the parity and fp32 determinism batches."""
    return PARITY_SEQ_WINDOWED if cfg.window_pattern else PARITY_SEQ


def parity_config(cfg, dtype: str):
    """The gradient-parity model: ``cfg`` at full width, in ``dtype``, cut
    to 2 layers (or fewer, if ``cfg`` has fewer; an encoder-decoder's
    encoder too).  The hybrid keeps as many Mamba2 layers as it has shared
    blocks, each followed by one (``attn_every`` 1), so that each shared
    block, and the flash backward at its head dim, is applied once at the
    depth the bf16 bound was set at.  At zamba2's own ``attn_every`` (6)
    that takes 12 layers, where bf16 rounding alone parts the two paths by
    more (an H100 read 0.054-0.058 for zamba2 and 0.046 for mamba2 at 12
    layers, each path as near the fp32 gradients as the other:
    ``tools/train_parity.py``).  A window-pattern arch keeps one local
    layer and one global one (pattern ``(local_window, None)``), run over
    :func:`parity_seq` positions.  A moe arch keeps at most one dense layer
    first, so that the cut has a moe layer (deepseek-v3's 3 dense layers
    would fill it), and at most its train cut's routed experts."""
    if cfg.window_pattern is not None:
        # one local layer and one global, both through the flash backward
        return dataclasses.replace(cfg, n_layers=2, dtype=dtype,
                                   window_pattern=(cfg.local_window, None))
    if cfg.enc_dec is not None:
        return dataclasses.replace(
            cfg, n_layers=min(2, cfg.n_layers), dtype=dtype,
            enc_dec=dataclasses.replace(
                cfg.enc_dec,
                n_encoder_layers=min(2, cfg.enc_dec.n_encoder_layers)))
    if cfg.moe is not None:
        experts = DEPTH_CUTS.get((cfg.name, "train"), {}).get(
            "n_experts", cfg.moe.n_experts)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            n_experts=min(cfg.moe.n_experts, experts)))
    if cfg.family != "hybrid":
        return dataclasses.replace(cfg, n_layers=min(2, cfg.n_layers),
                                   dtype=dtype)
    n = cfg.hybrid.n_shared_attn_blocks
    return dataclasses.replace(
        cfg, n_layers=n, dtype=dtype,
        hybrid=dataclasses.replace(cfg.hybrid, attn_every=1))


def ce_chunks(batch: int, seq: int, ce_chunk: int = 2048) -> int:
    """Chunks of the CE head a loss makes (``transformer._chunked_ce``'s
    rule on the S - 1 predicted positions)."""
    s = seq - 1
    c = max(min(ce_chunk // max(batch, 1), s), 1)
    return -(-s // c)


def expected_train_launches(cfg, remat: str, batch: int, seq: int,
                            steps: int) -> dict:
    """Launches of each kernel that ``steps`` train steps of ``cfg``'s
    kernel path must make.  A step: each attention layer's flash forward
    and backward, each Mamba2 layer's SSD scan forward and backward, each
    gated dense MLP's gate (:func:`_n_gate`; forward, and again in its
    backward to recompute the pre-activation) and each CE chunk's head
    through the epilogue kernel, and with an MTP head each chunk of its CE
    (over S - 2 positions) too.
    A forward that a checkpoint reruns in the backward launches again:
    every layer's under remat ``full`` or ``selective``, and every CE
    chunk's head (each chunk is checkpointed)."""
    again = 2 if remat in ("full", "selective") else 1
    n_attn = _n_flash(cfg)
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_gate = _n_gate(cfg)
    heads = ce_chunks(batch, seq) + (ce_chunks(batch, seq - 1)
                                     if cfg.mtp_depth else 0)
    per_step = {"flash_attention": n_attn * again,
                "flash_attention_bwd": n_attn, "tsmm_upper": 0,
                "ssd_scan": n_ssd * again, "ssd_scan_bwd": n_ssd,
                "matmul_epilogue": n_gate * (again + 1) + 2 * heads}
    return {k: v * steps for k, v in per_step.items()}


def random_batch(vocab: int, batch: int, seq: int, cfg=None) -> dict:
    """Random tokens from the seed on the card, and for an arch ``cfg``
    with a frontend its embeddings (:func:`frontend_embeddings`)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"tokens": torch.randint(0, vocab, (batch, seq), generator=gen,
                                   device="cuda")}
    fe = frontend_embeddings(cfg, batch) if cfg is not None else None
    if fe is not None:
        out["frontend"] = fe
    return out


def zero_grad_leaf(name: str) -> bool:
    return name.endswith(ZERO_GRAD_LEAVES)


def grad_parity(cfg, remat: str, dtype: str) -> dict:
    """The gradients of the kernel path against the plain path, at full
    width and the depth of :func:`parity_config`, on one batch: each leaf's
    largest error over its largest magnitude (a :data:`ZERO_GRAD_LEAVES`
    leaf's over the tree's largest gradient).  A moe arch's kernel path
    replays the plain path's expert choices (:func:`bound_verdict`'s
    note); its free-running gradients are compared too
    (``free_running``), with the routing flips between the two paths."""
    cfg_s = parity_config(cfg, dtype)
    model = build_model(cfg_s)
    params = model.init(SEED)
    batch = random_batch(cfg.vocab_size, PARITY_BATCH, parity_seq(cfg),
                         cfg_s)
    moe = routed(cfg_s)
    recs, rels = {}, {}
    plain = tree_top = None
    # the plain path's gradients are kept; each kernel run's are compared
    # with them and dropped (a moe arch's parity cut holds 16 GB of fp32
    # gradients a run)
    for key in [False, True] + (["replayed"] if moe else []):
        replay = recs[False].calls if key == "replayed" else None
        with routing(cfg_s, replay) as recs[key]:
            _, _, grads = value_and_grad(model, params, batch, remat=remat,
                                         use_kernel=key is not False)
        grads = dict(_named_leaves(grads))
        if key is False:
            plain = grads
            tree_top = max(float(g.float().abs().max())
                           for g in plain.values() if g is not None)
            continue
        rel = {}
        for name, gk in grads.items():
            gp = plain[name]
            if gk is None or gp is None or not bool(
                    torch.isfinite(gk).all()):
                raise AssertionError(f"gradient parity: leaf {name} has no "
                                     f"finite gradient")
            top = tree_top if zero_grad_leaf(name) else float(
                gp.float().abs().max())
            rel[name] = float((gk.float() - gp.float()).abs().max()) / max(
                top, 1e-30)
        rels[key] = rel
        del grads
    rel = rels["replayed" if moe else True]
    worst = max(rel, key=rel.get)
    free = None
    if moe:
        free_rel = rels[True]
        free_worst = max(free_rel, key=free_rel.get)
        free = {"max_rel_err": free_rel[free_worst],
                "worst_leaf": free_worst,
                "routing": routing_flips(recs[True], recs[False])}
    del params, plain, recs
    torch.cuda.empty_cache()
    return {"dtype": dtype, "layers": cfg_s.n_layers,
            "attn_every": cfg_s.hybrid.attn_every if cfg_s.hybrid else None,
            "batch": [PARITY_BATCH, parity_seq(cfg)],
            "routing_replayed": moe,
            "max_rel_err": rel[worst], "worst_leaf": worst,
            "rel_err_by_leaf": rel, "free_running": free}


def grads_bit_identical(model, params, batch, remat: str) -> dict:
    """One step's loss and gradients of the kernel path, twice from the same
    weights and batch: whether the loss and every gradient leaf are
    bit-identical (``torch.equal``), and where they are not, how far apart
    (each leaf's largest difference over its largest magnitude)."""
    runs = [value_and_grad(model, params, batch, remat=remat,
                           use_kernel=True) for _ in range(2)]
    (loss1, _, g1), (loss2, _, g2) = runs
    leaves2 = dict(_named_leaves(g2))
    differ = {}
    for name, a in _named_leaves(g1):
        b = leaves2[name]
        if not torch.equal(a, b):
            differ[name] = float((a.float() - b.float()).abs().max()) / max(
                float(a.float().abs().max()), 1e-30)
    del runs, g1, g2, leaves2
    torch.cuda.empty_cache()
    worst = max(differ, key=differ.get) if differ else None
    return {"bit_identical": torch.equal(loss1, loss2) and not differ,
            "losses": [float(loss1), float(loss2)],
            "leaves_differing": len(differ),
            "max_rel_diff": differ[worst] if worst else 0.0,
            "worst_leaf": worst}


def determinism(cfg, remat: str, model, params, batch) -> dict:
    """:func:`grads_bit_identical` at full width (the train path's own model,
    bf16) and at :func:`parity_config`'s cut in fp32, where the FMA
    backward bodies run (each sums in a fixed order, as the bf16 ones do)."""
    out = {"bf16": grads_bit_identical(model, params, batch, remat)}
    cfg_s = parity_config(cfg, "float32")
    model_s = build_model(cfg_s)
    params_s = model_s.init(SEED)
    out["fp32"] = grads_bit_identical(
        model_s, params_s, random_batch(cfg.vocab_size, PARITY_BATCH,
                                        parity_seq(cfg), cfg_s), remat)
    out["fp32"]["layers"] = cfg_s.n_layers
    del params_s
    torch.cuda.empty_cache()
    return out


def phase_train(arch: str, remat: str, bf16_bound: float) -> dict:
    """``arch`` at full width and depth, or its :data:`DEPTH_CUTS`, bf16,
    random weights from the seed, through ``make_train_step(use_kernel=
    True)`` with the reference's AdamW defaults: first :func:`determinism`,
    then TRAIN_STEPS steps on one repeated batch of random tokens (one
    cold, then warm), each timed by CUDA events, with every kernel's
    launches counted over them; then the gradient parity of the kernel path
    against the plain one, in fp32 and in bf16."""
    cfg = path_config(arch, "train")
    seq = TRAIN_SEQS.get(arch, TRAIN_SEQ)
    rows = path_batch(arch, "train")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(SEED)
    plan = ShardingPlan(name="dp", remat=remat)
    opt_cfg = adamw.AdamWConfig()
    batch = random_batch(cfg.vocab_size, rows, seq, cfg)
    fe = batch.get("frontend")
    # the positions the trunk runs: a vision stub's patches come first
    positions = seq + (fe.shape[1] if fe is not None
                       and cfg.enc_dec is None else 0)
    fe = None if fe is None else list(fe.shape)

    # every leaf gets a gradient, none all zero (but the leaves whose
    # gradient is zero in exact arithmetic): a cut graph shows here
    with routing(cfg) as rec:
        _, _, grads = value_and_grad(model, params, batch, remat=remat,
                                     use_kernel=True)
    moe_drop = drop_share(rec.calls) if routed(cfg) else None
    del rec
    dead = [name for name, g in _named_leaves(grads)
            if g is None or not (zero_grad_leaf(name)
                                 or bool((g != 0).any()))]
    if dead:
        raise AssertionError(f"{arch}: leaves without a gradient: {dead}")
    n_leaves = sum(1 for _ in _leaves(grads))
    del grads
    torch.cuda.empty_cache()
    repro = determinism(cfg, remat, model, params, batch)

    # the weights and moments donated to the step, as the reference's
    # trainer donates them: one copy of each, updated in place
    step = make_train_step(model, opt_cfg, plan, use_kernel=True,
                           donate=True)
    opt = adamw.init(opt_cfg, params)
    ef = None                                # compress_scheme "none"
    losses, norms, times = [], [], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, ef, metrics = step(params, opt, ef, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = ops.launch_counts()
    masks = ops.flash_mask_launches()
    windows = ops.flash_window_launches()
    bodies = {b: n for b, n in ops.matmul_body_launches().items() if n}
    peak = torch.cuda.max_memory_allocated()
    expected = expected_train_launches(cfg, remat, rows, seq, TRAIN_STEPS)
    expected_m = expected_flash_masks(cfg, expected)
    expected_w = expected_flash_windows(cfg, expected)
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{arch}: non-finite loss or grad norm: "
                             f"{losses}, {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall on a repeated "
                             f"batch: {losses}")
    if launches != expected:
        raise AssertionError(f"{arch}: launches {launches} in "
                             f"{TRAIN_STEPS} train steps, expected "
                             f"{expected}")
    if masks != expected_m:
        raise AssertionError(f"{arch}: flash launches by mask {masks} in "
                             f"{TRAIN_STEPS} train steps, expected "
                             f"{expected_m}")
    if windows != expected_w:
        raise AssertionError(f"{arch}: flash launches by window {windows} "
                             f"in {TRAIN_STEPS} train steps, expected "
                             f"{expected_w}")
    n_params = sum(t.numel() for t in _leaves(params))
    del params, opt, batch, step
    torch.cuda.empty_cache()

    parity = {"fp32": grad_parity(cfg, remat, "float32"),
              "bf16": grad_parity(cfg, remat, "bfloat16")}
    if routed(cfg):
        free = {dtype: parity[dtype].pop("free_running")
                for dtype in ("fp32", "bf16")}
        for dtype, bound in (("fp32", TRAIN_FP32_BOUND),
                             ("bf16", bf16_bound)):
            free[dtype]["bound"] = bound
            free[dtype]["verdict"] = bound_verdict(
                free[dtype]["max_rel_err"], bound)
            free[dtype]["replayed_max_rel_err"] = parity[dtype][
                "max_rel_err"]
        emit({"phase": "moe", "path": "train", "arch": arch,
              "n_layers": cfg.n_layers,
              "capacity_factor": cfg.moe.capacity_factor,
              "drop_share": moe_drop,
              "drop_share_note": f"the kernel path's first step at the "
                                 f"path's cut, B {rows} x S {seq} (groups "
                                 f"of {min(4096, rows * seq)} tokens), its "
                                 f"checkpoints' reruns counted again",
              "parity_free_running": free})
    for p in parity.values():
        p.pop("free_running", None)
    if not parity["fp32"]["max_rel_err"] <= TRAIN_FP32_BOUND:
        raise AssertionError(f"{arch}: fp32 gradients of the kernel path "
                             f"off by {parity['fp32']['max_rel_err']}")
    if not parity["bf16"]["max_rel_err"] <= bf16_bound:
        raise AssertionError(f"{arch}: bf16 gradients of the kernel path "
                             f"off by {parity['bf16']['max_rel_err']} at "
                             f"{parity['bf16']['worst_leaf']}")
    for p in parity.values():
        p["rel_err_by_leaf"] = {k: v for k, v in sorted(
            p["rel_err_by_leaf"].items(), key=lambda kv: -kv[1])[:5]}
    return {"phase": "train", "arch": arch, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "depth_cut": depth_cut(arch, "train"),
            "n_params": n_params,
            "n_leaves": n_leaves, "batch": rows, "seq_len": seq,
            "frontend": fe, "positions": positions,
            "remat": remat, "optimizer": dataclasses.asdict(opt_cfg),
            "losses": losses, "grad_norms": norms, "step_ms": times,
            "warm_median_step_ms": float(np.median(times[1:])),
            "launches": launches, "expected_launches": expected,
            "flash_mask_launches": masks,
            "flash_window_launches": windows,
            "matmul_epilogue_bodies": bodies,
            "max_memory_allocated_bytes": peak,
            "gradient_parity": parity,
            "fp32_bound": TRAIN_FP32_BOUND, "bf16_bound": bf16_bound,
            "determinism": repro}


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

# The checkpoint phase's path: qwen1.5-0.5b at its parity cut (2 layers,
# full width, bf16), written into the build directory, which .gitignore
# lists, and removed afterwards
CKPT_ARCH = "qwen1.5-0.5b"
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"


def _timed_step(step, params, opt, batch):
    """One train step, timed by CUDA events: (params, opt, loss, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    params, opt, _, metrics = step(params, opt, None, batch)
    end.record()
    torch.cuda.synchronize()
    return params, opt, metrics["loss"], start.elapsed_time(end)


def _state(params, opt) -> dict:
    """The weights and the AdamW moments as one tree of dicts."""
    return {"params": params, "m": opt.m, "v": opt.v}


def _differing_leaves(a: dict, b: dict) -> list:
    """The names of the leaves of two trees of one structure that differ
    in type or in any bit."""
    lb = dict(_named_leaves(b))
    return [name for name, t in _named_leaves(a)
            if not (t.dtype == lb[name].dtype and torch.equal(t, lb[name]))]


def phase_checkpoint() -> dict:
    """The data pipeline and the checkpoint store on the card: batches of
    the port's ``make_pipeline`` (seed 0, B 8 x S 2048, prefetched onto the
    card; held equal to ``SyntheticLM``'s arrays), two donated train steps
    of :data:`CKPT_ARCH`, then ``AsyncCheckpointer.save`` of the weights and
    the AdamW state while step 3 runs (the snapshot is taken before it
    returns; the step updates the same tensors in place); ``restore`` into a
    fresh tree, every leaf ``torch.equal`` to the state saved; step 3 again
    from the restored state, bit-identical to step 3 from the live state.
    Reports the checkpoint's bytes, the snapshot, write and restore
    seconds, and step 3's time with the write in flight and without it."""
    t0 = time.perf_counter()
    cfg = parity_config(get_config(CKPT_ARCH), "bfloat16")
    remat = dict((a, r) for a, r, _ in TRAIN_PATHS)[CKPT_ARCH]
    model = build_model(cfg)
    params = model.init(SEED)
    opt_cfg = adamw.AdamWConfig()
    step = make_train_step(model, opt_cfg, ShardingPlan(name="dp",
                                                        remat=remat),
                           use_kernel=True, donate=True)
    opt = adamw.init(opt_cfg, params)
    pipe = make_pipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED,
                         device="cuda")
    try:
        got = [next(pipe) for _ in range(3)]
    finally:
        pipe.close()
    source = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    for i, (step_i, batch) in enumerate(got):
        tokens = batch["tokens"]
        if step_i != i or tokens.device.type != "cuda" or not np.array_equal(
                tokens.cpu().numpy(), source.batch_at(i)["tokens"]):
            raise AssertionError(f"pipeline batch {i} (step {step_i}) is "
                                 f"not SyntheticLM's on the card")
    batches = [b for _, b in got]
    losses, times = [], []
    for batch in batches[:2]:
        params, opt, loss, ms = _timed_step(step, params, opt, batch)
        losses.append(float(loss))
        times.append(ms)
    saved = adamw.tree_map(torch.Tensor.clone, _state(params, opt))
    opt_step = opt.step
    if CKPT_DIR.exists():
        shutil.rmtree(CKPT_DIR)
    ck = store.AsyncCheckpointer(str(CKPT_DIR), keep=1)
    t = time.perf_counter()
    ck.save(2, {"params": params, "opt": opt}, extra_meta={"arch": cfg.name})
    snapshot_s = time.perf_counter() - t
    params, opt, loss_live, step3_in_flight_ms = _timed_step(
        step, params, opt, batches[2])
    ck.wait()
    write_s = time.perf_counter() - t
    nbytes = sum(f.stat().st_size for f in CKPT_DIR.rglob("*")
                 if f.is_file())
    if store.latest_step(str(CKPT_DIR)) != 2:
        raise AssertionError("checkpoint: LATEST does not name step 2")

    fresh = {"params": model.init(SEED + 1),
             "opt": adamw.init(opt_cfg, model.init(SEED + 1))}
    torch.cuda.synchronize()
    t = time.perf_counter()
    restored, at = store.restore(str(CKPT_DIR), fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    del fresh
    differ = _differing_leaves(saved, _state(restored["params"],
                                             restored["opt"]))
    if at != 2 or restored["opt"].step != opt_step or differ:
        raise AssertionError(f"checkpoint: restored step {at}, leaves not "
                             f"equal to the saved ones: {differ[:8]}")
    del saved
    p3, o3, loss_restored, step3_ms = _timed_step(
        step, restored["params"], restored["opt"], batches[2])
    differ = _differing_leaves(_state(params, opt), _state(p3, o3))
    if differ or o3.step != opt.step or not torch.equal(loss_live,
                                                         loss_restored):
        raise AssertionError(f"checkpoint: step 3 from the restored state "
                             f"is not bit-identical to step 3 from the live "
                             f"state: {differ[:8]}")
    n_leaves = sum(1 for _ in _leaves(params)) * 3 + 1
    del params, opt, p3, o3, restored, batches, got
    shutil.rmtree(CKPT_DIR)
    torch.cuda.empty_cache()
    return {"phase": "checkpoint", "arch": cfg.name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "pipeline": "make_pipeline(seed 0), pinned, non_blocking onto "
                        "the card; equal to SyntheticLM's arrays",
            "losses": losses + [float(loss_live)], "step_ms": times,
            "checkpoint_bytes": nbytes, "checkpoint_leaves": n_leaves,
            "snapshot_s": snapshot_s, "save_write_s": write_s,
            "restore_s": restore_s,
            "step3_ms_with_write_in_flight": step3_in_flight_ms,
            "step3_ms_without": step3_ms,
            "restored_leaves_equal": True,
            "step3_bit_identical_from_restored": True,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# linreg
# ---------------------------------------------------------------------------


def phase_linreg() -> dict:
    """One cold solve through the entry point (its ``seconds`` include the
    first solve's set-up on the card), then the median of five more
    ``solve_linreg`` calls on the host clock and of each part by CUDA
    events: the Gram matrix (tsmm), X^T y and the solve."""
    ops.reset_launch_counts()
    r = linreg_ds.execute_small(LINREG_M, LINREG_N, LINREG_LAM, seed=SEED)
    launches = ops.launch_counts()["tsmm_upper"]
    if launches < 1:
        raise AssertionError("LinReg DS did not launch the tsmm kernel")
    beta = r.pop("beta")
    bound = 1e-4     # fp32 Gram and solve of a well-conditioned system
    if beta.shape != (LINREG_N, 1) or not bool(torch.isfinite(beta).all()) \
            or r["max_abs_err_vs_f64"] > bound:
        raise AssertionError(f"LinReg DS: beta is off: {r}")
    x, y, _ = linreg_ds.make_problem(LINREG_M, LINREG_N, SEED,
                                     torch.device("cuda"))
    warm, parts = [], {"tsmm": [], "xty": [], "solve": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        linreg_ds.solve_linreg(x, y, LINREG_LAM)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        a = ops.tsmm(x, reg=LINREG_LAM)
        ev[1].record()
        b = x.T @ y
        ev[2].record()
        torch.linalg.solve(a, b)
        ev[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            parts[name].append(ev[i].elapsed_time(ev[i + 1]))
    del x, y, a, b
    return {"phase": "linreg", **r, "lam": LINREG_LAM, "bound": bound,
            "tsmm_launches": launches,
            "warm_seconds": float(np.median(warm)),
            "warm_part_ms": {k: float(np.median(v))
                             for k, v in parts.items()}}


# ---------------------------------------------------------------------------
# estimate
# ---------------------------------------------------------------------------


def _check_estimates(where: str, values) -> None:
    bad = [v for v in values if not (math.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"{where}: estimates not finite and positive: "
                             f"{bad}")


def phase_estimate(serve: dict, train: dict) -> dict:
    """The paper's loop closed on the card: each LinReg DS plan generated,
    costed for one H100 and executed warm (``bench_accuracy.linreg_rows``),
    and each serve path's prefill round and decode step estimated
    (``bench_accuracy.serve_estimates``) at the batch, longest prefill (a
    vision stub's patches counted) and cache length that path served,
    beside what its second static run measured: warm, as the LinReg rows
    are (the first run, which pays the process's one-time set-up, is
    reported beside it); and each train path's step
    (``bench_accuracy.train_estimates``) at the batch, positions and plan it
    ran, beside its warm median step.  A ratio outside the
    paper's 2x is reported, not raised."""
    t0 = time.perf_counter()
    linreg = bench_accuracy.linreg_rows()
    rows = linreg[:-1]
    _check_estimates("linreg", [r["est_ms"] for r in rows])
    fp32 = rows[0]
    if (fp32["name"], fp32["m"], fp32["n"]) != ("h100-linreg", LINREG_M,
                                                LINREG_N):
        raise AssertionError(f"the first LinReg row is not the main path's "
                             f"shape: {fp32}")
    if (fp32["exec_type"], fp32["tsmm_op"]) != ("CP", "tsmm"):
        raise AssertionError(f"h100-linreg planned {fp32['exec_type']}/"
                             f"{fp32['tsmm_op']}, not CP/tsmm")
    if fp32["tsmm_launches"] < 1:
        raise AssertionError("the h100-linreg row did not launch tsmm")
    if not fp32["max_abs_err_vs_f64"] <= 1e-4:     # phase_linreg's bound
        raise AssertionError(f"h100-linreg: beta is off: {fp32}")
    out = {}
    for arch, run in serve.items():
        shape = {"batch": len(run["prompt_lens"]),
                 "prompt_len": run["prefill_positions"],
                 "max_len": run["max_len"]}
        est = {**shape, **bench_accuracy.serve_estimates(
            path_config(arch, "serve"), **shape)}
        for key in ("prefill", "decode"):
            warm, cold = (_measured_ms(run[r], key)
                          for r in ("static_again", "static"))
            plans = {k: v for k, v in est[key].items() if isinstance(v, dict)}
            _check_estimates(f"{arch} {key}",
                             [v["total_ms"] for v in plans.values()])
            est[key]["measured_ms"] = warm
            est[key]["measured_first_run_ms"] = cold
            est[key]["ratio"] = {k: v["total_ms"] / warm
                                 for k, v in plans.items()}
        out[arch] = est
    train_rows = {}
    for arch, run in train.items():
        est = bench_accuracy.train_estimates(
            path_config(arch, "train"), run["batch"], run["positions"],
            ShardingPlan(name="dp", remat=run["remat"]))
        _check_estimates(f"{arch} train", [est["total_ms"]])
        est["measured_ms"] = run["warm_median_step_ms"]
        est["measured_first_step_ms"] = run["step_ms"][0]
        est["ratio"] = est["total_ms"] / est["measured_ms"]
        train_rows[arch] = est
    return {"phase": "estimate", "linreg": linreg, "serve": out,
            "train": train_rows, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------

CALIBRATED = ("est_cal / measured: the same estimate under the H100 "
              "calibration profile fitted by the calibrate phase from the "
              "plain-program cells (bench_calibrate)")


def phase_calibrate(estimate: dict, train: dict):
    """The estimate-against-reality loop closed by a fit: the reference's
    calibration harvest, fit and drift gate on the card
    (``bench_calibrate.calibrate``, its LinReg cells the estimate phase's
    rows, not run again), the fusion rows (``bench_fusion.run``: the traced
    plan's fused-vs-split bytes, and the fusing kernels' times), and each
    train path's step costed component by component at the train phase's
    shape (``component_cost``): the generated plan of the plain program,
    not of the kernel path.  The gate is reported PASS or FAIL; a broken
    measurement path raises.  Returns the phase's line and the calibrated
    config, for :func:`add_calibrated`."""
    t0 = time.perf_counter()
    result = bench_calibrate.calibrate(linreg=estimate["linreg"])
    fusion = bench_fusion.run()
    cc = h100_single_config()
    components = {}
    for arch, run in train.items():
        t = time.perf_counter()
        comps = component_costs(
            path_config(arch, "train"),
            ShapeConfig("h100_train", run["positions"], run["batch"],
                        "train"),
            ShardingPlan(name="dp", remat=run["remat"]))
        agg = aggregate(comps, cc)
        components[arch] = {
            "program": "plain", "chip_spec": cc.chip.name,
            "batch": run["batch"], "seq_len": run["positions"],
            "remat": run["remat"], "trace_seconds": time.perf_counter() - t,
            **{k: agg[k] for k in ("compute_s", "memory_s", "dominant",
                                   "roofline_bound_s", "flops_per_device",
                                   "bytes_per_device")},
            "components": [{k: c[k] for k in ("name", "count",
                                              "flops_per_device",
                                              "bytes_per_device")}
                           for c in agg["components"]],
            "measured_kernel_path_step_ms": run["warm_median_step_ms"]}
    fit = result["fit"]
    return {"phase": "calibrate", "rows": bench_calibrate.rows(result),
            "factors": fit.factors, "residual": fit.residual,
            "samples": result["samples"], "arch_cells": result["arch_cells"],
            "fit_features": result["features"],
            "drift": result["drift"],
            "median_uncal": result["median_uncal"],
            "median_cal": result["median_cal"],
            "in_band": result["in_band"], "verdict": result["verdict"],
            "fusion": fusion, "component_cost": components,
            "calibrate_seconds": result["seconds"],
            "seconds": time.perf_counter() - t0}, result["cc_cal"]


def add_calibrated(estimate: dict, drift: dict, cc_cal) -> None:
    """Each est / measured of the estimate phase gains its est_cal /
    measured (``ratio_cal``) under the fitted profile: the LinReg rows from
    the calibrate phase's ``drift`` (the same cells), the serve and train
    rows estimated again with the calibrated config ``cc_cal``."""
    estimate["calibration"] = CALIBRATED
    for row in estimate["linreg"]:
        if "name" in row:
            row["ratio_cal"] = drift[row["name"]]["ratio_cal"]
    for arch, est in estimate["serve"].items():
        cal = bench_accuracy.serve_estimates(
            path_config(arch, "serve"), est["batch"], est["prompt_len"],
            est["max_len"], cc=cc_cal)
        for key in ("prefill", "decode"):
            plans = {k: v for k, v in cal[key].items() if isinstance(v, dict)}
            _check_estimates(f"{arch} {key} calibrated",
                             [v["total_ms"] for v in plans.values()])
            est[key]["ratio_cal"] = {k: v["total_ms"]
                                     / est[key]["measured_ms"]
                                     for k, v in plans.items()}
    for arch, est in estimate["train"].items():
        cal = bench_accuracy.train_estimates(
            path_config(arch, "train"), est["batch"], est["seq_len"],
            ShardingPlan(name="dp", remat=est["remat"]), cc=cc_cal)
        _check_estimates(f"{arch} train calibrated", [cal["total_ms"]])
        est["total_ms_cal"] = cal["total_ms"]
        est["ratio_cal"] = cal["total_ms"] / est["measured_ms"]


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

# The trainer phase's path: qwen1.5-0.5b at full size (24 layers, bf16) at
# the train phase's B 8 x S 2048, on the plan choose_plan picks for one
# H100, through the user's entry points (Trainer, launch/train.py).  The
# stopped run checkpoints into the build directory, which .gitignore lists,
# and the directory is removed afterwards.
TRAINER_ARCH = "qwen1.5-0.5b"
TRAINER_STEPS, TRAINER_STOP, TRAINER_CKPT_EVERY = 10, 6, 5
TRAINER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_trainer"
# a Trainer step's host seconds (read after a synchronise) must come to at
# least this share of the train phase's CUDA-event median for the same arch
# and plan: a Trainer that timed the launch alone would read far below it
TRAINER_TIME_FLOOR = 0.9
DRIVER_STEPS = 3


def _trainer_launches(cfg, plan, steps: int) -> dict:
    """The kernel launches ``steps`` Trainer steps of ``cfg`` on ``plan``
    must make: each microbatch is a forward and backward of its rows."""
    micro = max(plan.microbatches, 1)
    return expected_train_launches(cfg, plan.remat, TRAIN_BATCH // micro,
                                   TRAIN_SEQ, steps * micro)


def _check_launches(where: str, launches: dict, expected: dict) -> None:
    used = ("flash_attention", "flash_attention_bwd", "matmul_epilogue")
    if any(launches[k] < 1 for k in used) or launches != expected:
        raise AssertionError(f"trainer: {where} launched {launches}, "
                             f"expected {expected}")


def phase_trainer(train: dict) -> dict:
    """The runtime on the card through its entry points: a straight
    ``Trainer.run`` of TRAINER_STEPS steps with the recalibrator on, each
    step's ``time_s`` held against the train phase's CUDA-event median;
    then a run stopped after TRAINER_STOP steps (a checkpoint at step
    TRAINER_CKPT_EVERY) and a resumed run to TRAINER_STEPS from ``LATEST``,
    whose losses and final weights and AdamW state must equal the straight
    run's bit for bit; the recalibrator's events, the straggler verdict and
    the checkpoint's bytes; and the training driver ``launch/train.py`` in
    this process for DRIVER_STEPS steps."""
    t0 = time.perf_counter()
    cfg = get_config(TRAINER_ARCH)
    shape = ShapeConfig("h100_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    cc = h100_single_config()
    decision = choose_plan(cfg, shape, cc, top_k=1)[0]
    plan = decision.plan
    opt_cfg = adamw.AdamWConfig(total_steps=TRAINER_STEPS)

    def trainer(steps, ckpt_dir=None, recalibrate=False):
        return Trainer(cfg, shape, cc, "cuda", plan=plan, opt_cfg=opt_cfg,
                       tcfg=TrainerConfig(
                           steps=steps, log_every=1,
                           checkpoint_every=TRAINER_CKPT_EVERY,
                           ckpt_dir=ckpt_dir, recalibrate=recalibrate))

    # 1. straight through, the recalibrator watching
    t = time.perf_counter()
    straight = trainer(TRAINER_STEPS, recalibrate=True)
    rec = straight.recalibrator
    est_before = rec.estimated
    ops.reset_launch_counts()
    run = straight.run()
    launches = ops.launch_counts()
    straight_s = time.perf_counter() - t
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    times = [h["time_s"] for h in hist]
    if [h["step"] for h in hist] != list(range(TRAINER_STEPS)) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"trainer: steps {[h['step'] for h in hist]}, "
                             f"losses {losses}")
    expected = _trainer_launches(cfg, plan, TRAINER_STEPS)
    _check_launches("the straight run", launches, expected)
    warm_ms = train[TRAINER_ARCH]["warm_median_step_ms"]
    median_ms = float(np.median(times[1:])) * 1e3
    if not median_ms >= TRAINER_TIME_FLOOR * warm_ms:
        raise AssertionError(f"trainer: median step {median_ms} ms under "
                             f"{TRAINER_TIME_FLOOR} x the train phase's "
                             f"{warm_ms} ms: the launch was timed")
    lo, hi = rec.band
    if not rec.events and not lo <= rec.ewma <= hi and \
            TRAINER_STEPS >= rec.min_observations:
        raise AssertionError(f"trainer: EWMA ratio {rec.ewma} outside "
                             f"{rec.band} after {TRAINER_STEPS} steps and "
                             f"no recalibration")
    events = [{"step": e.step, "ewma_ratio": e.ratio,
               "factors": e.profile.to_json(),
               "profile": e.profile.describe(), "replanned": e.replanned,
               "old_plan": e.old_plan, "new_plan": e.new_plan,
               "elastic": None if e.elastic is None else {
                   "mesh_shape": list(e.elastic.mesh_shape),
                   "lr_scale": e.elastic.lr_scale,
                   "plan": e.elastic.decision.plan.describe(),
                   "estimated_ms": e.elastic.decision.time * 1e3}}
              for e in rec.events]
    recalibration = {
        "band": list(rec.band), "events": events,
        "estimated_ms_before": est_before * 1e3,
        "estimated_ms_after": rec.estimated * 1e3,
        "measured_median_ms": median_ms,
        "ratio_before": median_ms / (est_before * 1e3),
        "ratio_after": median_ms / (rec.estimated * 1e3),
        "plan_after": rec.plan.describe(),
        "ewma_at_end": rec.ewma}
    straggler = dataclasses.asdict(straight.monitor.detect())
    final = {"params": run["params"], "opt": run["opt_state"]}
    del run, straight, rec
    torch.cuda.empty_cache()

    # 2. stopped after TRAINER_STOP steps, a checkpoint at TRAINER_CKPT_EVERY
    if TRAINER_DIR.exists():
        shutil.rmtree(TRAINER_DIR)
    t = time.perf_counter()
    stopped = trainer(TRAINER_STOP, ckpt_dir=str(TRAINER_DIR)).run()
    stopped_s = time.perf_counter() - t
    at = store.latest_step(str(TRAINER_DIR))
    ckpt_bytes = sum(f.stat().st_size for f in TRAINER_DIR.rglob("*")
                     if f.is_file())
    stopped_losses = [h["loss"] for h in stopped["history"]]
    del stopped
    torch.cuda.empty_cache()
    if at != TRAINER_CKPT_EVERY:
        raise AssertionError(f"trainer: LATEST names step {at}")

    # 3. resumed from LATEST to TRAINER_STEPS
    t = time.perf_counter()
    ops.reset_launch_counts()
    resumed = trainer(TRAINER_STEPS, ckpt_dir=str(TRAINER_DIR)).run()
    resumed_launches = ops.launch_counts()
    resumed_s = time.perf_counter() - t
    tail = [h["loss"] for h in resumed["history"]]
    steps_resumed = [h["step"] for h in resumed["history"]]
    differ = _differing_leaves(
        _state(final["params"], final["opt"]),
        _state(resumed["params"], resumed["opt_state"]))
    if (steps_resumed != list(range(TRAINER_STOP, TRAINER_STEPS))
            or tail != losses[TRAINER_STOP:]
            or resumed["opt_state"].step != final["opt"].step or differ):
        raise AssertionError(f"trainer: resumed steps {steps_resumed}, "
                             f"losses {tail} against {losses[TRAINER_STOP:]}"
                             f", leaves differing {differ[:8]}")
    _check_launches("the resumed run", resumed_launches,
                    _trainer_launches(cfg, plan,
                                      TRAINER_STEPS - TRAINER_STOP))
    if stopped_losses != losses[:TRAINER_STOP]:
        raise AssertionError(f"trainer: the stopped run's losses "
                             f"{stopped_losses} are not the straight run's")
    del resumed, final
    shutil.rmtree(TRAINER_DIR)
    torch.cuda.empty_cache()

    # 4. the training driver, in this process
    out = io.StringIO()
    t = time.perf_counter()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        train_driver.main(["--arch", TRAINER_ARCH, "--steps",
                           str(DRIVER_STEPS), "--global-batch",
                           str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ)])
    driver_launches = ops.launch_counts()
    driver_s = time.perf_counter() - t
    text = out.getvalue()
    rows = [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]
    driver_losses = [r["loss"] for r in rows]
    if ("== cost-based plan ranking (h100_sxm) ==" not in text
            or [r["step"] for r in rows] != list(range(DRIVER_STEPS))
            or not all(math.isfinite(v) for v in driver_losses)):
        raise AssertionError(f"trainer: the driver printed {text!r}")
    _check_launches("the driver", driver_launches,
                    _trainer_launches(cfg, plan, DRIVER_STEPS))
    torch.cuda.empty_cache()
    return {"phase": "trainer", "arch": cfg.name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "plan": plan.describe(), "plan_estimated_ms": decision.time * 1e3,
            "steps": TRAINER_STEPS, "losses": losses, "time_s": times,
            "median_step_ms": median_ms,
            "train_phase_warm_median_step_ms": warm_ms,
            "time_floor": TRAINER_TIME_FLOOR,
            "launches": launches, "expected_launches": expected,
            "recalibration": recalibration, "straggler": straggler,
            "stopped_at": TRAINER_STOP, "checkpoint_step": at,
            "checkpoint_bytes": ckpt_bytes,
            "resumed_steps": steps_resumed, "resumed_losses": tail,
            "resumed_bit_identical": True,
            "resumed_launches": resumed_launches,
            "driver": {"argv_steps": DRIVER_STEPS,
                       "ranking": [line.strip() for line in
                                   text.splitlines()[1:4]],
                       "losses": driver_losses,
                       "launches": driver_launches, "seconds": driver_s},
            "straight_s": straight_s, "stopped_s": stopped_s,
            "resumed_s": resumed_s,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

# The mesh phase's path: the trainer phase's Trainer (same arch, size, plan,
# seed and AdamW schedule) built on a one-rank CUDA mesh of nccl, so that
# its weights, moments and batches are DTensors; MESH_STEPS steps (the last
# one under torch.profiler, for the device's busy time), a checkpoint at
# MESH_CKPT_AT restored onto the shardings; then, once nothing is timed,
# one dry-run cell in a subprocess on the fake process group.  One card
# checks the placements and one-rank execution only: nothing here is
# multi-GPU.
MESH_STEPS, MESH_CKPT_AT = 6, 2
MESH_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
MESH_DRYRUN = ("qwen1.5-0.5b", "train_4k", "single")
MESH_DRYRUN_TIMEOUT_S = 400
# The cell's artifact, kept apart from MESH_DIR for the entrypoints phase's
# render_tables, which removes it.
MESH_DRYRUN_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_dryrun"
MESH_DRYRUN_LOG = MESH_DRYRUN_DIR.with_suffix(".log")


def start_mesh_dryrun_cell():
    """Start the dry-run cell (:data:`MESH_DRYRUN`) in a subprocess, on the
    CPU (the fake process group is apart from this process's nccl group),
    its output into :data:`MESH_DRYRUN_LOG` (a pipe nobody reads while the
    cell runs could fill and stall it); returns the process and its start
    time."""
    arch, shape, mesh = MESH_DRYRUN
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    MESH_DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(MESH_DRYRUN_LOG, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--force",
             "--artifact-dir", str(MESH_DRYRUN_DIR)], env=env, stdout=log,
            stderr=subprocess.STDOUT)
    return proc, time.perf_counter()


def _mesh_dryrun_cell(started=None) -> dict:
    """The dry-run cell's status (it must be ``ok``) and collectives, once
    its subprocess (``started`` by :func:`start_mesh_dryrun_cell`, or
    started here) ends; killed at :data:`MESH_DRYRUN_TIMEOUT_S`."""
    arch, shape, mesh = MESH_DRYRUN
    proc, t = started if started is not None else start_mesh_dryrun_cell()
    try:
        proc.wait(timeout=max(
            MESH_DRYRUN_TIMEOUT_S - (time.perf_counter() - t), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t
    out = MESH_DRYRUN_LOG.read_text()
    MESH_DRYRUN_LOG.unlink()
    path = MESH_DRYRUN_DIR / f"dryrun_{arch}_{shape}_{mesh}.json"
    if proc.returncode != 0 or not path.exists():
        raise AssertionError(f"mesh: the dry-run cell failed "
                             f"({proc.returncode}): {out[-8000:]}")
    d = json.loads(path.read_text())
    if d["status"] != "ok":
        raise AssertionError(f"mesh: dry-run status {d['status']}: "
                             f"{d.get('error')}")
    print(f"status={d['status']} collectives_by_kind="
          f"{json.dumps(d['collectives_by_kind'])}", flush=True)
    return {"cell": list(MESH_DRYRUN), "status": d["status"],
            "plan": d["plan"], "collectives_by_kind": d["collectives_by_kind"],
            "n_collectives": len(d["compiled_cost"]["collectives"]),
            "roofline": d["roofline"], "trace_s": d["trace_s"],
            "subprocess_s": seconds}


def phase_mesh(train: dict, trainer_run: dict) -> dict:
    """The sharded Trainer on the card: nccl at world size 1 from a
    FileStore under ``build/``, ``make_host_mesh("cuda")``, then
    ``Trainer(arch, shape, cc, mesh, plan=...)`` on the trainer phase's
    arch, size, plan, seed and AdamW schedule for MESH_STEPS steps: every
    parameter a DTensor, the kernels' launches ``expected_train_launches``
    x MESH_STEPS, the losses bit-identical to the trainer phase's first
    MESH_STEPS, each step timed by CUDA events; the last step runs under
    torch.profiler, whose kernels' device time is set beside the other
    steps' CUDA-event median (the rest of the step the device waits: no
    collective runs on one rank).  A
    checkpoint at step MESH_CKPT_AT restored onto the shardings equals,
    leaf for leaf, the state the step saved.  The phase's dry-run cell
    (:data:`MESH_DRYRUN`) traces in a subprocess on the host's CPU while
    the entrypoints phase's cost-model work runs there, once nothing on the
    card is timed: :func:`phase_entrypoints` adds it to this phase's line
    as ``dryrun``, and it must end ``ok``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharded import is_dtensor

    t0 = time.perf_counter()
    cfg = get_config(TRAINER_ARCH)
    shape = ShapeConfig("h100_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    cc = h100_single_config()
    plan = choose_plan(cfg, shape, cc, top_k=1)[0].plan
    if plan.describe() != trainer_run["plan"]:
        raise AssertionError(f"mesh: plan {plan.describe()} is not the "
                             f"trainer phase's {trainer_run['plan']}")
    if MESH_DIR.exists():
        shutil.rmtree(MESH_DIR)
    MESH_DIR.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(MESH_DIR / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh("cuda")
        trainer = Trainer(cfg, shape, cc, mesh, plan=plan,
                          opt_cfg=adamw.AdamWConfig(total_steps=TRAINER_STEPS),
                          tcfg=TrainerConfig(
                              steps=MESH_STEPS, log_every=1,
                              checkpoint_every=MESH_CKPT_AT,
                              ckpt_dir=str(MESH_DIR / "ckpt")))
        saved = {}
        save = trainer.checkpointer.save

        def keep_and_save(step, tree, **kw):
            # the state the step saves, whole on the host, to compare with
            if step == MESH_CKPT_AT:
                saved.update(_state(*(
                    store._map_with_paths(lambda _, x: store._to_host(x), t)
                    for t in (tree["params"], tree["opt"]))))
                saved["step"] = tree["opt"].step
            return save(step, tree, **kw)
        trainer.checkpointer.save = keep_and_save
        step_ms = []
        step = trainer.train_step

        profiled = {}

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if len(step_ms) < MESH_STEPS - 1:
                start.record()
                out = step(*args)
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
                return out
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                start.record()
                out = step(*args)
                end.record()
                end.synchronize()
            profiled["event_ms"] = start.elapsed_time(end)
            profiled["device_busy_ms"] = sum(
                e.device_time_total / 1e3 for e in prof.key_averages()
                if e.device_time_total > 0 and e.device_type
                == torch.autograd.DeviceType.CUDA)
            return out
        trainer.train_step = timed
        ops.reset_launch_counts()
        run = trainer.run()
        launches = ops.launch_counts()
        losses = [h["loss"] for h in run["history"]]
        leaves = list(_leaves(run["params"]))
        placements = sorted({str(tuple(x.placements)) for x in leaves
                             if is_dtensor(x)})
        if not all(is_dtensor(x) for x in leaves):
            raise AssertionError("mesh: a parameter is not a DTensor")
        expected = _trainer_launches(cfg, plan, MESH_STEPS)
        _check_launches("the mesh run", launches, expected)
        want = trainer_run["losses"][:MESH_STEPS]
        if losses != want:
            raise AssertionError(f"mesh: losses {losses} are not the "
                                 f"trainer phase's {want}")
        del run
        torch.cuda.empty_cache()

        # restore the step-MESH_CKPT_AT checkpoint onto the shardings
        like_p, like_o, _ = trainer.init_state()
        sh = trainer.shardings(like_p, like_o)
        t = time.perf_counter()
        restored, at = store.restore(str(MESH_DIR / "ckpt"),
                                     {"params": like_p, "opt": like_o},
                                     step=MESH_CKPT_AT, shardings=sh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        got = _state(restored["params"], restored["opt"])
        n_leaves = len(list(_leaves(got)))
        n_dtensor = sum(is_dtensor(x) for x in _leaves(got))
        local = store._map_with_paths(
            lambda _, x: x.to_local().cpu() if is_dtensor(x) else x, got)
        differ = _differing_leaves(local, {k: saved[k] for k in got})
        if (at != MESH_CKPT_AT or restored["opt"].step != saved["step"]
                or differ or n_dtensor != n_leaves):
            raise AssertionError(f"mesh: restored step {at}, DTensors "
                                 f"{n_dtensor} of {n_leaves}, "
                                 f"leaves differing {differ[:8]}")
        del restored, got, local, saved, like_p, like_o, trainer
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return {"phase": "mesh", "arch": cfg.name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "mesh": {"shape": list(mesh.shape),
                     "axes": list(mesh.mesh_dim_names),
                     "device_type": mesh.device_type, "backend": "nccl"},
            "plan": plan.describe(), "param_placements": placements,
            "losses": losses, "losses_bit_identical_to_trainer": True,
            "trainer_losses": want, "launches": launches,
            "expected_launches": expected, "step_ms": step_ms,
            "median_step_ms": float(np.median(step_ms[1:])),
            # the profiler's own host work stretches the profiled step;
            # its kernels' busy time does not move, and is set beside the
            # median of the steps run without it
            "profiled_step": profiled,
            "device_idle_share_at_median": max(
                0.0, 1 - profiled["device_busy_ms"]
                / float(np.median(step_ms[1:]))),
            "trainer_median_step_ms": trainer_run["median_step_ms"],
            "train_phase_warm_median_step_ms":
                train[TRAINER_ARCH]["warm_median_step_ms"],
            "restored_step": at, "restore_s": restore_s,
            "restored_bit_identical": True,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# entrypoints
# ---------------------------------------------------------------------------

ENTRY_LINREG = ["--m", str(LINREG_M), "--n", str(LINREG_N)]
ENTRY_LINREG_SOLVES = 2          # linreg_ds.main: a cold and a warm solve
# Each cost-model example as a user runs it on the card's grid, by name.
ENTRY_EXAMPLES = [("quickstart", ["--h100"]), ("autotune_plan", ["--h100"]),
                  ("optimize_resources", ["--h100"]),
                  ("optimize_resources", ["--h100", "--shape", "chat_2k"]),
                  ("sweep_plans", ["--h100"])]
# The paper-table modules that no earlier phase runs (accuracy, calibrate
# and fusion run in the estimate and calibrate phases).
ENTRY_TABLES = ("scenarios", "plan_costing", "costing_speed", "resource_opt",
                "serving", "parallel")
# Row fields that read the host's clock; a PASS / FAIL beside one is a
# wall-clock claim, reported and not enforced.
WALL_FIELD = re.compile(r"^(\w*speedup\w*|\w*_us|ncpu|gate)=")


@contextlib.contextmanager
def spawn_without_main_script():
    """A ``spawn`` worker first runs its parent's main script (as
    ``__mp_main__``) when that is a file: here this script, which imports
    torch.  ``core.parallel``'s workers are functions of
    ``repro_torch.core`` and need none of it, so the script's path is
    hidden from ``multiprocessing`` while pools start: the workers load the
    cost model alone."""
    main_mod = sys.modules["__main__"]
    path = main_mod.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        if path is not None:
            main_mod.__file__ = path


def _captured(fn, *args, **kw):
    """``fn``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _example_winner(name: str, result) -> dict:
    """The winner an example printed: its id, estimated step ms (a serving
    winner's decode step) and feasibility."""
    if name == "quickstart":
        d = result[0]
        return {"winner": d.plan.describe(), "cluster": "h100_node_config",
                "est_step_ms": d.time * 1e3, "feasible": d.feasible}
    if name == "autotune_plan":
        label, d = min(((label, d) for label, ds in result.items()
                        for d in ds if d.feasible),
                       key=lambda ld: ld[1].time,
                       default=(None, None))
        if d is None:
            return {"winner": None, "feasible": False}
        return {"winner": d.plan.describe(), "cluster": label,
                "est_step_ms": d.time * 1e3, "feasible": d.feasible}
    if name == "optimize_resources":
        rd = result[0]
        out = {"winner": rd.cluster_id, "plan": rd.decision.plan.describe(),
               "est_step_ms": rd.time * 1e3, "feasible": rd.feasible}
        if hasattr(rd, "ttft_p99"):
            out.update(slots=rd.slots, est_ttft_p99_ms=rd.ttft_p99 * 1e3)
        return out
    cells = [c for c in result if c.feasible]
    best = min(cells, key=lambda c: c.time, default=None)
    if best is None:
        return {"winner": None, "feasible": False}
    return {"winner": best.key, "plan": best.decision.plan.describe(),
            "est_step_ms": best.time * 1e3, "feasible": True,
            "feasible_cells": len(cells), "cells": len(result)}


def _table_verdicts(name: str, rows: list) -> dict:
    """Rows of one paper-table module, split: faults (an ``EXCEPTION`` or
    ``MISMATCH`` row, a ``max_abs_err`` other than 0, a FAIL beside no
    wall-clock field) and wall-clock claims (a PASS / FAIL beside one)."""
    faults, claims, gates = [], [], []
    for row in rows:
        row_name, us, derived = row.split(",", 2)
        fields = derived.split(";")
        wall = any(WALL_FIELD.match(f) for f in fields)
        errs = [f for f in fields if f.startswith("max_abs_err=")]
        if "EXCEPTION" in fields or any("MISMATCH" in f for f in fields) \
                or any(float(f.split("=")[1]) != 0 for f in errs):
            faults.append(row)
        elif wall and ("PASS" in fields or "FAIL" in fields):
            claims.append({"row": row_name, "us_per_call": float(us),
                           "verdict": "PASS" if "PASS" in fields else "FAIL",
                           "fields": [f for f in fields
                                      if "=" in f and WALL_FIELD.match(f)
                                      or f.startswith("claim=")]})
        elif "FAIL" in fields:
            faults.append(row)
        elif "PASS" in fields:
            gates.append(row_name)
    return {"rows": len(rows), "faults": faults, "wall_clock_claims": claims,
            "gates_passed": gates}


def phase_entrypoints(mesh: Optional[dict] = None) -> dict:
    """The cost-model entry points as a user runs them: (a) the LinReg DS
    example at 262144 x 1024 on the card (the scenario table, a cold and a
    warm solve through ``tsmm``, the estimate on one H100 beside the warm
    seconds), the launch counts set to 0 just before and read just after;
    (b) each cost-model example with ``--h100``, whose winner must be
    feasible; (c) the paper-table modules no earlier phase runs, at
    ``run(quick=True)``, and ``render_tables`` over the mesh phase's
    dry-run cell, which traces in a subprocess during (b) and (c) (all of
    it host work: nothing on the card is timed then) and goes into
    ``mesh["dryrun"]``."""
    from repro_torch.benchmarks import render_tables
    from repro_torch.examples import (autotune_plan, optimize_resources,
                                      quickstart, sweep_plans)
    t0 = time.perf_counter()
    examples = {"quickstart": quickstart, "autotune_plan": autotune_plan,
                "optimize_resources": optimize_resources,
                "sweep_plans": sweep_plans}

    ops.reset_launch_counts()
    t = time.perf_counter()
    r, text = _captured(linreg_ds.main, ENTRY_LINREG)
    linreg_s = time.perf_counter() - t
    launches = ops.launch_counts()
    beta = r.pop("beta")
    bound = 1e-4     # fp32 Gram and solve of a well-conditioned system
    if launches["tsmm_upper"] != ENTRY_LINREG_SOLVES:
        raise AssertionError(f"entrypoints: {launches['tsmm_upper']} tsmm "
                             f"launches for {ENTRY_LINREG_SOLVES} solves")
    if beta.shape != (LINREG_N, 1) or not bool(torch.isfinite(beta).all()) \
            or r["max_abs_err_vs_f64"] > bound \
            or r["chip_spec"] != "h100_sxm" or "est / measured" not in text \
            or "costed plan, scenario XS" not in text:
        raise AssertionError(f"entrypoints: linreg_ds is off: {r}")
    linreg = {**r, "bound": bound, "tsmm_launches": launches["tsmm_upper"],
              "solves": ENTRY_LINREG_SOLVES, "launches": launches,
              "printed_lines": len(text.splitlines()),
              "main_seconds": linreg_s}
    print(text.splitlines()[-1], flush=True)

    dryrun = start_mesh_dryrun_cell()
    try:
        winners = []
        for name, argv in ENTRY_EXAMPLES:
            t = time.perf_counter()
            result, text = _captured(examples[name].main, argv)
            w = {"example": name, "argv": argv,
                 **_example_winner(name, result),
                 "seconds": time.perf_counter() - t}
            if not w["feasible"] or w["winner"] is None \
                    or w["winner"].split(": ")[0] not in text:
                raise AssertionError(f"entrypoints: {name} {argv} printed "
                                     f"no feasible winner: {w}")
            winners.append(w)

        tables = {}
        for name in ENTRY_TABLES:
            mod = importlib.import_module(
                f"repro_torch.benchmarks.bench_{name}")
            t = time.perf_counter()
            with spawn_without_main_script():
                rows, _ = _captured(mod.run, quick=True)
            tables[name] = {**_table_verdicts(name, rows),
                            "seconds": time.perf_counter() - t}
    except BaseException:
        dryrun[0].kill()
        dryrun[0].wait()
        raise
    t = time.perf_counter()
    cell = _mesh_dryrun_cell(dryrun)
    if mesh is not None:
        mesh["dryrun"] = cell
    dryrun_wait_s = time.perf_counter() - t
    t = time.perf_counter()
    rendered = render_tables.render("all", str(MESH_DRYRUN_DIR))
    arch, shape, mesh = MESH_DRYRUN
    if f"| {arch} | {shape} | {mesh} | ok |" not in rendered:
        raise AssertionError(f"entrypoints: render_tables shows no row of "
                             f"the mesh phase's cell:\n{rendered}")
    tables["render_tables"] = {"lines": len(rendered.splitlines()),
                               "seconds": time.perf_counter() - t}
    shutil.rmtree(MESH_DRYRUN_DIR, ignore_errors=True)
    faults = {n: v["faults"] for n, v in tables.items() if v.get("faults")}
    if faults:
        raise AssertionError(f"entrypoints: paper-table faults: {faults}")
    return {"phase": "entrypoints", "linreg_ds": linreg,
            "examples": winners, "tables": tables,
            "dryrun_wait_s": dryrun_wait_s, "cpu_count": os.cpu_count(),
            "seconds": time.perf_counter() - t0}


def _measured_ms(run: dict, key: str) -> float:
    """Milliseconds of one static run's prefill round (``prefill``) or of
    one of its decode steps (``decode``)."""
    if key == "prefill":
        return run["prefill_s"] * 1e3
    return run["decode_s"] * 1e3 / run["stats"]["decode_steps"]


def ptxas_summary(logs: dict) -> list:
    """Registers, static shared memory and spills of each kernel, from
    nvcc's ``-Xptxas -v`` output of each source (dynamic shared memory is
    set at launch and not shown there)."""
    rows = []
    for source, log in logs.items():
        for block in log.split("Compiling entry function")[1:]:
            mangled = block.split("'")[1]
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", mangled)
            name = m.group(2)[:int(m.group(1))] if m else mangled
            args = re.findall(r"L[ib](\d+)E", m.group(2)) if m else []
            used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                             block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            rows.append({"source": source,
                         "kernel": name + (f"<{','.join(args)}>"
                                           if args else ""),
                         "registers": int(used.group(1)) if used else None,
                         "static_smem_bytes": int(used.group(2) or 0)
                         if used else None,
                         "spill_bytes": int(spill.group(1))
                         + int(spill.group(2)) if spill else None})
        # setmaxnreg ignored (C7508), wgmma serialized (C7512, C7514, ...)
        rows.extend({"source": source, "warning": line.strip()}
                    for line in log.splitlines()
                    if "setmaxnreg" in line or re.search(r"C75\d\d", line))
    return rows


# ---------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-after", choices=["build", "kernels", "train"],
                    help="development aid: end early (exit 0, no result line)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print each kernel's registers and shared memory")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = device_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    emit({"phase": "build", "seconds": _build.build(verbose=args.ptxas),
          "dir": str(_build.build_dir()), "sources": list(_build.SOURCES)})
    if args.ptxas:
        emit({"phase": "ptxas", "kernels": ptxas_summary(_build.logs)})

    if args.stop_after == "build":
        return
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash_cases, tsmm_cases = check_flash(gen), check_tsmm(gen)
    ssd_cases, mm_cases = check_ssd(gen), check_mm(gen)
    control_cases = check_controls(gen)
    ssd_control = check_ssd_control(gen)
    flash_bwd_cases, ssd_bwd_cases = check_flash_bwd(gen), check_ssd_bwd(gen)
    ssd_bwd_control = check_ssd_bwd_control(gen)
    times = time_kernels(gen)
    bwd_times = time_bwd_kernels(gen)
    emit({"phase": "kernels", "flash_attention": flash_cases,
          "flash_attention_bwd": flash_bwd_cases,
          "tsmm_upper": tsmm_cases, "ssd_scan": ssd_cases,
          "ssd_scan_bwd": ssd_bwd_cases,
          "ssd_scan_control": ssd_control,
          "ssd_scan_bwd_control": ssd_bwd_control,
          "matmul_epilogue": mm_cases,
          "matmul_epilogue_controls": control_cases, "times": times,
          "bwd_times": bwd_times})
    if args.stop_after == "kernels":
        return

    train = {}
    for arch, remat, bf16_bound in TRAIN_PATHS:
        train[arch] = phase_train(arch, remat, bf16_bound)
        emit(train[arch])
    # every backward body sums in a fixed order: a step repeats bit for bit
    varying = {f"{arch} {dtype}": run["determinism"][dtype]
               for arch, run in train.items() for dtype in ("bf16", "fp32")
               if not run["determinism"][dtype]["bit_identical"]}
    if varying:
        raise AssertionError(f"train steps are not bit-identical on a "
                             f"rerun: {varying}")
    emit(phase_checkpoint())
    if args.stop_after == "train":
        return

    serve = {}
    for arch, bf16_tol, fp32_layers in SERVE_PATHS:
        serve[arch] = phase_serve(arch, bf16_tol, fp32_layers)
        emit(serve[arch])
    linreg = phase_linreg()
    emit(linreg)
    estimate = phase_estimate(serve, train)
    calib, cc_cal = phase_calibrate(estimate, train)
    add_calibrated(estimate, calib["drift"], cc_cal)
    emit(estimate)
    emit(calib)
    trainer_run = phase_trainer(train)
    emit(trainer_run)
    mesh = phase_mesh(train, trainer_run)
    entry = phase_entrypoints(mesh)     # adds the mesh phase's dry-run cell
    emit(mesh)
    emit(entry)

    def err_of(cases, tag):
        return next(c["max_abs_err"] for c in cases if c["case"] == tag)

    def path_launches(kernel):
        """The kernel's launches summed over every serve path's main run
        and every train path's steps."""
        return (sum(run["main_path_launches"][kernel]
                    for run in serve.values())
                + sum(run["launches"][kernel] for run in train.values()))

    fm, f80 = FLASH_MAIN, FLASH_D80
    times["flash_attention"]["d80"].update(
        max_abs_err=err_of(flash_cases, "zamba2 main path, D = 80"),
        **flash_bound_ms(f80["b"], f80["hq"], f80["hkv"], f80["s"], f80["d"],
                         f80["causal"], f80["window"], torch.bfloat16))
    mm_times = times["matmul_epilogue"]
    for name, tag in (("gate", "zamba2 gate main path"),
                      ("head", "zamba2 head main path"),
                      ("qwen_gate", "qwen gate main path"),
                      ("qwen_head", "qwen head main path, vocab 151936"),
                      ("mamba_head", "mamba2 head, vocab 50280"),
                      ("decode_gate", "decode-step gate, 8 rows"),
                      ("qwen_decode_gate", "qwen decode-step gate, 8 rows")):
        mm_times[name]["max_abs_err"] = err_of(mm_cases, tag)
    ssd_times = times["ssd_scan"]
    ssd_times["zamba2"]["max_abs_err"] = err_of(ssd_cases,
                                                "zamba2 main path")

    def arch_launches(arch, kernel):
        """The kernel's launches on ``arch``'s serve and train paths."""
        return (serve[arch]["main_path_launches"][kernel]
                + train[arch]["launches"][kernel])

    times["flash_attention"]["d80"]["launches"] = arch_launches(
        "zamba2-2.7b", "flash_attention")
    ssd_times["zamba2"]["launches"] = arch_launches("zamba2-2.7b",
                                                    "ssd_scan")
    def shape_launches(tag, m, kernel, phase=None):
        """The launches of ``kernel`` at the flash shape ``tag`` (``m``) on
        its arch's serve and train paths (``phase`` "train": the train
        path's alone), as counted by mask, or for a window-pattern arch by
        window: whisper's encoder is the one shape that is not causal,
        gemma3-12b's local and global layers differ by window."""
        arch, _, part = tag.partition(" ")
        if get_config(arch).window_pattern is not None:
            count, key = "window", flash_mod.window_key(m["window"])
        else:
            count = "mask"
            key = "not_causal" if part == "encoder" else "causal"
        n = train[arch][f"flash_{count}_launches"][kernel].get(key, 0)
        if phase != "train":
            n += serve[arch][f"main_path_flash_{count}_launches"][
                kernel].get(key, 0)
        return n

    for tag, m in path_flash():
        times["flash_attention"][tag].update(
            max_abs_err=err_of(flash_cases, f"{tag} main path"),
            launches=shape_launches(tag, m, "flash_attention"))
        bwd_times[f"flash_attention_bwd {tag}"].update(
            max_abs_err=err_of(flash_bwd_cases, f"{tag} main path"),
            launches=shape_launches(tag, m, "flash_attention_bwd", "train"))
    for tag, _ in path_mm():
        mm_times[tag]["max_abs_err"] = err_of(mm_cases, f"{tag} main path")
    for arch in (*WIDE_ARCHS, *MOE_ARCHS, "gemma3-12b", *FRONTEND_ARCHS):
        kind = "gate" if _n_gate(get_config(arch)) else "head"
        mm_times[f"{arch} {kind}"].update(
            launches=arch_launches(arch, "matmul_epilogue"),
            launches_note="every launch on the arch's serve and train "
                          "paths, its gates and heads together")
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:104",
         "launches": path_launches("flash_attention"),
         "max_abs_err": err_of(flash_cases, "main path"),
         **flash_bound_ms(fm["b"], fm["hq"], fm["hkv"], fm["s"], fm["d"],
                          fm["causal"], fm["window"], torch.bfloat16),
         **times["flash_attention"]},
        {"name": "tsmm_upper", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tsmm.cu",
         "replaces": "src/repro/kernels/tsmm.py:101",
         "launches": linreg["tsmm_launches"],
         "entrypoints_launches": entry["linreg_ds"]["tsmm_launches"],
         "max_abs_err": err_of(tsmm_cases, "LinReg DS"),
         **tsmm_bound_ms(LINREG_M, LINREG_N, torch.float32),
         **times["tsmm_upper"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:102",
         "launches": path_launches("ssd_scan"),
         "max_abs_err": err_of(ssd_cases, "main path"),
         **ssd_times["mamba2"], "zamba2": ssd_times["zamba2"]},
        {"name": "matmul_epilogue", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul_epilogue.cu",
         "replaces": "src/repro/kernels/matmul_epilogue.py:116",
         "launches": path_launches("matmul_epilogue"),
         "body_launches": {
             body: sum(run["main_path_matmul_epilogue_bodies"].get(body, 0)
                       for run in serve.values())
             for body in ("wgmma", "small_m")},
         **mm_times["gate"],
         "head": mm_times["head"], "qwen_gate": mm_times["qwen_gate"],
         "qwen_head": mm_times["qwen_head"],
         "mamba_head": mm_times["mamba_head"],
         "decode_gate": mm_times["decode_gate"],
         "qwen_decode_gate": mm_times["qwen_decode_gate"],
         **{tag: mm_times[tag] for tag, _ in path_mm()}},
        {"name": "flash_attention_bwd", "route": "cuda", "backward": True,
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:104",
         "launches": path_launches("flash_attention_bwd"),
         "max_abs_err": err_of(flash_bwd_cases, "main path"),
         **bwd_times["flash_attention_bwd"],
         "d80": {**bwd_times["flash_attention_bwd_d80"],
                 "max_abs_err": err_of(flash_bwd_cases, "D = 80"),
                 "launches": train["zamba2-2.7b"]["launches"][
                     "flash_attention_bwd"]},
         **{tag: bwd_times[f"flash_attention_bwd {tag}"]
            for tag, _ in path_flash()}},
        {"name": "ssd_scan_bwd", "route": "cuda", "backward": True,
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:102",
         "launches": path_launches("ssd_scan_bwd"),
         "max_abs_err": err_of(ssd_bwd_cases, "main path"),
         **bwd_times["ssd_scan_bwd"],
         "zamba2": {**bwd_times["ssd_scan_bwd_zamba2"],
                    "max_abs_err": err_of(ssd_bwd_cases, "zamba2 main path"),
                    "launches": train["zamba2-2.7b"]["launches"][
                        "ssd_scan_bwd"]}},
    ]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
