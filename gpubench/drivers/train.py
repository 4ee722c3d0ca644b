"""Training traffic: ``make_train_step`` (the kernel path, donated weights
and moments) on a fresh batch of random tokens each step, drawn from the
seed.

Set-up builds the one step object and drives it through the mix's first
``check_steps`` steps (rows all differ; the same call and feed the window
uses); they build and load the kernels and size the allocator.  Their
losses, the first step's gradient norms (from AdamW's first moment) and the
weights' change over them are what the reference is held to, once the
window has closed and the program's state is freed.  The window then runs
whole steps until ``--seconds`` have passed; the rate is every token of
every step completed over the window's seconds.

With ``ctx.control`` the reference in the lower precision is judged in the
program's place, and the program's own numbers are reported beside it.
"""
from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from repro_torch.core import ShardingPlan
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

from gpubench.lib import compare, counters, trace, weights
from gpubench.lib.common import (Ctx, Outcome, clock, free, peak_bytes,
                                 reset_peak)


def _diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| in fp32, a leading slice at a time."""
    if a.dim() < 3:
        return float(torch.linalg.vector_norm(a.float() - b.float()))
    return math.sqrt(sum(float(torch.linalg.vector_norm(
        a[i].float() - b[i].float())) ** 2 for i in range(a.shape[0])))


def run(ctx: Ctx) -> Outcome:
    dev, seed, mix, cfg = ctx.device, ctx.seed, ctx.mix, ctx.cfg
    rows, seq, vocab = mix["rows"], mix["seq"], cfg["vocab_size"]
    n_check = ctx.checks["check_steps"]
    model = build_model(weights.arch_config(cfg), dev)
    params, leaves = weights.make(model, seed, dev)
    opt_cfg = adamw.AdamWConfig(**mix["adamw"])
    step = train_loop.make_train_step(
        model, opt_cfg, ShardingPlan(remat=mix["remat"]), use_kernel=True,
        donate=True)
    state = {"params": params, "opt": adamw.init(opt_cfg, params)}
    del params

    def one(k: int):
        batch = {"tokens": weights.tokens(seed, k, rows, seq, vocab, dev)}
        state["params"], state["opt"], _, metrics = step(
            state["params"], state["opt"], None, batch)
        return metrics

    losses, grad1 = [], {}
    for k in range(1, n_check + 1):
        losses.append(float(one(k)["loss"]))
        if k == 1:
            for leaf, m in zip(leaves, adamw.tree_leaves(state["opt"].m)):
                grad1[leaf.path] = float(torch.linalg.vector_norm(
                    m.float())) / (1 - opt_cfg.b1)
            del m
    change = {leaf.path: _diff_norm(p, weights.draw(leaf, seed, dev))
              for leaf, p in zip(leaves, adamw.tree_leaves(state["params"]))}
    setup_peak = peak_bytes(dev)

    ops.reset_launch_counts()
    reset_peak(dev)
    t_ready = clock(dev)
    setup_s = t_ready - ctx.t_start
    steps, nonfinite = 0, 0
    with trace.traced(ctx.trace) as prof:
        with trace.window_span():
            t0 = clock(dev)
            while True:
                with record_function("bench.train_step"):
                    loss = float(one(n_check + 1 + steps)["loss"])
                    t = clock(dev)
                steps += 1
                nonfinite += not math.isfinite(loss)
                if t - t0 >= ctx.seconds:
                    break
    window_s = t - t0
    launches = ops.launch_counts()
    window_peak = peak_bytes(dev)
    summary = trace.reduce(prof) if prof is not None else None
    del prof, step, state, one
    free(dev)

    # the reference, from the same weights and batches
    ref = ctx.reference
    w0 = {leaf.path: weights.draw(leaf, seed, dev) for leaf in leaves}
    batches = [weights.tokens(seed, k, rows, seq, vocab, dev)
               for k in range(1, n_check + 1)]
    t_ref = time.perf_counter()
    out = ref.train(cfg, w0, batches, mix["adamw"], ref.Precision("fp32"))
    ref_s = time.perf_counter() - t_ref
    numbers = compare.train_numbers(losses, grad1, change, out)
    extra = {"reference_s": ref_s, "losses": losses,
             "reference_losses": out["losses"]}
    if ctx.control:
        extra["program"] = {k: v["value"] for k, v in numbers.items()}
        ctl = ref.train(cfg, w0, batches, mix["adamw"],
                        ref.Precision(ctx.control))
        numbers = compare.train_numbers(ctl["losses"], ctl["grad1"],
                                        ctl["change"], out)
        for v in numbers.values():
            v["of"] = f"control {ctx.control}"
    correct, checks = compare.judge(numbers, ctx.checks["limits"])
    del w0, batches, out
    free(dev)

    sh = counters.ssd_shape(cfg)
    ssd_least = (launches["ssd_scan"] * counters.least_seconds(
        *counters.ssd_fwd(rows, seq, sh["h"], sh["p"], sh["g"], sh["n"],
                          sh["chunk"]))
        + launches["ssd_scan_bwd"] * counters.least_seconds(
            *counters.ssd_bwd(rows, seq, sh["h"], sh["p"], sh["g"], sh["n"],
                              sh["chunk"]))) if counters.mamba_layers(cfg) \
        else None
    flash_least = None
    if counters.attn_applications(cfg):
        nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
        hd = cfg.get("head_dim") or cfg["d_model"] // nh
        flash_least = (
            launches["flash_attention"] * counters.least_seconds(
                *counters.flash_fwd(rows, nh, nkv, seq, hd))
            + launches["flash_attention_bwd"] * counters.least_seconds(
                *counters.flash_bwd(rows, nh, nkv, seq, hd)))
    tokens = steps * rows * seq
    return Outcome(
        end_to_end={"train_tokens_per_s": tokens / window_s,
                    "setup_s": setup_s},
        readout={"mode": "train", "window_s": window_s, "summary": summary,
                 "model_flops": steps * counters.train_step_flops(
                     cfg, rows, seq),
                 "ssd_least_s": ssd_least, "flash_least_s": flash_least,
                 "peak_mem_bytes": window_peak},
        attempted=steps, failed=nonfinite, correct=correct and not nonfinite,
        checks=checks, memory_peak_bytes=max(setup_peak, window_peak),
        summary=summary, extra=extra)
