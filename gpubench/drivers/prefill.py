"""Prefill traffic: a closed loop of ``clients`` into ``ServeEngine``'s
continuous batching, one new token per request, so that every ``step()`` is
one admission round: the prefill of up to ``slots`` queued requests, each
left-padded to the round's longest prompt.

Each client submits again as soon as its request returns.  With one token a
request and FIFO admission, round ``r`` takes requests ``slots * r`` to
``slots * r + slots - 1`` of the submission order, so the rounds follow
from the prompt stream alone (:class:`Prompts`) and not from timing.

A request's time to first token runs from its client's submit to the
return of the ``step()`` that answers it.  The window ends with the first
round that returns after ``--seconds``; the rate is the real prompt tokens
(padding not counted) of every request answered in the window over the
window's seconds, and the tail is over all of them.  The requests still
queued are then answered too, and every request must come back once with
a token of the vocabulary.

The check (:func:`check_sample`) takes the same number of answered
requests from each of a round's rows, drawn from the seed, the longest
prompt among them, so that a fault confined to one of the engine's slots
is in every sample.  With ``ctx.control`` the reference in the lower
precision is judged in the program's place, and the program's own numbers
are reported beside it.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_engine import EngineConfig, Request, ServeEngine

from gpubench.lib import compare, counters, trace, weights
from gpubench.lib.common import (Ctx, Outcome, clock, free, peak_bytes,
                                 reset_peak)


class Prompts:
    """The prompt stream.  Lengths come in epochs of ``epoch_requests``: the
    log-uniform quantiles over ``[min_prompt, max_prompt]``, split into
    rounds and the rounds ordered once by the mix's ``layout_seed``, the
    same every epoch and for every seed, so that every seed does the same
    work.  The run's seed orders the requests within each round and draws
    every token id."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        n, slots = mix["epoch_requests"], mix["slots"]
        lo, hi = mix["min_prompt"], mix["max_prompt"]
        q = (np.arange(n) + 0.5) / n
        lengths = np.rint(lo * (hi / lo) ** q).astype(np.int64)
        lengths = np.random.default_rng(mix["layout_seed"]).permutation(
            lengths)
        self.rounds = lengths.reshape(n // slots, slots)
        self.seed, self.vocab, self.n = seed, vocab, n
        self._epochs: Dict[int, np.ndarray] = {}

    def _epoch(self, e: int) -> np.ndarray:
        if e not in self._epochs:
            rng = np.random.default_rng([self.seed, e, 1])
            self._epochs[e] = np.concatenate(
                [rng.permutation(r) for r in self.rounds])
        return self._epochs[e]

    def length(self, k: int) -> int:
        return int(self._epoch(k // self.n)[k % self.n])

    def tokens(self, k: int) -> List[int]:
        rng = np.random.default_rng([self.seed, k, 2])
        return rng.integers(1, self.vocab, self.length(k)).tolist()

    def warm(self, length: int, i: int) -> List[int]:
        rng = np.random.default_rng([self.seed, i, 3])
        return rng.integers(1, self.vocab, length).tolist()


def check_sample(ks: Dict[int, int], lengths: Dict[int, int], slots: int,
                 n: int, seed: int) -> List[int]:
    """``n`` of the answered requests (request id -> submission index
    ``ks``, -> prompt length ``lengths``), drawn from ``seed``: the longest
    prompt, then the same share of each row of the rounds (row ``k %
    slots``), in rid order within a row before the draw."""
    longest = max(ks, key=lambda r: (lengths[r], -r))
    rng = np.random.default_rng([seed, 4])
    by_row = [sorted(r for r in ks if ks[r] % slots == row and r != longest)
              for row in range(slots)]
    per_row = max(1, (n - 1) // slots)
    pick = [longest]
    for rows in by_row:
        if rows:
            pick += [int(r) for r in rng.choice(
                rows, min(per_row, len(rows)), replace=False)]
    return pick


def run(ctx: Ctx) -> Outcome:
    dev, seed, mix, cfg = ctx.device, ctx.seed, ctx.mix, ctx.cfg
    vocab = cfg["vocab_size"]
    model = build_model(weights.arch_config(cfg), dev)
    params, leaves = weights.make(model, seed, dev)
    engine = ServeEngine(model, params, EngineConfig(
        batching="continuous", slots=mix["slots"], max_len=mix["max_len"]))
    prompts = Prompts(mix, seed, vocab)
    new = mix["max_new_tokens"]

    # warm-up: one round at each padded length the traffic makes (every
    # epoch's rounds are the same), the longest first so that the
    # allocator's pool is sized at once; they build and load the kernels
    for i, length in enumerate(sorted({int(r.max()) for r in prompts.rounds},
                                      reverse=True)):
        for j in range(mix["slots"]):
            engine.submit(Request(prompts.warm(length, i * 1000 + j), new))
        while engine.pending_requests:
            engine.step()
    setup_peak = peak_bytes(dev)

    submitted: Dict[int, tuple] = {}           # rid -> (k, submit time)
    answered: Dict[int, tuple] = {}            # rid -> (ttft, tokens, round)
    rounds: List[tuple] = []                   # (rows, padded length, real)

    def submit(k: int) -> None:
        prompt = prompts.tokens(k)
        rid = engine.submit(Request(prompt, new))
        submitted[rid] = (k, time.perf_counter())

    ops.reset_launch_counts()
    reset_peak(dev)
    t_ready = clock(dev)
    setup_s = t_ready - ctx.t_start
    with trace.traced(ctx.trace) as prof:
        with trace.window_span():
            t0 = clock(dev)
            for k in range(mix["clients"]):
                submit(k)
            while True:
                with record_function("bench.engine_step"):
                    done = engine.step()
                t = time.perf_counter()
                lens = [len(c.prompt) for c in done]
                for c in done:
                    answered[c.rid] = (t - submitted[c.rid][1], c.tokens,
                                       len(rounds))
                rounds.append((len(done), max(lens, default=0), sum(lens)))
                if t - t0 >= ctx.seconds:
                    break
                for _ in done:
                    submit(len(submitted))
    window_s = t - t0
    launches = ops.launch_counts()
    window_peak = peak_bytes(dev)
    summary = trace.reduce(prof) if prof is not None else None
    in_window = dict(answered)
    while engine.pending_requests:              # the queue, answered late
        for c in engine.step():
            answered[c.rid] = (None, c.tokens, None)
    del prof, engine
    params = None
    free(dev)

    failed = sum(1 for rid in submitted if rid not in answered
                 or len(answered[rid][1]) != new
                 or not all(0 <= tok < vocab for tok in answered[rid][1]))
    ttft = np.array([a[0] for a in in_window.values()])
    real = sum(r[2] for r in rounds)

    # the reference over a seeded sample of the answered requests, with
    # the longest prompt in it, each as the engine prefilled it
    ref = ctx.reference
    pick = check_sample(
        {r: submitted[r][0] for r in in_window},
        {r: prompts.length(submitted[r][0]) for r in in_window},
        mix["slots"], ctx.checks["sample"], seed)
    w = {leaf.path: weights.draw(leaf, seed, dev).float() for leaf in leaves}
    precs = [ref.Precision("fp32")] + (
        [ref.Precision(ctx.control)] if ctx.control else [])
    gaps, ctl_gaps = [], []
    t_ref = time.perf_counter()
    for rid in pick:
        k = submitted[rid][0]
        plen = rounds[in_window[rid][2]][1]
        row = [0] * (plen - prompts.length(k)) + prompts.tokens(k)
        toks = torch.tensor(row, dtype=torch.long, device=dev)
        logits = ref.last_logits(cfg, w, toks, precs[0])
        gaps.append(compare.served_gap(logits, in_window[rid][1][0]))
        if ctx.control:
            lower = ref.last_logits(cfg, w, toks, precs[1])
            ctl_gaps.append(compare.served_gap(logits, int(lower.argmax())))
    ref_s = time.perf_counter() - t_ref
    del w
    free(dev)
    numbers = {"served_gap": {"value": max(gaps), "requests": len(gaps)}}
    extra = {"reference_s": ref_s}
    if ctx.control:
        extra["program"] = {k: v["value"] for k, v in numbers.items()}
        numbers = {"served_gap": {"value": max(ctl_gaps),
                                  "requests": len(ctl_gaps),
                                  "of": f"control {ctx.control}"}}
    correct, checks = compare.judge(numbers, ctx.checks["limits"])

    n_mamba, n_attn = counters.mamba_layers(cfg), counters.attn_applications(
        cfg)
    ssd_least = flash_least = None
    if n_mamba and launches["ssd_scan"] == n_mamba * len(rounds):
        sh = counters.ssd_shape(cfg)
        ssd_least = n_mamba * sum(counters.least_seconds(*counters.ssd_fwd(
            b, s, sh["h"], sh["p"], sh["g"], sh["n"], sh["chunk"], init=True))
            for b, s, _ in rounds)
    if n_attn and launches["flash_attention"] == n_attn * len(rounds):
        nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
        hd = cfg.get("head_dim") or cfg["d_model"] // nh
        flash_least = n_attn * sum(counters.least_seconds(
            *counters.flash_fwd(b, nh, nkv, s, hd)) for b, s, _ in rounds)
    flops = sum(counters.prefill_flops(cfg, prompts.length(submitted[r][0]))
                for r in in_window)
    padded = sum(b * s for b, s, _ in rounds)
    return Outcome(
        end_to_end={"prefill_tokens_per_s": real / window_s,
                    "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
                    "setup_s": setup_s},
        readout={"mode": "prefill", "window_s": window_s, "summary": summary,
                 "model_flops": flops, "ssd_least_s": ssd_least,
                 "flash_least_s": flash_least, "padded_positions": padded,
                 "real_positions": real, "peak_mem_bytes": window_peak},
        attempted=len(submitted), failed=failed,
        correct=correct and failed == 0, checks=checks,
        memory_peak_bytes=max(setup_peak, window_peak), summary=summary,
        extra=extra)
