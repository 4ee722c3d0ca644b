"""The readers of the program's spans and counters (``repro_torch.tracing``):
no reading without the trace, in the other mode, without device time (the
CPU) or from a program without the recorder; the arithmetic on totals that
have device seconds.  On the card (``-m gpu``): one traced train step and
one traced prefill round give each kernel wrapper's span as many calls as
``ops.launch_counts()`` counts, and the device trace names no program span
among its kernels.

    python -m pytest -q gpubench/tests/test_gpubench_spans.py
"""
import sys
import time

import pytest
import torch

from conftest import tiny_checks, tiny_config, tiny_mix
from gpubench.lib import cli, spec
from gpubench.lib.trace import TraceSummary
import repro_torch
from repro_torch import tracing

S = spec.load()
READERS = {
    "stack_grad_share.train": "train",
    "optimizer_share.train": "train",
    "ssd_call_roofline.train": "train",
    "ssd_call_roofline.prefill": "prefill",
    "queue_wait_share.prefill": "prefill",
    "engine_padding_share.prefill": "prefill",
}
OTHER = {"train": "prefill", "prefill": "train"}


def readout(mode, busy=1.0):
    summary = TraceSummary(window_s=10.0, busy_s=busy, kernels={}, gaps=[])
    return {"mode": mode, "window_s": 10.0, "summary": summary,
            "ssd_least_s": 0.5}


FAKE = {  # device seconds, host seconds, counter values
    "model.stack_grad": tracing.Total(48, 1.0, 1.2, 0),
    "train.optimizer": tracing.Total(1, 0.1, 0.5, 0),
    "kernel.ssd_scan": tracing.Total(96, 0.1, 2.0, 0),
    "kernel.ssd_scan_bwd": tracing.Total(48, 0.1, 3.0, 0),
    "serve.queued": tracing.Total(16, 3.0, None, 0),
    "serve.request": tracing.Total(16, 6.0, None, 0),
    "serve.prompt_positions": tracing.Total(2, 0.0, None, 30),
    "serve.prefill_positions": tracing.Total(2, 0.0, None, 40),
}
WANT = {
    "stack_grad_share.train": 12.0,
    "optimizer_share.train": 5.0,
    "ssd_call_roofline.train": 10.0,
    "ssd_call_roofline.prefill": 25.0,
    "queue_wait_share.prefill": 50.0,
    "engine_padding_share.prefill": 25.0,
}


def test_every_new_reader_is_in_the_benchmark_with_its_cell():
    entries = {m["name"]: m for m in S["per_layer"]}
    for name, mode in READERS.items():
        assert entries[name]["workloads"] == [
            w["name"] for w in S["workloads"] if mode in w["traffic"]]
        assert entries[name]["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_arithmetic_on_totals_with_device_seconds(name, monkeypatch):
    monkeypatch.setattr(tracing, "total", FAKE.get)
    r = spec.metric_reader(name)
    assert r.read(readout(READERS[name])) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_no_reading_untraced_in_the_other_mode_or_without_the_recorder(
        name, monkeypatch):
    monkeypatch.setattr(tracing, "total", FAKE.get)
    r = spec.metric_reader(name)
    mode = READERS[name]
    untraced = readout(mode)
    untraced["summary"] = None
    assert r.read(untraced) is None
    assert r.read(readout(OTHER[mode])) is None
    assert r.read(readout(mode, busy=0.0)) is None      # no device time
    # a program without the recorder (the parent commit's)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    assert r.read(readout(mode)) is None


@pytest.mark.parametrize("cell", [w["name"] for w in S["workloads"]])
def test_a_traced_cpu_run_reads_none_of_them(cell):
    """On the CPU the spans record host times only: the traced run's line
    leaves every new metric out."""
    w = spec.cell(S, cell)
    cfg = tiny_config(spec.config_file(S, w["config"]))
    cfg["dtype"] = "float32"
    tracing.reset()
    out, metrics = cli.run_cell(
        S, cell, 7, 0.2, True, torch.device("cpu"), time.perf_counter(),
        cfg=cfg, mix=tiny_mix(spec.traffic_file(w["traffic"])),
        checks=tiny_checks(spec.checks_file(cell)))
    assert out.correct
    assert not set(metrics) & set(READERS)
    assert tracing.totals()                       # the spans did record


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_wrapper_spans_count_the_launches_and_stay_off_the_kernels(
        mode, need_gpu):
    from torch.profiler import ProfilerActivity, profile

    from gpubench.lib import trace, weights
    from repro_torch.core import ShardingPlan
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.serve_engine import (EngineConfig, Request,
                                                  ServeEngine)
    dev = torch.device("cuda", 0)
    cfg = tiny_config(spec.config_file(S, "mamba2-1.3b"))
    cfg["ssm"].update(head_dim=64, state_size=128, chunk_size=256)
    model = build_model(weights.arch_config(cfg), dev)
    params, _ = weights.make(model, 3, dev)
    if mode == "train":
        opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
        step = train_loop.make_train_step(
            model, opt, ShardingPlan(remat="full"), use_kernel=True)
        state = adamw.init(opt, params)
        tok = weights.tokens(3, 1, 2, 512, cfg["vocab_size"], dev)

        def work():
            step(params, state, None, {"tokens": tok})
    else:
        engine = ServeEngine(model, params, EngineConfig(
            batching="continuous", slots=4, max_len=512))

        def work():
            for n in (100, 300, 511, 7):
                engine.submit(Request([1 + i % 255 for i in range(n)], 1))
            engine.step()
    work()                                       # build and load
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.window_span():
            work()
            torch.cuda.synchronize()
    launches = ops.launch_counts()
    tot = tracing.totals()
    spans = dict.fromkeys(launches, 0)
    for (n, _), t in tot.items():         # a wrapper's spans, every parent
        if n.startswith("kernel."):
            spans[n[len("kernel."):]] += t.calls
    assert spans == launches and launches["ssd_scan"] > 0
    assert all(t.device_s is not None for (n, _), t in tot.items()
               if n.startswith("kernel."))
    names = {n for n, _ in tot}
    summary = trace.reduce(prof)
    assert summary.kernels
    assert not [k for k in summary.kernels if k in names or any(
        k.startswith(n) for n in names)]
