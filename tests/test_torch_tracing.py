"""The port's recorder (``repro_torch.tracing``) on the CPU: off, it records
nothing and never enters ``record_function``; under ``torch.profiler`` a
tiny mamba2 train step records the train step's phases, the Mamba2 block's
parts (forward apart from the recompute) and one ``model.stack_grad`` a
layer around the slices' gradient fills and adds, and a closed loop on the
serve engine records its rounds, each request's queue wait and the padded
and real positions."""
import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core import ShardingPlan
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import train_loop
from repro_torch.runtime.serve_engine import (EngineConfig, Request,
                                              ServeEngine)

MAMBA = ("in_proj", "conv", "ssd", "gate_norm", "out_proj")


def _mamba(layers=2):
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              dtype="float32", n_layers=layers)
    model = build_model(cfg, device="cpu")
    return model, model.init(seed=0)


def _train_step(model, params, remat="full"):
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    step = train_loop.make_train_step(model, opt, ShardingPlan(remat=remat),
                                      use_kernel=True)
    tok = torch.randint(1, model.cfg.vocab_size, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    return lambda: step(params, adamw.init(opt, params), None,
                        {"tokens": tok})


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []

    class Counting(torch.autograd.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(tracing._profiler, "record_function", Counting)
    model, params = _mamba()
    step = _train_step(model, params)
    step()
    engine = ServeEngine(model, params, EngineConfig(
        batching="continuous", slots=2, max_len=32))
    for n in (5, 9, 3):
        engine.submit(Request(list(range(1, n + 1)), 2))
    engine.run()
    assert entered == [] and tracing.totals() == {} and tracing.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    assert "train.backward" in entered and "model.stack_grad" in entered


def test_a_train_step_records_its_phases_the_blocks_and_the_stack_grad():
    layers = 2
    model, params = _mamba(layers)
    step = _train_step(model, params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    tot = tracing.totals()
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert tot[(name, None)].calls == 1, name
        assert tot[(name, None)].device_s is None      # no CUDA here
    for part in MAMBA:
        # the forward, and the recompute under remat full in the backward
        assert tot[(f"mamba.{part}", "train.forward")].calls == layers
        assert tot[(f"mamba.{part}", "train.backward")].calls == layers
    assert tot[("model.stack_grad", "train.backward")].calls == layers
    stacked = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params["blocks"]))
    assert tot[("model.stack_grad_bytes", "train.forward")].value == \
        layers * stacked
    # the engine runs body i, then layer i's selects, then body i-1: each
    # stack_grad span lies between two layers' recomputes
    order = [s.name for s in tracing.spans()
             if s.parent == "train.backward"
             and s.name in ("mamba.in_proj", "model.stack_grad")]
    assert order == ["mamba.in_proj", "model.stack_grad"] * layers
    # and each slice's gradient (its select's backward) runs inside one: a
    # layer's stacked leaves each once (the conv's w[i] are the body's)
    ev = prof.events()
    grad = [(e.time_range.start, e.time_range.end) for e in ev
            if e.name == "model.stack_grad"]
    inside = [e for e in ev if e.name == "aten::select_backward" and any(
        a <= e.time_range.start and e.time_range.end <= b for a, b in grad)]
    assert len(grad) == layers
    assert len(inside) == layers * len(tree_leaves(params["blocks"]))
    assert "train.backward/model.stack_grad" in tracing.report()


def test_remat_none_still_times_each_layer():
    model, params = _mamba(3)
    step = _train_step(model, params, remat="none")
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    tot = tracing.totals()
    assert tot[("model.stack_grad", "train.backward")].calls == 3
    assert ("mamba.ssd", "train.backward") not in tot


def _closed_loop(engine, lengths, clients, rounds):
    """``clients`` closed-loop clients, one token a request: every step is
    one admission round.  Returns the rounds' (rows, padded, real)."""
    k = 0
    want = []

    def submit():
        nonlocal k
        engine.submit(Request(list(range(1, lengths[k % len(lengths)] + 1)),
                              1))
        k += 1

    for _ in range(clients):
        submit()
    for _ in range(rounds):
        done = engine.step()
        lens = [len(c.prompt) for c in done]
        want.append((len(done), max(lens), sum(lens)))
        for _ in done:
            submit()
    return want


def test_a_serve_loop_records_its_rounds_queue_and_positions():
    model, params = _mamba()
    engine = ServeEngine(model, params, EngineConfig(
        batching="continuous", slots=2, max_len=32))
    with profile(activities=[ProfilerActivity.CPU]):
        rounds = _closed_loop(engine, [5, 11, 7, 3, 9], clients=4, rounds=5)
    tot = tracing.totals()
    assert tot[("serve.admit", None)].calls == 5
    for child in ("init_cache", "prefill", "sample"):
        assert tot[(f"serve.{child}", "serve.admit")].calls == 5
    assert ("serve.decode", None) not in tot          # one token a request
    assert tot[("serve.prefill_positions", "serve.admit")].value == sum(
        b * s for b, s, _ in rounds)
    assert tot[("serve.prompt_positions", "serve.admit")].value == sum(
        r for _, _, r in rounds)
    queued = {s.rid: s for s in tracing.spans() if s.name == "serve.queued"}
    request = {s.rid: s for s in tracing.spans()
               if s.name == "serve.request"}
    assert set(queued) == set(request) == set(range(10))
    for rid, q in queued.items():
        r = request[rid]
        assert q.start_ns == r.start_ns <= q.end_ns <= r.end_ns
    # clients 2 and 3 wait a round behind clients 0 and 1
    assert queued[2].end_ns > request[0].end_ns
    assert tot[("serve.queued", None)].host_s < \
        tot[("serve.request", None)].host_s


def test_decode_steps_are_spans_and_times_keep_their_meaning():
    model, params = _mamba()
    engine = ServeEngine(model, params, EngineConfig(max_len=32))
    with profile(activities=[ProfilerActivity.CPU]):
        out = engine.generate([Request([1, 2, 3], 4), Request([4, 5], 2)])
    tot = tracing.totals()
    assert tot[("serve.decode", None)].calls == engine.stats["decode_steps"]
    assert sorted({s.rid for s in tracing.spans()
                   if s.name == "serve.request"}) == [0, 1]
    assert all(c.prefill_time_s > 0 and c.decode_time_s > 0 for c in out)


def test_spans_nest_by_thread_and_adopt_across_threads():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", adopt=True):
            with tracing.span("inner"):
                tracing.count("n", 3)

            def other():
                with tracing.span("worker"):
                    pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with tracing.span("after"):
            pass
        tracing.record("req", 10, 30, rid=7)
    tot = tracing.totals()
    assert set(tot) == {("outer", None), ("inner", "outer"),
                        ("n", "outer/inner"), ("worker", "outer"),
                        ("after", None), ("req", None)}
    assert tot[("n", "outer/inner")].value == 3
    assert tot[("req", None)].host_s == pytest.approx(20e-9)
    assert [s.rid for s in tracing.spans() if s.name == "req"] == [7]


def test_past_the_fold_threshold_memory_stays_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "_FOLD_AT", 8)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(100):
            with tracing.span("s"):
                pass
            assert len(tracing._REC._pending) <= 8
    assert tracing.totals()[("s", None)].calls == 100
