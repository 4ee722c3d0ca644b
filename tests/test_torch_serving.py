"""The port's serve engine on the CPU: the reference's five engine cases
(tests/test_serving.py) on the port, and token streams identical to the
reference engine's at temperature 0 from the same weights, for qwen1.5-0.5b
and mamba2-1.3b (reduced, fp32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import build_model as ref_build_model
from repro.runtime import serve_engine as RS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_engine import (Completion, EngineConfig,
                                              Request, ServeEngine)


def _tiny():
    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               dtype="float32")


@pytest.fixture(scope="module")
def setup():
    ref_cfg = dataclasses.replace(ref_get_config("qwen1.5-0.5b").reduced(),
                                  dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params)
    cfg = _tiny()
    model = build_model(cfg, device="cpu")
    return ref_model, ref_params, model, params_from_numpy(tree, cfg, "cpu")


def test_prefill_decode_matches_forward(setup):
    _, _, model, params = setup
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, 24)))
    logits_full, _ = model.forward(params, tokens)
    cache = model.init_cache(2, 24)
    lg, cache = model.prefill(params, tokens[:, :16], cache)
    np.testing.assert_allclose(lg.numpy(), logits_full[:, 15].numpy(),
                               rtol=1e-4, atol=1e-4)
    for t in range(16, 24):
        lg, cache = model.decode_step(params, tokens[:, t], cache)
        np.testing.assert_allclose(lg.numpy(), logits_full[:, t].numpy(),
                                   rtol=1e-4, atol=2e-4)


def test_engine_greedy_deterministic(setup):
    _, _, model, params = setup
    engine = ServeEngine(model, params, max_len=64)
    reqs = [Request(prompt=[5, 6, 7, 8], max_new_tokens=8),
            Request(prompt=[9, 10, 11], max_new_tokens=8)]
    out1 = engine.generate(reqs)
    out2 = engine.generate(reqs)
    assert [c.tokens for c in out1] == [c.tokens for c in out2]
    assert all(len(c.tokens) == 8 for c in out1)
    assert all(isinstance(c, Completion) and c.prefill_time_s > 0 for c in out1)


def test_engine_eos_stops_early(setup):
    _, _, model, params = setup
    engine = ServeEngine(model, params, max_len=64)
    base = engine.generate([Request(prompt=[3, 4, 5], max_new_tokens=8)])[0]
    eos = base.tokens[2]
    first = base.tokens.index(eos)
    out = engine.generate([Request(prompt=[3, 4, 5], max_new_tokens=8,
                                   eos_id=int(eos))])[0]
    assert out.tokens == base.tokens[:first + 1]


def test_engine_config_and_continuous_batching(setup):
    with pytest.raises(ValueError):
        EngineConfig(batching="sometimes")
    with pytest.raises(ValueError):
        EngineConfig(slots=0)
    _, _, model, params = setup
    reqs = [Request(prompt=[5, 6, 7, 8], max_new_tokens=4),
            Request(prompt=[9, 10, 11], max_new_tokens=4),
            Request(prompt=[3, 4, 5], max_new_tokens=4)]
    # legacy kwargs == explicit config
    static = ServeEngine(model, params, max_len=64).generate(reqs)
    cfgd = ServeEngine(model, params, EngineConfig(max_len=64)).generate(reqs)
    assert [c.tokens for c in cfgd] == [c.tokens for c in static]
    # degenerate continuous schedule: slots cover the batch
    wide = ServeEngine(model, params,
                       EngineConfig(max_len=64, batching="continuous",
                                    slots=3))
    assert [c.tokens for c in wide.generate(reqs)] == \
        [c.tokens for c in static]
    assert wide.stats["admission_rounds"] == 1
    # 2 slots over 3 requests: a refill round must happen, all complete
    narrow = ServeEngine(model, params,
                         EngineConfig(max_len=64, batching="continuous",
                                      slots=2))
    out1 = narrow.generate(reqs)
    assert all(len(c.tokens) == 4 for c in out1)
    assert narrow.stats["admission_rounds"] >= 2
    assert [c.tokens for c in narrow.generate(reqs)] == \
        [c.tokens for c in out1]          # deterministic from run to run
    # submit()/run() matches generate() and reports rids in order
    for r in reqs:
        narrow.submit(r)
    drained = narrow.run()
    assert [c.rid for c in drained] == sorted(c.rid for c in drained)
    assert [c.tokens for c in drained] == [c.tokens for c in out1]


def test_engine_masks_finished_slots_and_reports_per_request_decode(setup):
    _, _, model, params = setup
    engine = ServeEngine(model, params, max_len=64)
    base = engine.generate([Request(prompt=[5, 6, 7, 8], max_new_tokens=8),
                            Request(prompt=[9, 10, 11], max_new_tokens=8)])
    eos = base[0].tokens[1]
    if eos == base[0].tokens[0]:
        pytest.fail("seed gives a repeated first token; pick another prompt")
    engine2 = ServeEngine(model, params, max_len=64)
    out = engine2.generate(
        [Request(prompt=[5, 6, 7, 8], max_new_tokens=8, eos_id=int(eos)),
         Request(prompt=[9, 10, 11], max_new_tokens=8)])
    assert out[0].tokens == base[0].tokens[:2]     # stopped at eos
    assert out[1].tokens == base[1].tokens         # unaffected neighbour
    assert engine2.stats["wasted_slot_steps"] > 0
    assert out[0].decode_time_s < out[1].decode_time_s


REQS = [([5, 6, 7, 8], 6), ([9, 10, 11], 8), ([3, 4, 5, 200, 17], 5),
        ([42], 7), ([100, 101], 6)]


@pytest.mark.parametrize("engine_kw", [
    dict(batching="static"),
    dict(batching="continuous", slots=2),
    dict(batching="continuous", slots=3),
], ids=["static", "continuous-2", "continuous-3"])
def test_token_streams_identical_to_the_reference_engine(setup, engine_kw):
    """Greedy decoding from the same weights: every token of every request,
    the stats and the order of completion are the reference engine's."""
    ref_model, ref_params, model, params = setup
    ref_engine = RS.ServeEngine(ref_model, ref_params,
                                RS.EngineConfig(max_len=64, **engine_kw))
    engine = ServeEngine(model, params, EngineConfig(max_len=64, **engine_kw))
    ref_out = ref_engine.generate(
        [RS.Request(prompt=p, max_new_tokens=n) for p, n in REQS])
    out = engine.generate([Request(prompt=p, max_new_tokens=n)
                           for p, n in REQS])
    assert [c.tokens for c in out] == [c.tokens for c in ref_out]
    assert [c.rid for c in out] == [c.rid for c in ref_out]
    assert engine.stats == ref_engine.stats


def test_kernel_route_gives_the_same_streams_on_the_cpu(setup):
    """use_kernel=True on CPU tensors takes the kernel's plain version."""
    _, _, model, params = setup
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in REQS]
    base = ServeEngine(model, params, max_len=64)
    assert base.use_kernel is False                 # decided by the device
    forced = ServeEngine(model, params, max_len=64, use_kernel=True)
    assert [c.tokens for c in forced.generate(reqs)] == \
        [c.tokens for c in base.generate(reqs)]


def test_sampling_at_temperature_is_seeded(setup):
    _, _, model, params = setup
    reqs = [Request(prompt=[5, 6, 7, 8], max_new_tokens=8),
            Request(prompt=[9, 10, 11], max_new_tokens=8)]
    cfg = EngineConfig(max_len=64, temperature=1.0, seed=3)
    a = ServeEngine(model, params, cfg).generate(reqs)
    b = ServeEngine(model, params, cfg).generate(reqs)
    c = ServeEngine(model, params, dataclasses.replace(cfg, seed=4)
                    ).generate(reqs)
    greedy = ServeEngine(model, params, max_len=64).generate(reqs)
    assert [x.tokens for x in a] == [x.tokens for x in b]
    assert [x.tokens for x in a] != [x.tokens for x in c]
    assert [x.tokens for x in a] != [x.tokens for x in greedy]


def test_frontend_is_not_ported(setup):
    """Frontend features are single-admission only, as in the reference: a
    later admission round given them raises ``NotImplementedError`` (an
    arch without a frontend ignores them at the first, as the reference's
    model does; the frontend archs are
    tests/test_torch_frontend_archs.py's).  The name dates from before the
    frontend was ported and is kept so that the test keeps its history."""
    _, _, model, params = setup
    reqs = [Request(prompt=[1, 2], max_new_tokens=2),
            Request(prompt=[3, 4, 5], max_new_tokens=4),
            Request(prompt=[6], max_new_tokens=2)]
    static = ServeEngine(model, params, max_len=64)
    assert [c.tokens for c in static.generate(
        reqs, frontend=torch.zeros(3, 2, 64))] == \
        [c.tokens for c in static.generate(reqs)]
    engine = ServeEngine(model, params, EngineConfig(
        max_len=64, batching="continuous", slots=2))
    for r in reqs:
        engine.submit(r)
    with pytest.raises(NotImplementedError, match="single-admission"):
        for _ in range(10):
            engine.step(torch.zeros(2, 2, 64))
    assert engine.stats["admission_rounds"] == 1


# ------------------------------------------------------------- mamba2
@pytest.fixture(scope="module")
def mamba_setup():
    ref_cfg = dataclasses.replace(ref_get_config("mamba2-1.3b").reduced(),
                                  dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params)
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              dtype="float32")
    model = build_model(cfg, device="cpu")
    return ref_model, ref_params, model, params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("engine_kw", [
    dict(batching="static"),
    dict(batching="continuous", slots=2),
    dict(batching="continuous", slots=3),
], ids=["static", "continuous-2", "continuous-3"])
def test_mamba_token_streams_identical_to_the_reference_engine(mamba_setup,
                                                               engine_kw):
    """Every history the engines prefill here is at most 13 tokens, less
    than the reduced chunk of 32, which the reference's scan accepts."""
    ref_model, ref_params, model, params = mamba_setup
    ref_engine = RS.ServeEngine(ref_model, ref_params,
                                RS.EngineConfig(max_len=64, **engine_kw))
    engine = ServeEngine(model, params, EngineConfig(max_len=64, **engine_kw))
    ref_out = ref_engine.generate(
        [RS.Request(prompt=p, max_new_tokens=n) for p, n in REQS])
    out = engine.generate([Request(prompt=p, max_new_tokens=n)
                           for p, n in REQS])
    assert [c.tokens for c in out] == [c.tokens for c in ref_out]
    assert [c.rid for c in out] == [c.rid for c in ref_out]
    assert engine.stats == ref_engine.stats


def test_mamba_kernel_route_gives_the_same_streams_on_the_cpu(mamba_setup):
    _, _, model, params = mamba_setup
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in REQS]
    base = ServeEngine(model, params, EngineConfig(
        max_len=64, batching="continuous", slots=2))
    forced = ServeEngine(model, params, EngineConfig(
        max_len=64, batching="continuous", slots=2), use_kernel=True)
    assert base.use_kernel is False and forced.use_kernel is True
    assert [c.tokens for c in forced.generate(reqs)] == \
        [c.tokens for c in base.generate(reqs)]
    assert forced.stats["admission_rounds"] >= 2
