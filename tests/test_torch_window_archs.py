"""The window-pattern arch ``gemma3-12b`` in the port against the reference
on the CPU.

``tests/test_models_smoke.py``'s ``test_forward_and_train_step`` and
``test_decode_cache_shapes`` on ``.reduced()`` (4 layers, window pattern
``(8, None)``: two cycles of a local layer of window 8 and a global one) in
fp32: the reference's init params go through numpy into the port's tree (a
list of one block dict a position of the pattern, each leaf stacked over
the cycles), the same tokens through both.  ``.reduced()`` sets
``n_kv_heads = n_heads``; the same checks run again at 4 heads over 2 kv
heads, on the port's kernel path too (whose wrappers take their plain
versions on CPU tensors).

The local layers keep a ring of ``min(window, max_len)`` slots.  The
reference's prefill keeps the last ``cap`` keys of a prompt of ``s >= cap``
tokens at slots 0 to cap - 1, where its decode writes position ``p`` at
slot ``p % cap``: the two agree only when ``s % cap == 0``, and otherwise
its decode departs from its own ``forward``.  The port places position
``p`` at slot ``p % cap`` in prefill too and follows ``forward``:
:func:`test_prefill_decode_matches_forward` shows both.

Tolerance: rtol 1e-4, atol 2e-4 on logits (tests/test_torch_model.py's);
the loss within 2e-5, each gradient leaf within 1e-4 of its largest
magnitude (fp32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.runtime import serve_engine as RS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.serve_engine import (EngineConfig, Request,
                                              ServeEngine)
from repro_torch.runtime.train_loop import value_and_grad

ARCH = "gemma3-12b"
TOL = dict(rtol=1e-4, atol=2e-4)
# the reference's param_counts() total
PARAMS = 12_771_655_680


def to_numpy_tree(tree):
    """A JAX pytree as nested dicts and lists of numpy arrays, floats as
    float32."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def configs(gqa):
    """(reference config, port config): ``.reduced()`` in fp32, with
    ``gqa`` 4 heads over 2 kv heads."""
    kw = {"dtype": "float32"}
    if gqa:
        kw.update(n_heads=4, n_kv_heads=2)
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def pair(gqa, seq=16):
    ref_cfg, cfg = configs(gqa)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, seq))
    return ref_cfg, ref_params, cfg, params, tokens


def test_config_and_reduced_config_equal_the_reference():
    for get in (lambda g: g(ARCH), lambda g: g(ARCH).reduced()):
        mine, ref = get(get_config), get(ref_get_config)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    cfg = get_config(ARCH).reduced()
    assert (cfg.window_pattern, cfg.n_layers) == ((8, None), 4)


@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
def test_forward_and_train_step(gqa):
    """One forward and one train step, as the reference's smoke test runs
    them, with the port held to the reference: logits, loss, every
    gradient leaf (on the plain and the kernel path), and the parameters
    after one AdamW step."""
    ref_cfg, ref_params, cfg, params, tokens = pair(gqa)
    assert (cfg.n_kv_heads < cfg.n_heads) == gqa
    assert isinstance(params["cycles"], list) and len(params["cycles"]) == 2
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    ref_batch = {"tokens": jnp.asarray(tokens)}

    expect, _ = ref_model.forward(ref_params, ref_batch["tokens"])
    for use_kernel in (False, True):
        logits, _ = model.forward(params, batch["tokens"],
                                  use_kernel=use_kernel)
        assert logits.shape == (2, 16, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(expect), **TOL)

    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss(p, ref_batch), has_aux=True)(ref_params)
    ref_flat = dict(_leaves(to_numpy_tree(ref_grads)))
    for use_kernel in (False, True):
        loss, _, grads = value_and_grad(model, params, batch,
                                        use_kernel=use_kernel)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
        flat = dict(_leaves(grads))
        assert flat.keys() == ref_flat.keys()
        for name, g in flat.items():
            r = ref_flat[name]
            assert float(np.abs(r).max()) > 0, name
            np.testing.assert_allclose(
                g.numpy(), r, rtol=1e-4,
                atol=1e-4 * float(np.abs(r).max()) + 1e-12, err_msg=name)

    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=10)
    new_params, _, _ = adamw.apply(opt_cfg, adamw.init(opt_cfg, params),
                                   grads, params)
    ref_opt = ref_adamw.AdamWConfig(lr=1e-3, total_steps=10)
    ref_new, _, _ = ref_adamw.apply(ref_opt, ref_adamw.init(ref_opt,
                                                            ref_params),
                                    ref_grads, ref_params)
    ref_new = dict(_leaves(to_numpy_tree(ref_new)))
    for name, p in _leaves(new_params):
        np.testing.assert_allclose(p.numpy(), ref_new[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
def test_decode_cache_shapes(gqa):
    """The port's decode cache has the reference's keys, shapes and types:
    ``p0`` (window 8) a ring of 8 slots, ``p1`` (global) ``max_len``
    slots, each stacked over the 2 cycles, ``n_kv_heads`` heads of the
    head dim, ``kpos`` -1."""
    ref_cfg, cfg = configs(gqa)
    ref_cache = ref_build_model(ref_cfg).init_cache(batch=2, max_len=32)
    cache = build_model(cfg, "cpu").init_cache(2, 32)
    assert sorted(cache) == sorted(ref_cache) == ["p0", "p1", "pos"]
    for group, cap in (("p0", 8), ("p1", 32)):
        for name in ("k", "v", "kpos"):
            mine, ref = cache[group][name], ref_cache[group][name]
            assert tuple(mine.shape) == ref.shape, (group, name)
            assert str(mine.dtype).split(".")[-1] == str(ref.dtype)
        assert cache[group]["k"].shape == (2, 2, cfg.n_kv_heads, cap,
                                           cfg.head_dim_)
        assert bool((cache[group]["kpos"] == -1).all())


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("prompt", [8, 12, 16])
def test_prefill_decode_matches_forward(prompt, use_kernel):
    """At the GQA config with a ring of 8 slots: prefill ``prompt`` tokens,
    then decode to token 20, each step's logits against the reference's
    ``forward`` over the same prefix.  The port agrees at every prompt
    length.  The reference's decode agrees with it where the ring's slots
    line up (8, 16); at 12 the reference's decode departs from its own
    forward by more than 0.1, the case the port's prefill fixes."""
    ref_cfg, ref_params, cfg, params, tokens = pair(True, seq=20)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    full, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    full = np.asarray(full)
    lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :prompt]),
                              model.init_cache(2, 32), use_kernel=use_kernel)
    lg_ref, c_ref = ref_model.prefill(
        ref_params, jnp.asarray(tokens[:, :prompt]), ref_model.init_cache(2,
                                                                       32))
    np.testing.assert_allclose(lg.numpy(), full[:, prompt - 1], **TOL)
    assert cache["p0"]["k"].shape[3] == 8 < 20
    ref_gap = 0.0
    for t in range(prompt, 20):
        lg, cache = model.decode_step(params, torch.from_numpy(tokens[:, t]),
                                      cache, use_kernel=use_kernel)
        lg_ref, c_ref = ref_model.decode_step(
            ref_params, jnp.asarray(tokens[:, t]), c_ref)
        np.testing.assert_allclose(lg.numpy(), full[:, t], **TOL)
        ref_gap = max(ref_gap, float(np.abs(np.asarray(lg_ref)
                                            - full[:, t]).max()))
        if prompt % 8 == 0:
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    if prompt % 8 == 0:
        assert ref_gap < 1e-4
        for group in ("p0", "p1"):
            for name in ("k", "v", "kpos"):
                np.testing.assert_allclose(
                    cache[group][name].numpy(),
                    np.asarray(c_ref[group][name]), **TOL)
    else:
        assert ref_gap > 0.1


def test_ring_slots_follow_the_position():
    """After a prefill of 12 tokens into a ring of 8, slot ``p % 8`` holds
    position ``p`` for the last 8 positions (the port's placement), and the
    global layer's cache holds positions 0-11 at slots 0-11."""
    _, _, cfg, params, tokens = pair(True, seq=12)
    model = build_model(cfg, "cpu")
    _, cache = model.prefill(params, torch.from_numpy(tokens),
                             model.init_cache(2, 32))
    ring = cache["p0"]["kpos"]
    assert ring.tolist() == [[8, 9, 10, 11, 4, 5, 6, 7]] * 2
    assert cache["p1"]["kpos"][:, :12].tolist() == [list(range(12))] * 2


def test_remat_full_checkpoints_whole_cycles(monkeypatch):
    """Under remat ``full`` the window-pattern stack is one checkpoint a
    cycle, as the reference wraps its scan body over cycles, not one a
    layer: 2 checkpoints for the 2 cycles of 2 layers, each given the
    cycle's input; the gradients equal those of remat ``none``."""
    _, _, cfg, params, tokens = pair(True)
    model = build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    calls = []
    real = TT.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(args)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(TT, "checkpoint", counted)
    hidden, _ = TT.forward_hidden(cfg, params, batch["tokens"], remat="full")
    assert len(calls) == cfg.n_layers // len(cfg.window_pattern) == 2
    for cycle_params, h in calls:
        assert len(cycle_params) == len(cfg.window_pattern)
        assert h.shape == (2, 16, cfg.d_model)
    monkeypatch.setattr(TT, "checkpoint", real)
    grads = {remat: dict(_leaves(value_and_grad(model, params, batch,
                                                remat=remat)[2]))
             for remat in ("none", "full")}
    for name, g in grads["none"].items():
        np.testing.assert_allclose(grads["full"][name].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_full_config_parameter_count():
    """The port's tree at full width and depth, built on fake tensors
    (nothing allocated), holds the reference's ``param_counts()`` total,
    which leaves out the fp32 norm scales (two a layer and the final one,
    d_model each): 8 cycles of 6 blocks."""
    cfg = get_config(ARCH)
    with FakeTensorMode():
        params = TT.init_params(cfg, torch.Generator().manual_seed(0))
        sizes = {name: t.numel() for name, t in _leaves(params)}
    assert len(params["cycles"]) == 6
    assert params["cycles"][0]["attn"]["w_q"].shape == (8, 3840, 16 * 256)
    norms = sum(n for name, n in sizes.items()
                if name.split(".")[-1] in ("ln1", "ln2", "final_norm"))
    assert norms == (2 * cfg.n_layers + 1) * cfg.d_model
    count = sum(sizes.values()) - norms
    assert count == ref_get_config(ARCH).param_counts()["total"] == \
        PARAMS == cfg.n_params


# prompts no longer than the ring (8), where the reference's decode is right
REQS = [([5, 6, 7, 8], 9), ([9, 10, 11], 12), ([3, 4, 5, 200, 17], 6),
        ([42], 10)]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_token_streams_identical_to_the_reference_engine(use_kernel):
    """Static batching, greedy, from the same weights: every token of every
    request and the stats are the reference engine's, the decode running
    past the ring of 8 slots."""
    ref_cfg, ref_params, cfg, params, _ = pair(True)
    ref_engine = RS.ServeEngine(ref_build_model(ref_cfg), ref_params,
                                RS.EngineConfig(max_len=40))
    engine = ServeEngine(build_model(cfg, "cpu"), params,
                         EngineConfig(max_len=40), use_kernel=use_kernel)
    ref_out = ref_engine.generate([RS.Request(prompt=p, max_new_tokens=n)
                                   for p, n in REQS])
    out = engine.generate([Request(prompt=p, max_new_tokens=n)
                           for p, n in REQS])
    assert [c.tokens for c in out] == [c.tokens for c in ref_out]
    assert engine.stats == ref_engine.stats
    assert max(len(p) + n for p, n in REQS) > 8
