"""The moe arch ``phi3.5-moe-42b-a6.6b`` in the port against the reference
on the CPU.

``layers.moe_ffn`` alone, in fp32, against the reference's on the same
numpy inputs and weights: the expert choices (``gate_idx``) and the drop
decisions (``keep``) equal, the output and the aux loss within 1e-5.  The
reference's own choices and drops are read from its ``moe_ffn`` as it runs
(its ``jax.lax.top_k`` and its one ``jnp.where`` are wrapped for the call).
The seeded inputs keep every two router probabilities of a token at least
1e-4 apart (the test asserts the margin), so that rounding cannot decide a
choice; the planted ties (``w_router = 0``: every probability ``1 / E``)
must be decided as ``jax.lax.top_k`` decides them, the lower index first.

Then ``tests/test_models_smoke.py``'s ``test_forward_and_train_step`` and
``test_decode_cache_shapes`` on ``.reduced()`` (2 layers, 4 experts, top-2,
d_ff_expert 64) and at 4 heads over 2 kv heads, in fp32, the reference's
init params through numpy into the port's tree: forward logits, the loss
(CE and aux), every gradient leaf, three ``make_train_step`` steps against
the reference's jitted plain step, prefill and decode steps, the cache, the
engine's greedy streams; and the full config's parameter count on fake
tensors.

Tolerance: rtol 1e-4, atol 2e-4 on logits (tests/test_torch_model.py's);
the loss within 2e-5, the aux loss within 1e-5, each gradient leaf within
1e-4 of its largest magnitude (fp32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.core.planner import ShardingPlan as RefPlan
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.runtime import serve_engine as RS
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import ShardingPlan
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.serve_engine import (EngineConfig, Request,
                                              ServeEngine)
from repro_torch.runtime.train_loop import make_train_step, value_and_grad
from test_torch_train import (OPT, assert_param_changes_match, flat,
                              train_batches)

ARCH = "phi3.5-moe-42b-a6.6b"
TOL = dict(rtol=1e-4, atol=2e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4
# the reference's param_counts() total
PARAMS = 41_872_261_120


def to_numpy_tree(tree):
    """A JAX pytree as nested dicts of numpy arrays, floats as float32."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------------------
# moe_ffn alone
# ---------------------------------------------------------------------------


def moe_params(seed, d=16, e=4, f=32, gated=True, router=True):
    """numpy weights of one moe layer; ``router`` False: ``w_router = 0``."""
    rng = np.random.default_rng(seed)
    p = {"w_router": (rng.standard_normal((d, e)) * d ** -0.5
                      if router else np.zeros((d, e))),
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    if gated:
        p["w_gate"] = rng.standard_normal((e, d, f)) * d ** -0.5
    return {k: v.astype(np.float32) for k, v in p.items()}


def ref_moe(x, params, monkeypatch, **kw):
    """The reference's ``moe_ffn(x, params, **kw)`` on numpy inputs, with
    the expert choices and drop decisions it made: (out, aux, gate_idx,
    keep) as numpy arrays."""
    seen = {}
    top_k, where = jax.lax.top_k, jnp.where

    def rec_top_k(a, k):
        seen["top_k"] = top_k(a, k)
        return seen["top_k"]

    def rec_where(cond, *args):
        if getattr(cond, "dtype", None) == jnp.bool_:
            seen["keep"] = cond
        return where(cond, *args)
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(jnp, "where", rec_where)
        out, aux = RL.moe_ffn(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in params.items()},
                              **kw)
    return (np.asarray(out), float(aux), np.asarray(seen["top_k"][1]),
            np.asarray(seen["keep"]))


def port_moe(x, params, **kw):
    """The port's ``moe_ffn`` and its routing (``moe_route``) on the same
    inputs: (out, aux, gate_idx, keep) as numpy arrays."""
    xt = torch.from_numpy(x)
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    out, aux = L.moe_ffn(xt, pt, **kw)
    r = L.moe_route(xt, pt["w_router"], top_k=kw["top_k"],
                    capacity_factor=kw["capacity_factor"],
                    group_size=kw.get("group_size", 4096))
    return out.numpy(), float(aux), r["gate_idx"].numpy(), r["keep"].numpy()


def router_margin(x, w_router):
    """The least gap between two router probabilities of one token."""
    logits = x.astype(np.float64) @ w_router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return float(np.diff(np.sort(p, axis=-1), axis=-1).min())


# (t, group_size): one group; four groups of 16; a ragged t (50 % 16 != 0)
# that falls back to one group
GROUPS = [(64, 4096), (64, 16), (50, 16)]


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("t,group_size", GROUPS,
                         ids=["one group", "four groups", "ragged"])
def test_moe_ffn_matches_the_reference(t, group_size, gated, monkeypatch):
    """Seeded inputs whose router probabilities stay ``MARGIN`` apart: the
    expert choices and the drops equal the reference's exactly, out and aux
    within 1e-5.  At a capacity factor of 1.0 (each queue holds the mean
    load) some slot is dropped and most are kept."""
    x = np.random.default_rng(1).standard_normal((t, 16)).astype(np.float32)
    params = moe_params(2, gated=gated)
    assert router_margin(x, params["w_router"]) > MARGIN
    kw = dict(top_k=2, capacity_factor=1.0, gated=gated,
              group_size=group_size)
    out_r, aux_r, idx_r, keep_r = ref_moe(x, params, monkeypatch, **kw)
    out, aux, idx, keep = port_moe(x, params, **kw)
    g = 4 if group_size == 16 and t % 16 == 0 else 1
    assert idx.shape == keep.shape == (g, t // g, 2)
    np.testing.assert_array_equal(idx, idx_r)
    np.testing.assert_array_equal(keep, keep_r)
    assert not keep.all() and keep.mean() > 0.5
    np.testing.assert_allclose(out, out_r, **MOE_TOL)
    np.testing.assert_allclose(aux, aux_r, **MOE_TOL)


@pytest.mark.parametrize("t,group_size", GROUPS,
                         ids=["one group", "four groups", "ragged"])
def test_planted_ties_are_decided_as_the_reference_decides(t, group_size,
                                                            monkeypatch):
    """``w_router = 0``: every probability is ``1 / E``.  The reference's
    ``top_k`` puts the lower index first, so every token picks experts 0
    and 1, each queue takes the group's first ``capacity`` tokens and drops
    the rest, and a dropped token's output is zero.  The port decides every
    choice and drop the same way."""
    x = np.random.default_rng(3).standard_normal((t, 16)).astype(np.float32)
    params = moe_params(4, router=False)
    kw = dict(top_k=2, capacity_factor=1.25, gated=True,
              group_size=group_size)
    out_r, aux_r, idx_r, keep_r = ref_moe(x, params, monkeypatch, **kw)
    out, aux, idx, keep = port_moe(x, params, **kw)
    np.testing.assert_array_equal(idx_r, np.broadcast_to([0, 1], idx_r.shape))
    np.testing.assert_array_equal(idx, idx_r)
    np.testing.assert_array_equal(keep, keep_r)
    tg = idx.shape[1]
    capacity = max(int(1.25 * 2 * tg / 4), 1)
    np.testing.assert_array_equal(
        keep, np.broadcast_to((np.arange(tg) < capacity)[None, :, None],
                              keep.shape))
    dropped = ~keep.reshape(t, 2).any(-1)
    assert dropped.any()
    assert (out[dropped] == 0).all() and (out_r[dropped] == 0).all()
    np.testing.assert_allclose(out, out_r, **MOE_TOL)
    np.testing.assert_allclose(aux, aux_r, **MOE_TOL)


def test_stable_top_k_orders_ties_as_jax_does():
    """Rows of three distinct values, most of them tied: the values and
    indices of ``stable_top_k`` equal ``jax.lax.top_k``'s, each k."""
    x = np.random.default_rng(5).choice([0.0, 0.25, 1.0],
                                        size=(64, 16)).astype(np.float32)
    for k in (1, 2, 5):
        vals_r, idx_r = jax.lax.top_k(jnp.asarray(x), k)
        vals, idx = L.stable_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_r))


# ---------------------------------------------------------------------------
# the arch
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
def test_forward_and_train_step(gqa):
    """One forward and one train step, as the reference's smoke test runs
    them, with the port held to the reference: logits and aux, the loss and
    its CE and aux, every gradient leaf (the router's among them, through
    the gates and the aux loss), on the plain and the kernel path, and the
    parameters after one AdamW step."""
    ref_cfg, ref_params, cfg, params, tokens = pair(gqa)
    assert (cfg.n_kv_heads < cfg.n_heads) == gqa
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    ref_batch = {"tokens": jnp.asarray(tokens)}

    expect, ref_aux = ref_model.forward(ref_params, ref_batch["tokens"])
    logits, aux = model.forward(params, batch["tokens"])
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(expect), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **MOE_TOL)
    assert float(aux) > 0

    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss(p, ref_batch), has_aux=True)(ref_params)
    ref_flat = dict(_leaves(to_numpy_tree(ref_grads)))
    for use_kernel in (False, True):
        loss, metrics, grads = value_and_grad(model, params, batch,
                                              use_kernel=use_kernel)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
        for key in ("ce", "aux"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(ref_metrics[key]), **MOE_TOL)
        flat_g = dict(_leaves(grads))
        assert flat_g.keys() == ref_flat.keys()
        for name, g in flat_g.items():
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


@pytest.fixture(scope="module")
def reference_steps():
    """(losses, params, m, v, vs) of three steps of the reference's jitted
    ``make_train_step(use_kernel=False)`` on ``.reduced()`` fp32, made
    once; ``vs`` is the flat second moment after each step."""
    ref_cfg, _ = configs(False)
    model = ref_build_model(ref_cfg)
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    opt_cfg = ref_adamw.AdamWConfig(**OPT)
    step = jax.jit(ref_make_train_step(model, opt_cfg, RefPlan()))
    opt = ref_adamw.init(opt_cfg, params)
    losses, vs = [], []
    for batch in train_batches(ref_cfg.vocab_size):
        params, opt, _, m = step(params, opt, None,
                                 {"tokens": jnp.asarray(batch)})
        losses.append(float(m["loss"]))
        vs.append(flat(to_numpy_tree(opt.v)))
    return (losses, to_numpy_tree(params), to_numpy_tree(opt.m),
            to_numpy_tree(opt.v), vs)


@pytest.mark.parametrize("remat,use_kernel",
                         [("none", False), ("full", False), ("full", True)],
                         ids=["plain", "remat full", "kernel path"])
def test_train_steps_match_reference(remat, use_kernel, reference_steps):
    """Three steps of the port's ``make_train_step`` against the
    reference's from the same weights and batches, fp32, with
    ``tests/test_torch_train.py``'s tolerances: each loss within rtol
    2e-5, the moments within 1e-4 of their largest, each weight's change
    by :func:`assert_param_changes_match`."""
    losses_ref, p_ref, m_ref, v_ref, vs_ref = reference_steps
    ref_cfg, cfg = configs(False)
    params = params_from_numpy(
        to_numpy_tree(RT.init_params(ref_cfg, jax.random.PRNGKey(0))), cfg,
        device="cpu")
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = make_train_step(build_model(cfg, "cpu"), opt_cfg,
                           ShardingPlan(remat=remat), use_kernel=use_kernel)
    opt = adamw.init(opt_cfg, params)
    p0 = {k: a.copy() for k, a in flat(params).items()}
    losses = []
    for batch in train_batches(cfg.vocab_size):
        params, opt, _, metrics = step(params, opt, None,
                                       {"tokens": torch.from_numpy(batch)})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, losses_ref, rtol=2e-5)
    for mine, ref in ((opt.m, m_ref), (opt.v, v_ref)):
        a, b = flat(mine), flat(ref)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(
                a[key], b[key], rtol=1e-4,
                atol=1e-4 * float(np.abs(b[key]).max()), err_msg=key)
    lr_sum = sum(adamw.schedule(opt_cfg, k) for k in range(1, 4))
    assert_param_changes_match(p0, flat(params), flat(p_ref), vs_ref, lr_sum,
                               "none")


@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
def test_decode_cache_shapes(gqa):
    """The port's decode cache has the reference's keys, shapes and types:
    one ``moe`` group over the 2 moe layers (no ``dense`` group: phi has no
    dense layers first), ``n_kv_heads`` heads of the head dim, ``kpos``
    -1; a config with a dense layer first gets the ``dense`` group too."""
    ref_cfg, cfg = configs(gqa)
    ref_cache = ref_build_model(ref_cfg).init_cache(batch=2, max_len=32)
    cache = build_model(cfg, "cpu").init_cache(2, 32)
    assert sorted(cache) == sorted(ref_cache) == ["moe", "pos"]
    for name in ("k", "v", "kpos"):
        mine, ref = cache["moe"][name], ref_cache["moe"][name]
        assert tuple(mine.shape) == ref.shape, name
        assert str(mine.dtype).split(".")[-1] == str(ref.dtype)
    assert cache["moe"]["k"].shape == (2, 2, cfg.n_kv_heads, 32,
                                       cfg.head_dim_)
    assert bool((cache["moe"]["kpos"] == -1).all())
    dense_first = [dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, first_dense_layers=1)) for c in (ref_cfg, cfg)]
    ref_cache = ref_build_model(dense_first[0]).init_cache(2, 32)
    cache = build_model(dense_first[1], "cpu").init_cache(2, 32)
    assert sorted(cache) == sorted(ref_cache) == ["dense", "moe", "pos"]
    for group in ("dense", "moe"):
        assert tuple(cache[group]["k"].shape) == ref_cache[group]["k"].shape


def test_first_dense_layers_match_the_reference():
    """A config with one dense layer before the moe layer (the split
    ``first_dense_layers`` makes for deepseek): the tree's ``dense_blocks``
    and ``blocks`` and the forward's logits and aux are the reference's."""
    ref_cfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, first_dense_layers=1)) for c in configs(True))
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    assert sorted(params) == sorted(ref_params)
    assert "mlp" in params["dense_blocks"] and "moe" in params["blocks"]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    expect, ref_aux = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    logits, aux = TT.forward(cfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(expect), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **MOE_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match(use_kernel):
    """At the GQA config: prefill of 10 tokens, then 6 decode steps, each
    step's logits against the reference's prefill and decode (a decode
    step routes the batch's 2 tokens in one group of capacity 1, so it
    drops by design, as the reference does) and, without drops
    (``capacity_factor = E``, as the reference's serving test runs it),
    against the port's and the reference's full forward."""
    ref_cfg, ref_params, cfg, params, tokens = pair(True)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    dropless = float(cfg.moe.n_experts)
    for cf in (None, dropless):
        lg_ref, c_ref = ref_model.prefill(
            ref_params, jnp.asarray(tokens[:, :10]),
            ref_model.init_cache(2, 16), capacity_factor=cf)
        lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :10]),
                                  model.init_cache(2, 16),
                                  use_kernel=use_kernel, capacity_factor=cf)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
        for t in range(10, 16):
            lg_ref, c_ref = ref_model.decode_step(
                ref_params, jnp.asarray(tokens[:, t]), c_ref,
                capacity_factor=cf)
            lg, cache = model.decode_step(
                params, torch.from_numpy(tokens[:, t]), cache,
                use_kernel=use_kernel, capacity_factor=cf)
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache["moe"][name].numpy(),
                                       np.asarray(c_ref["moe"][name]), **TOL)
    full, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens),
                         capacity_factor=dropless)
    mine, _ = model.forward(params, torch.from_numpy(tokens),
                            capacity_factor=dropless)
    np.testing.assert_allclose(mine.numpy(), np.asarray(full), **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(full[:, 15]), **TOL)


def test_capacity_factor_reaches_the_experts(monkeypatch):
    """``capacity_factor`` passed to ``forward`` reaches every moe layer:
    0.5 drops more (token, slot) pairs than the config's 1.25, which drops
    no fewer than 2.0, where a queue holds every token of its group (E /
    top_k = 2: nothing is dropped), and the logits at each factor are the
    reference's."""
    ref_cfg, ref_params, cfg, params, tokens = pair(True)
    kept = []
    real = L.moe_route

    def counted(*args, **kwargs):
        r = real(*args, **kwargs)
        kept.append(int(r["keep"].sum()))
        return r
    monkeypatch.setattr(L, "moe_route", counted)
    total = {}
    for cf in (0.5, None, 2.0):
        kept.clear()
        logits, _ = TT.forward(cfg, params, torch.from_numpy(tokens),
                               capacity_factor=cf)
        expect, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens),
                               capacity_factor=cf)
        np.testing.assert_allclose(logits.numpy(), np.asarray(expect), **TOL)
        assert len(kept) == cfg.n_layers
        total[cf] = sum(kept)
    assert total[0.5] < total[None] <= total[2.0] == 2 * 32 * cfg.n_layers


def test_router_stays_fp32():
    """The router is fp32 after ``init_params`` on a bf16 config and after
    ``params_from_numpy`` into bf16, as the reference keeps it; the experts
    take the model's type."""
    cfg = get_config(ARCH).reduced()
    assert cfg.dtype == "bfloat16"
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    assert params["blocks"]["moe"]["w_router"].dtype == torch.float32
    assert params["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
    ref_params = RT.init_params(ref_get_config(ARCH).reduced(),
                                jax.random.PRNGKey(0))
    assert ref_params["blocks"]["moe"]["w_router"].dtype == jnp.float32
    conv = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    assert conv["blocks"]["moe"]["w_router"].dtype == torch.float32
    assert conv["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        conv["blocks"]["moe"]["w_router"].numpy(),
        np.asarray(ref_params["blocks"]["moe"]["w_router"]))


REQS = [([5, 6, 7, 8], 9), ([9, 10, 11], 12), ([3, 4, 5, 200, 17], 6),
        ([42], 10)]


@pytest.mark.parametrize("batching", ["static", "continuous"])
def test_token_streams_identical_to_the_reference_engine(batching):
    """Greedy, from the same weights, on the kernel path: every token of
    every request and the stats are the reference engine's, static and
    continuous with 2 slots (each routes its own groups, drops included)."""
    ref_cfg, ref_params, cfg, params, _ = pair(True)
    slots = {"slots": 2} if batching == "continuous" else {}
    ref_engine = RS.ServeEngine(
        ref_build_model(ref_cfg), ref_params,
        RS.EngineConfig(max_len=40, batching=batching, **slots))
    engine = ServeEngine(build_model(cfg, "cpu"), params,
                         EngineConfig(max_len=40, batching=batching, **slots),
                         use_kernel=True)
    ref_out = ref_engine.generate([RS.Request(prompt=p, max_new_tokens=n)
                                   for p, n in REQS])
    out = engine.generate([Request(prompt=p, max_new_tokens=n)
                           for p, n in REQS])
    assert [c.tokens for c in out] == [c.tokens for c in ref_out]
    assert engine.stats == ref_engine.stats


def test_full_config_parameter_count():
    """The port's tree at full width and depth, built on fake tensors
    (nothing allocated), holds the reference's ``param_counts()`` total
    (41.9B), which leaves out the fp32 norm scales; the experts stacked
    ``[32, 16, 4096, 6400]``, the router ``[32, 4096, 16]`` in fp32."""
    cfg = get_config(ARCH)
    with FakeTensorMode():
        params = TT.init_params(cfg, torch.Generator().manual_seed(0))
        sizes = {name: t.numel() for name, t in _leaves(params)}
    moe = params["blocks"]["moe"]
    assert moe["w_up"].shape == (32, 16, 4096, 6400)
    assert moe["w_down"].shape == (32, 16, 6400, 4096)
    assert moe["w_router"].shape == (32, 4096, 16)
    assert moe["w_router"].dtype == torch.float32
    assert "dense_blocks" not in params
    norms = sum(n for name, n in sizes.items()
                if name.split(".")[-1] in ("ln1", "ln2", "final_norm"))
    assert norms == (2 * cfg.n_layers + 1) * cfg.d_model
    count = sum(sizes.values()) - norms
    assert count == ref_get_config(ARCH).param_counts()["total"] == \
        PARAMS == cfg.n_params

