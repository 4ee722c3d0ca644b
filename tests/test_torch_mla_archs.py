"""The MLA arch ``deepseek-v3-671b`` in the port against the reference on the
CPU.

Two configs, both fp32: ``.reduced()`` (2 layers, the first dense
(``first_dense_layers`` 1), 4 experts, top-2, a shared expert, MTP; the
MLA ranks stay at full size, q_lora 1536, kv_lora 512, qk 128 + 64, v
128, as the reference's ``reduced`` keeps them) and a small MLA config of
the tests' own (4 heads, ranks 32 / 16, qk 16 + 8, v 16).  The
reference's init params go through numpy into the port's tree; the same
numpy tokens go through both packages.

Held: the forward logits (rtol 1e-5, atol 1e-5); ``loss_fn``'s total,
``ce``, ``aux`` and ``mtp_ce`` (the same); one train step on the plain and
the kernel path (every gradient leaf within 1e-4 of the leaf's largest
magnitude); three ``make_train_step`` steps against the reference's
jitted plain step; prefill then the absorbed decode against the
reference's decode (1e-4), and, without drops, against the port's own
``forward`` (1e-4: the absorbed path forms the scores over the latent,
another order of fp32 sums; the readings were below 3e-6); the ``ckv`` /
``krope`` caches; the expert choices and drops of every moe layer equal
exactly; ``attention_dense`` under ``no_grad`` bit-equal to its grad-mode
result; the full parameter count on fake tensors; the engine's greedy
streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.configs.base import MLAConfig as RefMLAConfig
from repro.core.planner import ShardingPlan as RefPlan
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.runtime import serve_engine as RS
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.configs import MLAConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import ShardingPlan
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.serve_engine import (EngineConfig, Request,
                                              ServeEngine)
from repro_torch.runtime.train_loop import make_train_step, value_and_grad
from test_torch_moe_archs import _leaves, to_numpy_tree
from test_torch_train import (OPT, assert_param_changes_match, flat,
                              train_batches)

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's param_counts() total: the MTP head is not counted there
PARAMS = 671_025_397_760
SMALL_MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16)
CONFIGS = ["reduced", "small mla"]


def configs(which):
    """(reference config, port config) in fp32: ``.reduced()``, or with
    the small MLA ranks."""
    pair_ = [dataclasses.replace(get(ARCH).reduced(), dtype="float32")
             for get in (ref_get_config, get_config)]
    if which == "small mla":
        pair_ = [dataclasses.replace(c, mla=mla(**SMALL_MLA))
                 for c, mla in zip(pair_, (RefMLAConfig, MLAConfig))]
    return pair_


def pair(which, seq=16):
    ref_cfg, cfg = configs(which)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, seq))
    return ref_cfg, ref_params, cfg, params, tokens


@pytest.mark.parametrize("which", CONFIGS)
def test_forward_and_loss(which):
    """Logits and aux of ``forward``, and ``loss_fn``'s total with its
    ``ce``, ``aux`` and ``mtp_ce`` (the MTP head over the first S - 2
    positions), equal the reference's within 1e-5."""
    ref_cfg, ref_params, cfg, params, tokens = pair(which)
    assert cfg.mtp_depth == 1 and "mtp" in params
    expect, ref_aux = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    logits, aux = TT.forward(cfg, params, torch.from_numpy(tokens))
    assert logits.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(expect), **TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL)
    ref_loss, ref_m = RT.loss_fn(ref_cfg, ref_params,
                                 {"tokens": jnp.asarray(tokens)})
    loss, metrics = TT.loss_fn(cfg, params,
                               {"tokens": torch.from_numpy(tokens)})
    assert sorted(metrics) == sorted(ref_m) == ["aux", "ce", "mtp_ce"]
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    for key in ref_m:
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]),
                                   **TOL, err_msg=key)
    expected = float(metrics["ce"]) + 0.01 * float(metrics["aux"]) \
        + 0.1 * float(metrics["mtp_ce"])
    np.testing.assert_allclose(float(loss), expected, rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel path"])
@pytest.mark.parametrize("which", CONFIGS)
def test_train_step_gradients(which, use_kernel):
    """One train step's loss and every gradient leaf (the MLA projections,
    the fp32 norms, the shared and routed experts, the router, the MTP
    head's ``proj``, block and norm) against ``jax.value_and_grad`` of the
    reference's loss: each leaf within 1e-4 of its largest magnitude."""
    ref_cfg, ref_params, cfg, params, tokens = pair(which)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: RT.loss_fn(ref_cfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(ref_params)
    ref_flat = dict(_leaves(to_numpy_tree(ref_grads)))
    loss, metrics, grads = value_and_grad(
        build_model(cfg, "cpu"), params, {"tokens": torch.from_numpy(tokens)},
        use_kernel=use_kernel)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    flat_g = dict(_leaves(grads))
    assert flat_g.keys() == ref_flat.keys()
    for name in ("mtp.proj", "mtp.norm", "mtp.block.attn.w_ukv",
                 "blocks.moe.shared.w_gate", "blocks.attn.q_norm",
                 "dense_blocks.attn.kv_norm"):
        assert name in flat_g
    for name, g in flat_g.items():
        r = ref_flat[name]
        assert float(np.abs(r).max()) > 0, name
        np.testing.assert_allclose(
            g.numpy(), r, rtol=1e-4,
            atol=1e-4 * float(np.abs(r).max()) + 1e-12, err_msg=name)


@pytest.fixture(scope="module")
def reference_steps():
    """(losses, params, m, v, vs) of three steps of the reference's jitted
    ``make_train_step(use_kernel=False)`` on the small MLA config."""
    ref_cfg, _ = configs("small mla")
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
    reference's from the same weights and batches, with
    ``tests/test_torch_train.py``'s tolerances (losses rtol 2e-5, moments
    1e-4 of their largest, each weight's change by
    :func:`assert_param_changes_match`)."""
    losses_ref, p_ref, m_ref, v_ref, vs_ref = reference_steps
    ref_cfg, cfg = configs("small mla")
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
        assert "mtp_ce" in metrics
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


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel path"])
@pytest.mark.parametrize("which", CONFIGS)
def test_prefill_and_absorbed_decode(which, use_kernel):
    """Prefill of 10 tokens, then 6 absorbed decode steps: each step's
    logits and the ``ckv`` / ``krope`` caches of both groups against the
    reference's prefill and decode (1e-4), with the config's capacity
    (decode drops) and dropless; dropless, the last step against the port's
    own ``forward`` (1e-4)."""
    ref_cfg, ref_params, cfg, params, tokens = pair(which)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    dropless = float(cfg.moe.n_experts)
    for cf in (None, dropless):
        lg_ref, c_ref = ref_model.prefill(
            ref_params, jnp.asarray(tokens[:, :10]),
            ref_model.init_cache(2, 16), capacity_factor=cf)
        lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :10]),
                                  model.init_cache(2, 16),
                                  use_kernel=use_kernel, capacity_factor=cf)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref),
                                   **DECODE_TOL)
        for t in range(10, 16):
            lg_ref, c_ref = ref_model.decode_step(
                ref_params, jnp.asarray(tokens[:, t]), c_ref,
                capacity_factor=cf)
            lg, cache = model.decode_step(
                params, torch.from_numpy(tokens[:, t]), cache,
                use_kernel=use_kernel, capacity_factor=cf)
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref),
                                       **DECODE_TOL)
        assert cache["pos"] == int(c_ref["pos"]) == 16
        for group in ("dense", "moe"):
            for name in ("ckv", "krope"):
                np.testing.assert_allclose(
                    cache[group][name].numpy(),
                    np.asarray(c_ref[group][name]), **DECODE_TOL,
                    err_msg=f"{group}.{name}")
    full, _ = model.forward(params, torch.from_numpy(tokens),
                            capacity_factor=dropless)
    np.testing.assert_allclose(lg.numpy(), full[:, 15].numpy(), **DECODE_TOL)


@pytest.mark.parametrize("which", CONFIGS)
def test_mla_cache_shapes(which):
    """The decode cache has the reference's groups, keys, shapes and
    types: ``dense`` over the first dense layer, ``moe`` over the rest,
    each ``ckv [n,B,max_len,kv_lora_rank]`` and ``krope
    [n,B,max_len,qk_rope_head_dim]``; a config whose layers are all dense
    has no ``moe`` group, and its tree no ``blocks``."""
    ref_cfg, cfg = configs(which)
    ref_cache = ref_build_model(ref_cfg).init_cache(batch=2, max_len=32)
    cache = build_model(cfg, "cpu").init_cache(2, 32)
    assert sorted(cache) == sorted(ref_cache) == ["dense", "moe", "pos"]
    for group in ("dense", "moe"):
        assert sorted(cache[group]) == ["ckv", "krope"]
        for name, width in (("ckv", cfg.mla.kv_lora_rank),
                            ("krope", cfg.mla.qk_rope_head_dim)):
            mine, ref = cache[group][name], ref_cache[group][name]
            assert tuple(mine.shape) == ref.shape == (1, 2, 32, width)
            assert str(mine.dtype).split(".")[-1] == str(ref.dtype)
    dense_only = dataclasses.replace(cfg, n_layers=1)
    assert sorted(build_model(dense_only, "cpu").init_cache(2, 8)) == [
        "dense", "pos"]
    params = TT.init_params(dense_only, torch.Generator().manual_seed(0))
    assert "blocks" not in params and "dense_blocks" in params
    logits, aux = TT.forward(dense_only, params,
                             torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, 4, cfg.vocab_size) and float(aux) == 0.0


def _record_reference_routing(monkeypatch):
    """Wraps the reference's ``jax.lax.top_k`` and ``jnp.where`` so that
    each moe layer's expert choices and keep decisions are recorded."""
    seen = []
    top_k, where = jax.lax.top_k, jnp.where

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen.append([np.asarray(out[1]), None])
        return out

    def rec_where(cond, *args):
        if getattr(cond, "dtype", None) == jnp.bool_ and seen \
                and seen[-1][1] is None and cond.shape == seen[-1][0].shape:
            seen[-1][1] = np.asarray(cond)
        return where(cond, *args)
    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "where", rec_where)
    return seen


@pytest.mark.parametrize("which", CONFIGS)
def test_expert_choices_and_drops_equal(which, monkeypatch):
    """Every moe layer's expert choices and drop decisions in a forward
    (and in the prefill, where the MTP head does not run) equal the
    reference's exactly, at a capacity factor of 1.0 (each queue holds the
    mean load: some slots dropped).  The reference runs with jit off, so
    that its scanned layers hand over concrete choices."""
    ref_cfg, ref_params, cfg, params, tokens = pair(which, seq=32)
    mine = []
    real = L.moe_route

    def recorded(*args, **kwargs):
        r = real(*args, **kwargs)
        mine.append((r["gate_idx"].numpy(), r["keep"].numpy()))
        return r
    monkeypatch.setattr(L, "moe_route", recorded)
    TT.forward(cfg, params, torch.from_numpy(tokens), capacity_factor=1.0)
    with monkeypatch.context() as m, jax.disable_jit():
        seen = _record_reference_routing(m)
        RT.forward(ref_cfg, ref_params, jnp.asarray(tokens),
                   capacity_factor=1.0)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert len(mine) == len(seen) == n_moe
    dropped = 0
    for (idx, keep), (ref_idx, ref_keep) in zip(mine, seen):
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(keep, ref_keep)
        dropped += int((~keep).sum())
    assert dropped > 0


ATTN_CASES = [
    # (b, hq, hkv, sq, skv, dk, dv, causal, window, q_offset)
    (2, 4, 4, 24, 24, 48, 32, True, None, 0),        # MLA: Dk != Dv
    (2, 4, 2, 17, 17, 16, 16, True, 5, 0),           # GQA, a window
    (1, 4, 1, 1, 13, 24, 16, True, None, 12),        # one query, decode
    (2, 2, 2, 9, 12, 8, 8, False, None, 0),          # not causal
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=["mla", "gqa window", "decode", "not causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_dense_in_place_is_bit_equal(case, dtype):
    """``attention_dense`` under ``no_grad`` (the in-place softmax) gives
    the same bits as in grad mode, and leaves its inputs as they were."""
    b, hq, hkv, sq, skv, dk, dv, causal, window, off = case
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, hq, sq, dk), generator=gen).to(dtype)
    k = torch.randn((b, hkv, skv, dk), generator=gen).to(dtype)
    v = torch.randn((b, hkv, skv, dv), generator=gen).to(dtype)
    copies = [t.clone() for t in (q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=off, scale=0.3)
    grad_mode = L.attention_dense(q, k, v, **kw)
    with torch.no_grad():
        in_place = L.attention_dense(q, k, v, **kw)
    assert torch.equal(grad_mode, in_place)
    assert all(torch.equal(a, c) for a, c in zip((q, k, v), copies))


def test_mla_prefill_stays_off_the_flash_kernel(monkeypatch):
    """MLA's Dk (qk_head_dim) differs from its Dv: the kernel path's
    prefill and train step never reach the flash wrapper, as the
    reference's dispatch keeps them off its kernel."""
    from repro_torch.kernels import ops as kops
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, cfg, params, tokens = pair("small mla")
    model = build_model(cfg, "cpu")
    model.prefill(params, torch.from_numpy(tokens), model.init_cache(2, 16),
                  use_kernel=True)
    value_and_grad(model, params, {"tokens": torch.from_numpy(tokens)},
                   use_kernel=True)
    assert calls == []


def test_norms_stay_fp32():
    """MLA's ``q_norm`` and ``kv_norm`` and the MTP head's ``norm`` are fp32
    after ``init_params`` on a bf16 config and after ``params_from_numpy``
    into bf16, as the reference keeps them; the projections take bf16."""
    cfg = get_config(ARCH).reduced()
    assert cfg.dtype == "bfloat16"
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    ref_params = RT.init_params(ref_get_config(ARCH).reduced(),
                                jax.random.PRNGKey(0))
    conv = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    for tree in (params, conv):
        for stack in ("dense_blocks", "blocks"):
            attn = tree[stack]["attn"]
            assert attn["q_norm"].dtype == attn["kv_norm"].dtype \
                == torch.float32
            assert attn["w_dq"].dtype == attn["w_ukv"].dtype == torch.bfloat16
        assert tree["mtp"]["norm"].dtype == torch.float32
        assert tree["mtp"]["proj"].dtype == torch.bfloat16
        assert tree["mtp"]["block"]["attn"]["q_norm"].dtype == torch.float32
    assert ref_params["mtp"]["norm"].dtype == jnp.float32


REQS = [([5, 6, 7, 8], 9), ([9, 10, 11], 12), ([3, 4, 5, 200, 17], 6),
        ([42], 10)]


@pytest.mark.parametrize("batching", ["static", "continuous"])
def test_token_streams_identical_to_the_reference_engine(batching):
    """Greedy, from the same weights, on the kernel path, at the small MLA
    config: every token of every request and the stats are the reference
    engine's, static and continuous with 2 slots."""
    ref_cfg, ref_params, cfg, params, _ = pair("small mla")
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
    (nothing allocated): 3 dense and 58 moe layers of 256 routed experts
    and a shared one, the MLA leaves at their published ranks, and the
    reference's ``param_counts()`` total (671B), which leaves out the
    fp32 norm scales and the MTP head (0.69B, counted here apart)."""
    cfg = get_config(ARCH)
    with FakeTensorMode():
        params = TT.init_params(cfg, torch.Generator().manual_seed(0))
        sizes = {name: t.numel() for name, t in _leaves(params)}
    moe = params["blocks"]["moe"]
    assert moe["w_up"].shape == (58, 256, 7168, 2048)
    assert moe["shared"]["w_gate"].shape == (58, 7168, 2048)
    assert params["dense_blocks"]["mlp"]["w_gate"].shape == (3, 7168, 18432)
    attn = params["blocks"]["attn"]
    assert attn["w_uq"].shape == (58, 1536, 128 * 192)
    assert attn["w_dkv"].shape == (58, 7168, 512 + 64)
    assert attn["w_ukv"].shape == (58, 512, 128 * 256)
    assert attn["q_norm"].dtype == torch.float32
    norm_names = ("ln1", "ln2", "final_norm", "q_norm", "kv_norm", "norm")
    norms = sum(n for name, n in sizes.items()
                if name.split(".")[-1] in norm_names)
    mtp = sum(n for name, n in sizes.items() if name.startswith("mtp."))
    mtp_norms = sum(n for name, n in sizes.items() if name.startswith("mtp.")
                    and name.split(".")[-1] in norm_names)
    assert mtp - mtp_norms == 2 * 7168 * 7168 + (
        7168 * 1536 + 1536 * 128 * 192 + 7168 * 576 + 512 * 128 * 256
        + 128 * 128 * 7168) + 3 * 7168 * 18432
    count = sum(sizes.values()) - norms - (mtp - mtp_norms)
    assert count == ref_get_config(ARCH).param_counts()["total"] == \
        PARAMS == cfg.n_params
