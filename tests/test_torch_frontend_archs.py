"""The frontend archs ``pixtral-12b`` (a vision stub: precomputed patch
embeddings prepended to the tokens) and ``whisper-small`` (an
encoder-decoder over precomputed frame embeddings) in the port against the
reference on the CPU.

The port of ``tests/test_models_smoke.py``'s ``test_forward_and_train_step``
and ``test_decode_cache_shapes`` and of ``tests/test_serving.py``'s
``test_prefill_decode_matches_forward`` on each arch's ``.reduced()`` config
in fp32: the reference's init params go through numpy into the port's tree,
the same tokens and frontend embeddings (drawn with numpy) through both.
``.reduced()`` sets ``n_kv_heads = n_heads``, so the same checks run again
at a small GQA config (4 heads over 2 kv heads), and on the port's kernel
path too (whose wrappers take their plain versions on CPU tensors).  Then
the reference's dtype rule (``dense`` casts the weights to the
activation's type: fp32 frames on a bf16 model run an fp32 encoder and give
fp32 cross K/V, while pixtral casts its patches to the model's type), each
full config's parameter count against the reference's ``param_counts()`` on
fake tensors, the engine's greedy streams against the reference engine's,
and its single-admission raise.

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

ARCHS = ("pixtral-12b", "whisper-small")
TOL = dict(rtol=1e-4, atol=2e-4)
# the reference's param_counts() totals
PARAMS = {"pixtral-12b": 12_247_367_680, "whisper-small": 277_928_448}


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


def configs(arch, gqa, dtype="float32"):
    """(reference config, port config): ``.reduced()`` in ``dtype``, with
    ``gqa`` 4 heads over 2 kv heads."""
    kw = {"dtype": dtype}
    if gqa:
        kw.update(n_heads=4, n_kv_heads=2)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def pair(arch, gqa, seq=16, dtype="float32"):
    """Both configs, the reference's params and the port's copy of them,
    tokens [2, seq] and fp32 frontend embeddings [2, F, d] from numpy."""
    ref_cfg, cfg = configs(arch, gqa, dtype)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, seq))
    fe = rng.standard_normal(
        build_model(cfg, "cpu").frontend_shape(2)).astype(np.float32)
    return ref_cfg, ref_params, cfg, params, tokens, fe


def offset(cfg, fe):
    """Positions before the first token: the patches of a vision stub."""
    return fe.shape[1] if cfg.enc_dec is None else 0


@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch, gqa):
    """One forward and one train step with the frontend, as the reference's
    smoke test runs them, the port held to the reference: logits over the
    whole sequence (patches included for pixtral), loss, every gradient
    leaf on both paths, and the parameters after one AdamW step."""
    ref_cfg, ref_params, cfg, params, tokens, fe = pair(arch, gqa)
    assert (cfg.n_kv_heads < cfg.n_heads) == gqa
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "frontend": torch.from_numpy(fe)}
    ref_batch = {"tokens": jnp.asarray(tokens), "frontend": jnp.asarray(fe)}

    expect, _ = ref_model.forward(ref_params, ref_batch["tokens"],
                                  ref_batch["frontend"])
    logits, _ = model.forward(params, batch["tokens"], batch["frontend"])
    assert logits.shape == (2, 16 + offset(cfg, fe), cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(expect), **TOL)

    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss(p, ref_batch), has_aux=True)(ref_params)
    ref_flat = dict(_leaves(to_numpy_tree(ref_grads)))
    top = max(float(np.abs(r).max()) for r in ref_flat.values())
    for use_kernel in (False, True):
        loss, _, grads = value_and_grad(model, params, batch,
                                        use_kernel=use_kernel)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
        flat = dict(_leaves(grads))
        assert flat.keys() == ref_flat.keys()
        for name, g in flat.items():
            r = ref_flat[name]
            if name.endswith("cross.b_k"):
                # no gradient in exact arithmetic: the bias shifts every
                # score of a query row alike, which its softmax ignores;
                # both sides hold rounding only
                assert np.abs(g.numpy()).max() <= 1e-6 * top, name
                assert np.abs(r).max() <= 1e-6 * top, name
                continue
            np.testing.assert_allclose(
                g.numpy(), r, rtol=1e-4,
                atol=1e-4 * float(np.abs(r).max()) + 1e-12, err_msg=name)
    gnorm = adamw.global_norm(grads)
    assert bool(torch.isfinite(gnorm)) and float(gnorm) > 0

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
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_shapes(arch, gqa):
    """The port's decode cache has the reference's keys, shapes and types:
    the self cache, and for whisper the cross K/V of ``encoder_seq``
    frames."""
    ref_cfg, cfg = configs(arch, gqa)
    ref_cache = ref_build_model(ref_cfg).init_cache(batch=2, max_len=32)
    cache = build_model(cfg, "cpu").init_cache(2, 32)
    ref_flat = dict(_leaves(ref_cache))
    flat = dict(_leaves(cache))
    assert flat.keys() == ref_flat.keys()
    for name, ref in ref_flat.items():
        if name == "pos":
            assert flat[name] == 0 == int(ref)
            continue
        assert tuple(flat[name].shape) == ref.shape, name
        assert str(flat[name].dtype).split(".")[-1] == str(ref.dtype), name
    if cfg.enc_dec is not None:
        assert cache["cross_k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads,
                                          cfg.enc_dec.encoder_seq,
                                          cfg.head_dim_)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, gqa, use_kernel):
    """The reference's serving test: a cache of ``S + offset``, prefill of
    16 tokens (after the patches, or beside the frames), then 8 decode
    steps, each step's logits against the full forward's and against the
    reference's own prefill and decode; the caches after the last step."""
    ref_cfg, ref_params, cfg, params, tokens, fe = pair(arch, gqa, seq=24)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    off, p_len = offset(cfg, fe), 16
    full, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens),
                         jnp.asarray(fe))
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :p_len]),
                                      ref_model.init_cache(2, 24 + off),
                                      jnp.asarray(fe))
    lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :p_len]),
                              model.init_cache(2, 24 + off),
                              torch.from_numpy(fe), use_kernel=use_kernel)
    assert cache["pos"] == off + p_len == int(c_ref["pos"])
    np.testing.assert_allclose(lg.numpy(), np.asarray(full[:, off + p_len - 1]),
                               **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    for t in range(p_len, 24):
        lg_ref, c_ref = ref_model.decode_step(
            ref_params, jnp.asarray(tokens[:, t]), c_ref)
        lg, cache = model.decode_step(params, torch.from_numpy(tokens[:, t]),
                                      cache, use_kernel=use_kernel)
        np.testing.assert_allclose(lg.numpy(), np.asarray(full[:, off + t]),
                                   **TOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    ref_flat = dict(_leaves(c_ref))
    for name, t in _leaves(cache):
        if name == "pos":
            assert t == int(ref_flat[name])
            continue
        np.testing.assert_allclose(t.numpy(), np.asarray(ref_flat[name]),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_dtype_rule(arch):
    """fp32 frontend embeddings on a bf16 model, in both packages: whisper's
    encoder runs in the frames' type (``dense`` casts the weights to the
    activation's), so its output and the cross K/V in the cache are fp32
    and the decoder stays bf16; pixtral casts its patches to the model's
    type.  The logits are fp32 on both sides and agree to bf16's
    precision."""
    ref_cfg, ref_params, cfg, params, tokens, fe = pair(arch, False,
                                                        dtype="bfloat16")
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    frames = torch.from_numpy(fe)
    hidden, _ = TT.forward_hidden(cfg, params, torch.from_numpy(tokens),
                                  frames)
    ref_hidden, _ = RT.forward_hidden(ref_cfg, ref_params,
                                      jnp.asarray(tokens), jnp.asarray(fe))
    assert hidden.dtype == torch.bfloat16 and ref_hidden.dtype == jnp.bfloat16
    off = offset(cfg, fe)
    lg, cache = model.prefill(params, torch.from_numpy(tokens),
                              model.init_cache(2, 16 + off), frames)
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens),
                                      ref_model.init_cache(2, 16 + off),
                                      jnp.asarray(fe))
    assert lg.dtype == torch.float32 and lg_ref.dtype == jnp.float32
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), rtol=0.05,
                               atol=0.05)
    if cfg.enc_dec is not None:
        enc = TT.run_encoder(cfg, params, frames)
        ref_enc = RT.run_encoder(ref_cfg, ref_params, jnp.asarray(fe))
        assert enc.dtype == torch.float32 and ref_enc.dtype == jnp.float32
        np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc),
                                   rtol=1e-2, atol=1e-2)
        for name in ("cross_k", "cross_v"):
            assert cache[name].dtype == torch.float32
            assert c_ref[name].dtype == jnp.float32
            assert tuple(cache[name].shape) == c_ref[name].shape
        assert cache["self"]["k"].dtype == torch.bfloat16
    else:
        assert cache["self"]["k"].dtype == torch.bfloat16
        assert c_ref["self"]["k"].dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count(arch):
    """The port's tree at full width and depth, built on fake tensors
    (nothing allocated), holds the reference's ``param_counts()`` total,
    which leaves out the fp32 norm scales."""
    cfg = get_config(arch)
    with FakeTensorMode():
        params = TT.init_params(cfg, torch.Generator().manual_seed(0))
        sizes = {name: t.numel() for name, t in _leaves(params)}
    norms = sum(n for name, n in sizes.items() if name.split(".")[-1] in (
        "ln1", "ln2", "ln_cross", "final_norm", "enc_norm"))
    enc = cfg.enc_dec.n_encoder_layers if cfg.enc_dec else 0
    per_layer = 3 if cfg.enc_dec else 2
    assert norms == (per_layer * cfg.n_layers + 2 * enc + 1
                     + (1 if enc else 0)) * cfg.d_model
    count = sum(sizes.values()) - norms
    assert count == ref_get_config(arch).param_counts()["total"] == \
        PARAMS[arch] == cfg.n_params


REQS = [([5, 6, 7, 8], 6), ([9, 10, 11], 8), ([3, 4, 5, 200, 17], 5),
        ([42], 7)]


@pytest.mark.parametrize("arch", ARCHS)
def test_token_streams_identical_to_the_reference_engine(arch):
    """Static batching with the frontend, greedy, from the same weights:
    every token of every request and the stats are the reference
    engine's (the prompts left-padded, pixtral's padding between its
    patches and the text)."""
    ref_cfg, ref_params, cfg, params, _, fe = pair(arch, True)
    fe = np.concatenate([fe, fe[::-1]])                  # 4 requests
    ref_engine = RS.ServeEngine(ref_build_model(ref_cfg), ref_params,
                                RS.EngineConfig(max_len=40))
    engine = ServeEngine(build_model(cfg, "cpu"), params,
                         EngineConfig(max_len=40))
    ref_out = ref_engine.generate(
        [RS.Request(prompt=p, max_new_tokens=n) for p, n in REQS],
        jnp.asarray(fe))
    out = engine.generate([Request(prompt=p, max_new_tokens=n)
                           for p, n in REQS], torch.from_numpy(fe))
    assert [c.tokens for c in out] == [c.tokens for c in ref_out]
    assert engine.stats == ref_engine.stats


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_is_single_admission(arch):
    """Continuous batching with a frontend: the first admission round takes
    it, the second raises the reference's ``NotImplementedError``, in both
    engines."""
    ref_cfg, ref_params, cfg, params, _, fe = pair(arch, True)
    engines = [
        (ServeEngine(build_model(cfg, "cpu"), params,
                     EngineConfig(max_len=40, batching="continuous",
                                  slots=2)), Request, torch.from_numpy(fe)),
        (RS.ServeEngine(ref_build_model(ref_cfg), ref_params,
                        RS.EngineConfig(max_len=40, batching="continuous",
                                        slots=2)), RS.Request,
         jnp.asarray(fe))]
    for engine, request, frontend in engines:
        for p, n in REQS:
            engine.submit(request(prompt=p, max_new_tokens=n))
        with pytest.raises(NotImplementedError,
                           match="frontend features are single-admission "
                                 "only: submit all requests before the "
                                 "first step"):
            for _ in range(20):
                engine.step(frontend)
        assert engine.stats["admission_rounds"] == 1


def test_cross_attention_matches_the_reference():
    """``cross_attention`` over ``cross_kv`` of the frames (K and V of
    another sequence, no rope, no cache, dense and not causal) against the
    reference's, on whisper's first decoder layer's cross weights."""
    ref_cfg, ref_params, cfg, params, _, fe = pair("whisper-small", True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[0], ref_params["blocks"]["cross"])
    expect = RT.cross_attention(ref_cfg, ref_p, jnp.asarray(x),
                                *RT.cross_kv(ref_cfg, ref_p, jnp.asarray(fe)))
    p = TT._layer(params["blocks"]["cross"], 0)
    got = TT.cross_attention(cfg, p, torch.from_numpy(x),
                             *TT.cross_kv(cfg, p, torch.from_numpy(fe)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
