"""repro_torch's hybrid family against the reference on the CPU:
``zamba2-2.7b`` at the reduced size (4 layers, d_model 64, ``attn_every`` 2,
one shared attention+MLP block of 4 heads of 16, 8 SSD heads of 16, state
16, chunk 32), and a variant with two shared blocks over 8 layers so that
the blocks alternate (``seg % n_shared``).  The reference's init_params go
through numpy into the port's tree; the same tokens go through both, in fp32.

Tolerance: rtol 1e-4, atol 2e-4, the numbers tests/test_serving.py holds the
reference's own prefill/decode to (fp32 sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build_model
from repro.runtime import serve_engine as RS
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_engine import EngineConfig, Request, ServeEngine

TOL = dict(rtol=1e-4, atol=2e-4)
VARIANTS = {"reduced": {},
            "two-shared-blocks": dict(n_layers=8, n_shared_attn_blocks=2)}


def to_numpy_tree(tree):
    def leaf(a):
        return np.asarray(a, np.float32) if jnp.issubdtype(
            a.dtype, jnp.floating) else np.asarray(a)
    return jax.tree.map(leaf, tree)


def _variant(cfg, n_layers=None, n_shared_attn_blocks=None):
    cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(
            cfg, n_layers=n_layers,
            hybrid=dataclasses.replace(
                cfg.hybrid, n_shared_attn_blocks=n_shared_attn_blocks))
    return cfg


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    kw = VARIANTS[request.param]
    ref_cfg = _variant(ref_get_config("zamba2-2.7b"), **kw)
    cfg = _variant(get_config("zamba2-2.7b"), **kw)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 36))
    return ref_cfg, ref_params, cfg, params, tokens


def test_params_from_numpy_carries_the_shared_blocks(pair):
    ref_cfg, ref_params, cfg, params, _ = pair
    n_shared = cfg.hybrid.n_shared_attn_blocks
    assert isinstance(params["shared_attn"], list)
    assert len(params["shared_attn"]) == len(ref_params["shared_attn"]) \
        == n_shared
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    for path, leaf in ref_leaves:
        mine = params
        for p in path:
            mine = mine[p.idx] if hasattr(p, "idx") else mine[p.key]
        assert tuple(mine.shape) == leaf.shape, path
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(leaf, np.float32))
    bf = params_from_numpy(to_numpy_tree(ref_params),
                           dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    blk = bf["shared_attn"][-1]
    assert blk["ln1"].dtype == blk["ln2"].dtype == torch.float32
    assert blk["mlp"]["w_gate"].dtype == torch.bfloat16
    assert bf["blocks"]["mamba"]["A_log"].dtype == torch.float32


def test_init_cache_has_the_reference_layout(pair):
    ref_cfg, _, cfg, _, _ = pair
    ref_cache = ref_build_model(ref_cfg).init_cache(2, 24)
    cache = build_model(cfg, "cpu").init_cache(2, 24)
    n_app = cfg.n_layers // cfg.hybrid.attn_every
    assert cache["attn"]["k"].shape[0] == n_app
    for group in ("mamba", "attn"):
        for name, ref_leaf in ref_cache[group].items():
            assert tuple(cache[group][name].shape) == ref_leaf.shape, name
    converted = cache_from_numpy(to_numpy_tree(ref_cache), cfg, "cpu")
    assert converted["attn"]["kpos"].dtype == torch.int32
    assert converted["mamba"]["state"].dtype == torch.float32


def test_forward_logits_match(pair):
    ref_cfg, ref_params, cfg, params, tokens = pair
    expect, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens[:, :32]))
    out, aux = TT.forward(cfg, params, torch.from_numpy(tokens[:, :32]))
    assert out.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_four_greedy_decode_steps_match(pair, use_kernel):
    """Prefill of 32 tokens, then 4 greedy steps, with ``use_kernel`` on both
    sides (the reference's Pallas kernels in interpret mode, from a zero
    cache, against the port's plain versions of its kernels)."""
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :32]),
                                      ref_model.init_cache(2, 40),
                                      use_kernel=use_kernel)
    lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :32]),
                              model.init_cache(2, 40), use_kernel=use_kernel)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    assert cache["pos"] == 32 == int(c_ref["pos"])
    for _ in range(4):
        tok = np.asarray(jnp.argmax(lg_ref, axis=-1))
        assert np.array_equal(tok, torch.argmax(lg, dim=-1).numpy())
        lg_ref, c_ref = ref_model.decode_step(ref_params, jnp.asarray(tok),
                                              c_ref, use_kernel=use_kernel)
        lg, cache = model.decode_step(params, torch.from_numpy(tok.copy()),
                                      cache, use_kernel=use_kernel)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    for group, names in (("mamba", ("conv", "state")), ("attn", ("k", "v"))):
        for name in names:
            np.testing.assert_allclose(cache[group][name].numpy(),
                                       np.asarray(c_ref[group][name]), **TOL)
    assert np.array_equal(cache["attn"]["kpos"].numpy(),
                          np.asarray(c_ref["attn"]["kpos"]))


def test_kernel_route_equals_the_plain_route_on_the_cpu(pair):
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    ops.reset_launch_counts()
    outs = [model.prefill(params, torch.from_numpy(tokens),
                          model.init_cache(2, 40), use_kernel=k)
            for k in (False, True)]
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert set(ops.launch_counts().values()) == {0}     # CPU: plain versions


def test_cache_is_written_in_place(pair):
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    cache = model.init_cache(2, 40)
    k, state = cache["attn"]["k"], cache["mamba"]["state"]
    _, new = model.prefill(params, torch.from_numpy(tokens[:, :8]), cache)
    assert new["attn"]["k"] is k and new["mamba"]["state"] is state
    assert float(k[-1].abs().sum()) > 0 and float(state[-1].abs().sum()) > 0


REQS = [([5, 6, 7, 8], 6), ([9, 10, 11], 8), ([3, 4, 5, 200, 17], 5),
        ([42], 7), ([100, 101], 6)]


@pytest.mark.parametrize("engine_kw", [
    dict(batching="static"),
    dict(batching="continuous", slots=2),
], ids=["static", "continuous-2"])
def test_token_streams_identical_to_the_reference_engine(pair, engine_kw):
    """Greedy at temperature 0 from the same weights; every history the
    engines prefill is at most 13 tokens, less than the reduced chunk."""
    ref_cfg, ref_params, cfg, params, _ = pair
    ref_engine = RS.ServeEngine(ref_build_model(ref_cfg), ref_params,
                                RS.EngineConfig(max_len=64, **engine_kw))
    engine = ServeEngine(build_model(cfg, "cpu"), params,
                         EngineConfig(max_len=64, **engine_kw))
    ref_out = ref_engine.generate(
        [RS.Request(prompt=p, max_new_tokens=n) for p, n in REQS])
    out = engine.generate([Request(prompt=p, max_new_tokens=n)
                           for p, n in REQS])
    assert [c.tokens for c in out] == [c.tokens for c in ref_out]
    assert engine.stats == ref_engine.stats


def test_full_config_shapes_and_parameter_count():
    """init at full width is for the GPU; here the arithmetic only."""
    cfg = get_config("zamba2-2.7b")
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff,
            s.n_heads(cfg.d_model), s.head_dim, s.state_size,
            cfg.vocab_size) == (54, 2560, 32, 80, 10240, 80, 64, 64, 32000)
    assert cfg.n_layers // cfg.hybrid.attn_every == 9
    assert cfg.n_params == 2_526_817_728
    with pytest.raises(ValueError, match="multiple of attn_every"):
        TT.require_ported(dataclasses.replace(cfg, n_layers=50))
