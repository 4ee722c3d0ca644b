"""repro_torch's model against the reference on the CPU: the reference's
init_params go through numpy into the port's tree, the same tokens go through
both, in fp32 at the reduced size (2 layers, d_model 64).

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
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model

TOL = dict(rtol=1e-4, atol=2e-4)


def to_numpy_tree(tree):
    """A JAX pytree as nested dicts of numpy arrays, floats as float32."""
    def leaf(a):
        a = np.asarray(a, np.float32) if jnp.issubdtype(a.dtype, jnp.floating) \
            else np.asarray(a)
        return a
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_get_config("qwen1.5-0.5b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    return ref_cfg, ref_params, cfg, params, tokens


def test_params_from_numpy_keeps_tree_shapes_and_types(pair):
    ref_cfg, ref_params, cfg, params, _ = pair
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat[path] = t
    walk(params, ())
    assert len(flat) == len(ref_leaves)
    for path, leaf in ref_leaves:
        key = tuple(p.key for p in path)
        assert tuple(flat[key].shape) == leaf.shape, key
        assert flat[key].dtype == torch.float32
    bf = params_from_numpy(to_numpy_tree(ref_params),
                           dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    assert bf["blocks"]["attn"]["w_q"].dtype == torch.bfloat16
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["blocks"]["ln1"].dtype == torch.float32     # norms stay fp32
    assert bf["final_norm"].dtype == torch.float32


def test_forward_logits_match(pair):
    ref_cfg, ref_params, cfg, params, tokens = pair
    expect, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    out, aux = TT.forward(cfg, params, torch.from_numpy(tokens))
    assert out.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_prefill_logits_and_cache_match(pair):
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :16]),
                                      ref_model.init_cache(2, 24))
    lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :16]),
                              model.init_cache(2, 24))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    assert cache["pos"] == 16 == int(c_ref["pos"])
    for name in ("k", "v"):
        assert cache["self"][name].shape == c_ref["self"][name].shape
        np.testing.assert_allclose(cache["self"][name].numpy(),
                                   np.asarray(c_ref["self"][name]), **TOL)
    assert np.array_equal(cache["self"]["kpos"].numpy(),
                          np.asarray(c_ref["self"]["kpos"]))


def test_eight_decode_steps_match(pair):
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    logits_full, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    _, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :16]),
                                 ref_model.init_cache(2, 24))
    _, cache = model.prefill(params, torch.from_numpy(tokens[:, :16]),
                             model.init_cache(2, 24))
    for t in range(16, 24):
        lg_ref, c_ref = ref_model.decode_step(
            ref_params, jnp.asarray(tokens[:, t]), c_ref)
        lg, cache = model.decode_step(params, torch.from_numpy(tokens[:, t]),
                                      cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(logits_full[:, t]),
                                   **TOL)
    assert cache["pos"] == 24
    np.testing.assert_allclose(cache["self"]["k"].numpy(),
                               np.asarray(c_ref["self"]["k"]), **TOL)


def test_decode_from_a_converted_cache(pair):
    """cache_from_numpy: a cache the reference filled continues in the port."""
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    _, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :16]),
                                 ref_model.init_cache(2, 24))
    cache = cache_from_numpy(to_numpy_tree(c_ref), cfg, device="cpu")
    assert cache["pos"] == 16 and cache["self"]["kpos"].dtype == torch.int32
    lg_ref, _ = ref_model.decode_step(ref_params, jnp.asarray(tokens[:, 16]),
                                      c_ref)
    lg, _ = model.decode_step(params, torch.from_numpy(tokens[:, 16]), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)


def test_reference_prefill_through_its_kernel_matches_the_port(pair):
    """The reference's prefill with use_kernel=True (its Pallas flash kernel
    in interpret mode; no entry point of the reference takes that path)
    against the port's prefill with and without use_kernel."""
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :16]),
                                      ref_model.init_cache(2, 24),
                                      use_kernel=True)
    lg_plain_ref, _ = ref_model.prefill(
        ref_params, jnp.asarray(tokens[:, :16]), ref_model.init_cache(2, 24))
    np.testing.assert_allclose(np.asarray(lg_ref), np.asarray(lg_plain_ref),
                               **TOL)
    for use_kernel in (True, False):
        lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :16]),
                                  model.init_cache(2, 24),
                                  use_kernel=use_kernel)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
        np.testing.assert_allclose(cache["self"]["v"].numpy(),
                                   np.asarray(c_ref["self"]["v"]), **TOL)


def test_prefill_longer_than_the_cache_keeps_the_last_keys(pair):
    """The last ``cap`` keys, as the reference keeps them, but placed by
    position: position ``p`` in slot ``p % cap``, where decode writes it
    (the reference keeps them at slots 0 to cap - 1; ROADMAP Queue 3,
    settled divergences)."""
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    cap, s = 10, tokens.shape[1]
    assert s > cap and s % cap
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens),
                                      ref_model.init_cache(2, cap))
    lg, cache = model.prefill(params, torch.from_numpy(tokens),
                              model.init_cache(2, cap))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    slots = np.arange(s - cap, s) % cap   # of the reference's slots 0..cap-1
    kpos = cache["self"]["kpos"].numpy()
    assert np.array_equal(kpos[:, slots], np.asarray(c_ref["self"]["kpos"]))
    assert np.array_equal(kpos[:, np.arange(s - cap, s) % cap],
                          np.tile(np.arange(s - cap, s), (kpos.shape[0], 1)))
    np.testing.assert_allclose(cache["self"]["k"].numpy()[:, :, :, slots],
                               np.asarray(c_ref["self"]["k"]), **TOL)


def test_cache_is_written_in_place(pair):
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    cache = model.init_cache(2, 24)
    k_before = cache["self"]["k"]
    _, new = model.prefill(params, torch.from_numpy(tokens[:, :8]), cache)
    assert new["self"]["k"] is k_before and float(k_before.abs().sum()) > 0
    assert cache["pos"] == 0 and new["pos"] == 8      # pos is a host int


def test_own_init_params_have_the_reference_shapes_types_and_statistics():
    cfg = get_config("qwen1.5-0.5b").reduced()              # bf16
    ref_params = RT.init_params(ref_get_config("qwen1.5-0.5b").reduced(),
                                jax.random.PRNGKey(1))
    model = build_model(cfg, "cpu")
    params = model.init(1)
    again = model.init(1)
    assert torch.equal(params["embed"], again["embed"])     # seeded
    assert not torch.equal(params["embed"], model.init(2)["embed"])
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_params):
        mine = params
        for p in path:
            mine = mine[p.key]
        key = "/".join(p.key for p in path)
        assert tuple(mine.shape) == leaf.shape, key
        assert mine.dtype == names[str(leaf.dtype)], key
        ref_std = float(np.asarray(leaf, np.float32).std())
        std = float(mine.to(torch.float32).std())
        if ref_std == 0.0:
            assert std == 0.0, key                          # norms, biases
        else:
            assert abs(std - ref_std) < 0.1 * ref_std, key
            assert abs(float(mine.to(torch.float32).mean())) < 0.05 * ref_std + 1e-3


def test_full_config_parameter_count():
    """init at full width is for the GPU; here only the arithmetic: the
    config's own count is what init_params would allocate."""
    cfg = get_config("qwen1.5-0.5b")
    d, ff, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.head_dim_
    per_layer = 4 * d * cfg.n_heads * hd + 3 * cfg.n_heads * hd + 3 * d * ff
    assert cfg.n_params == 2 * v * d + cfg.n_layers * per_layer
    assert 0.61e9 < cfg.n_params < 0.63e9


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b"])
def test_ffn_and_head_take_the_epilogue_kernel_route(arch):
    """use_kernel=True routes the MLP gate and the head through the
    matmul-epilogue wrapper; on CPU tensors its plain version (an fp32
    product, the epilogue, one cast) gives what the plain route gives."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as TL
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = build_model(cfg, "cpu").init(3)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 9, cfg.d_model)).astype(np.float32))
    ops.reset_launch_counts()
    pairs = [(TT._head(cfg, params, x), TT._head(cfg, params, x,
                                                 use_kernel=True))]
    if cfg.gated_mlp:
        mlp = {k: v[0] for k, v in params["blocks"]["mlp"].items()}
        pairs.append((TL.ffn(x, mlp, True), TL.ffn(x, mlp, True,
                                                   use_kernel=True)))
    for plain, kernel in pairs:
        assert kernel.dtype == plain.dtype and kernel.shape == plain.shape
        torch.testing.assert_close(kernel, plain, rtol=1e-6, atol=1e-6)
    assert ops.launch_counts()["matmul_epilogue"] == 0     # CPU: plain
