"""The plain dense archs ``qwen1.5-4b``, ``stablelm-12b`` and
``qwen1.5-110b`` in the port against the reference on the CPU.

The port of ``tests/test_models_smoke.py``'s ``test_forward_and_train_step``
and ``test_decode_cache_shapes`` on each arch's ``.reduced()`` config in
fp32: the reference's init params go through numpy into the port's tree, the
same tokens through both.  ``.reduced()`` sets ``n_kv_heads = n_heads``, so
it hides GQA; the same checks run again at a small GQA config of each arch
(4 heads over 2 kv heads, and for stablelm a head dim of 20, which is not a
power of two, as its 160 is not), through prefill and decode steps and on
the port's kernel path too (whose wrappers take their plain versions on CPU
tensors).  Each full config's parameter count is held to the reference's
``param_counts()``, the port's tree built on fake tensors with nothing
allocated.

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
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import value_and_grad

ARCHS = ("qwen1.5-4b", "stablelm-12b", "qwen1.5-110b")
TOL = dict(rtol=1e-4, atol=2e-4)
# (reference count from its param_counts(), published size)
PARAMS = {"qwen1.5-4b": 3_950_161_920, "stablelm-12b": 12_142_510_080,
          "qwen1.5-110b": 111_208_595_456}


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


def configs(arch, gqa):
    """(reference config, port config): ``.reduced()`` in fp32, with
    ``gqa`` 4 heads over 2 kv heads (stablelm: head dim 20)."""
    kw = {"dtype": "float32"}
    if gqa:
        kw.update(n_heads=4, n_kv_heads=2)
        if arch == "stablelm-12b":
            kw["head_dim"] = 20
    return (dataclasses.replace(ref_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def pair(arch, gqa):
    ref_cfg, cfg = configs(arch, gqa)
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    return ref_cfg, ref_params, cfg, params, tokens


@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch, gqa):
    """One forward and one train step, as the reference's smoke test runs
    them, with the port held to the reference: logits, loss, every
    gradient leaf, and the parameters after one AdamW step."""
    ref_cfg, ref_params, cfg, params, tokens = pair(arch, gqa)
    assert (cfg.n_kv_heads < cfg.n_heads) == gqa
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    ref_batch = {"tokens": jnp.asarray(tokens)}

    expect, _ = ref_model.forward(ref_params, ref_batch["tokens"])
    logits, _ = model.forward(params, batch["tokens"])
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
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
    changed = 0.0
    for name, p in _leaves(new_params):
        np.testing.assert_allclose(p.numpy(), ref_new[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        changed = max(changed, float((p - dict(_leaves(params))[name])
                                     .abs().max()))
    assert changed > 0


@pytest.mark.parametrize("gqa", [False, True], ids=["reduced", "gqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_shapes(arch, gqa):
    """The port's decode cache has the reference's shapes and types: k and
    v keep ``n_kv_heads`` heads of the head dim."""
    ref_cfg, cfg = configs(arch, gqa)
    ref_cache = ref_build_model(ref_cfg).init_cache(batch=2, max_len=32)
    cache = build_model(cfg, "cpu").init_cache(2, 32)
    for name in ("k", "v", "kpos"):
        mine, ref = cache["self"][name], ref_cache["self"][name]
        assert tuple(mine.shape) == ref.shape, name
        assert str(mine.dtype).split(".")[-1] == str(ref.dtype), name
    assert cache["self"]["k"].shape[2:] == (cfg.n_kv_heads, 32,
                                           cfg.head_dim_)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_prefill_and_decode_match(arch, use_kernel):
    """At the GQA config: prefill of 10 tokens, then 6 decode steps, each
    step's logits against the reference's and against its full forward;
    the cache's k and v after the last step."""
    ref_cfg, ref_params, cfg, params, tokens = pair(arch, True)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    full, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens))
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :10]),
                                      ref_model.init_cache(2, 16))
    lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :10]),
                              model.init_cache(2, 16), use_kernel=use_kernel)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    for t in range(10, 16):
        lg_ref, c_ref = ref_model.decode_step(
            ref_params, jnp.asarray(tokens[:, t]), c_ref)
        lg, cache = model.decode_step(params, torch.from_numpy(tokens[:, t]),
                                      cache, use_kernel=use_kernel)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(full[:, t]), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["self"][name].numpy(),
                                   np.asarray(c_ref["self"][name]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count(arch):
    """The port's tree at full width and depth, built on fake tensors
    (nothing allocated), holds the reference's ``param_counts()`` total,
    which leaves out the fp32 norm scales (two a layer and the final one,
    d_model each)."""
    cfg = get_config(arch)
    with FakeTensorMode():
        params = TT.init_params(cfg, torch.Generator().manual_seed(0))
        sizes = {name: t.numel() for name, t in _leaves(params)}
    norms = sum(n for name, n in sizes.items()
                if name.split(".")[-1] in ("ln1", "ln2", "final_norm"))
    assert norms == (2 * cfg.n_layers + 1) * cfg.d_model
    count = sum(sizes.values()) - norms
    assert count == ref_get_config(arch).param_counts()["total"] == \
        PARAMS[arch] == cfg.n_params
