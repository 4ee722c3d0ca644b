"""repro_torch's training slice against the reference on the CPU: AdamW,
gradient compression, the loss with its chunked CE head, the remat policies,
the train step, and the backward kernels' plain versions.

Inputs are numpy arrays from a seeded generator, handed to both packages;
weights go from the reference's ``init_params`` into the port's tree through
``convert.params_from_numpy``.  Reduced configs (2 layers for qwen, 4 for
mamba2, d_model 64), fp32, short sequences.

The reference is differentiated through its plain path only: on this CPU,
``jax.grad`` through ``repro.kernels.ops.flash_attention`` and through
``repro.kernels.ops.ssd_scan`` (interpret mode) raises ``AssertionError``,
so no test compares against gradients of its Pallas kernels.  The port's
``use_kernel=True`` path (its autograd Functions with their plain backwards
on the CPU) is held against the same reference runs.

Tolerances, each with its reason, are stated where they are used."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.core.planner import ShardingPlan as RefPlan
from repro.models import layers as RL
from repro.models import mamba as RM
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import ShardingPlan
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_lse_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain, ssd_scan_plain
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, compress
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.train_loop import make_train_step, value_and_grad

# fp32 on both sides, sums in another order
TOL = dict(rtol=2e-5, atol=2e-6)


def to_numpy_tree(tree):
    """A JAX pytree as nested dicts of numpy arrays, floats as float32."""
    def leaf(a):
        return (np.asarray(a, np.float32)
                if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a))
    return jax.tree.map(leaf, tree)


def flat(tree, prefix=""):
    """{path: numpy array} of a port tree or of a numpy-converted pytree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = (tree.detach().float().numpy()
                            if isinstance(tree, torch.Tensor)
                            else np.asarray(tree, np.float32))
    return out


def rand_tree(rng, dtype_np=np.float32):
    return {"a": rng.normal(size=(5, 7)).astype(dtype_np),
            "b": {"c": rng.normal(size=(3,)).astype(dtype_np),
                  "d": [rng.normal(size=(2, 4)).astype(dtype_np)]}}


def to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v, dtype) for v in tree]
    return torch.tensor(tree).to(dtype)


def to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 37, 100, 101, 2500, 10_000, 12_000])
def test_schedule_matches_reference(step):
    """The reference computes in fp32, the port in fp64: rtol 1e-6."""
    cfg = adamw.AdamWConfig()
    ref = radamw.schedule(radamw.AdamWConfig(), jnp.asarray(step))
    np.testing.assert_allclose(adamw.schedule(cfg, step), float(ref),
                               rtol=1e-6, atol=1e-12)


def test_global_norm_matches_reference():
    tree = rand_tree(np.random.default_rng(0))
    np.testing.assert_allclose(float(adamw.global_norm(to_torch(tree))),
                               float(radamw.global_norm(to_jax(tree))),
                               rtol=1e-6)


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_apply_matches_reference(param_dtype, moment_dtype):
    """Three updates from the same gradients.  fp32 results: the same fp32
    formulas, rtol 1e-5.  A bf16 result is one rounding of an fp32 value
    that may differ in its last bits between the two: one bf16 step, 2^-7
    relative (atol for values near zero at the same scale)."""
    rng = np.random.default_rng(1)
    params, grads = rand_tree(rng), [rand_tree(rng) for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moment_dtype=moment_dtype, grad_clip=0.5)
    cfg, rcfg = adamw.AdamWConfig(**kw), radamw.AdamWConfig(**kw)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    p, rp = to_torch(params, tdt), to_jax(params, jdt)
    st, rst = adamw.init(cfg, p), radamw.init(rcfg, rp)
    for g in grads:
        p, st, m = adamw.apply(cfg, st, to_torch(g), p)
        rp, rst, rm = radamw.apply(rcfg, rst, to_jax(g), rp)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(m["lr"], float(rm["lr"]), rtol=1e-6)
    assert st.step == int(rst.step) == 3
    for mine, ref, dt in ((p, rp, param_dtype), (st.m, rst.m, moment_dtype),
                          (st.v, rst.v, moment_dtype)):
        a, b = flat(mine), flat(to_numpy_tree(ref))
        assert a.keys() == b.keys()
        for key in a:
            if dt == "float32":
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                           atol=1e-7, err_msg=key)
            else:
                np.testing.assert_allclose(
                    a[key], b[key], rtol=2 ** -7,
                    atol=2 ** -7 * float(np.abs(b[key]).max()), err_msg=key)
    assert flat(p).keys() and all(t.dtype == tdt for t in tree_leaves(p))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["none", "bf16", "int8_ef"])
def test_compress_grads_matches_reference(scheme):
    """Two rounds, the residual carried: exact up to fp32 (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    rounds = [rand_tree(rng) for _ in range(2)]
    ef = compress.init_error_feedback(to_torch(rounds[0]))
    ref_ef = rcompress.init_error_feedback(to_jax(rounds[0]))
    for g in rounds:
        out, ef = compress.compress_grads(to_torch(g), ef, scheme)
        ref, ref_ef = rcompress.compress_grads(to_jax(g), ref_ef, scheme)
        for a, b in ((out, ref), (ef.residual, ref_ef.residual)):
            fa, fb = flat(a), flat(to_numpy_tree(b))
            for key in fa:
                np.testing.assert_allclose(fa[key], fb[key], rtol=1e-6,
                                           atol=1e-7, err_msg=key)
    assert compress.payload_bytes(to_torch(rounds[0]), scheme) == \
        rcompress.payload_bytes(to_jax(rounds[0]), scheme)


def test_int8_rounds_half_to_even():
    """x / scale at exact halves: the scale is 1 (max |x| = 127), so the
    quantized values are round-half-to-even of x, as ``jnp.round`` gives."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    q, scale = compress.quantize_int8(torch.tensor(x))
    rq, rscale = rcompress.quantize_int8(jnp.asarray(x))
    assert float(scale) == float(rscale) == 1.0
    expect = [127, 0, 2, 2, 0, -2, -2, 4]
    assert q.tolist() == expect == np.asarray(rq).tolist()
    assert q.dtype == torch.int8


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


ARCHS = ["qwen1.5-0.5b", "mamba2-1.3b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 17))
    return ref_cfg, ref_params, cfg, params, tokens


@pytest.mark.parametrize("ce_chunk", [2048, 16, 12, 1])
def test_loss_matches_reference(pair, ce_chunk):
    """B 4, S 17: 16 predicted positions a row; chunk 12 gives c = 3, 16 =
    5 x 3 + 1, so the last chunk is padded with target -1; chunk 16 gives
    c = 4, no padding; chunk 1 gives c = 1."""
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref, rm = RT.loss_fn(ref_cfg, ref_params, {"tokens": jnp.asarray(tokens)},
                         ce_chunk=ce_chunk)
    loss, m = TT.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens)},
                         ce_chunk=ce_chunk)
    np.testing.assert_allclose(float(loss), float(ref), **TOL)
    np.testing.assert_allclose(float(m["ce"]), float(rm["ce"]), **TOL)
    assert float(m["aux"]) == float(rm["aux"]) == 0.0


def test_chunked_ce_matches_reference_with_padding(pair):
    ref_cfg, ref_params, cfg, params, _ = pair
    rng = np.random.default_rng(4)
    h = rng.normal(size=(3, 10, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (3, 10))
    for chunk in (9, 12, 30, 64):   # c = 3, 4, 10, 10: pads 2, 2, 0, 0
        ref = RT._chunked_ce(ref_cfg, ref_params, jnp.asarray(h),
                             jnp.asarray(tgt), chunk)
        got = TT._chunked_ce(cfg, params, torch.from_numpy(h),
                             torch.from_numpy(tgt), chunk)
        np.testing.assert_allclose(float(got), float(ref), **TOL)


def test_model_loss_and_forward_take_remat(pair):
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    base, _ = model.loss(params, batch)
    logits, _ = model.forward(params, batch["tokens"])
    for remat in ("full", "selective"):
        loss, _ = model.loss(params, batch, remat=remat, use_kernel=True)
        np.testing.assert_allclose(float(loss), float(base), **TOL)
        out, _ = model.forward(params, batch["tokens"], remat=remat)
        torch.testing.assert_close(out, logits, rtol=0, atol=0)


def test_loss_rejects_frontend_batches(pair):
    """An arch without a frontend takes no frontend: a batch that carries
    one gives the loss without it, as the reference's ``loss_fn`` ignores
    it (the frontend archs are tests/test_torch_frontend_archs.py's); an
    ``mtp_depth`` on a tree without an ``mtp`` head adds no MTP term, as in
    the reference (the MTP head is tests/test_torch_mla_archs.py's).  The
    name dates from before the frontend and the MTP head were ported and is
    kept so that the test keeps its history."""
    ref_cfg, ref_params, cfg, params, tokens = pair
    fe = np.random.default_rng(4).standard_normal(
        (4, 2, cfg.d_model)).astype(np.float32)
    toks = torch.from_numpy(tokens)
    got, _ = TT.loss_fn(cfg, params, {"tokens": toks,
                                      "frontend": torch.from_numpy(fe)})
    base, _ = TT.loss_fn(cfg, params, {"tokens": toks})
    assert torch.equal(got, base)
    ref, _ = RT.loss_fn(ref_cfg, ref_params, {"tokens": jnp.asarray(tokens),
                                              "frontend": jnp.asarray(fe)})
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-5)
    no_head, metrics = TT.loss_fn(dataclasses.replace(cfg, mtp_depth=1),
                                  params, {"tokens": toks})
    ref_no_head, ref_metrics = RT.loss_fn(
        dataclasses.replace(ref_cfg, mtp_depth=1), ref_params,
        {"tokens": jnp.asarray(tokens)})
    assert torch.equal(no_head, base)
    assert sorted(metrics) == sorted(ref_metrics) == ["aux", "ce"]
    np.testing.assert_allclose(float(no_head), float(ref_no_head), rtol=2e-5)


def _saved_bytes(fn):
    """Bytes autograd keeps for the backward while ``fn`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops that run (an op a selective checkpoint serves
    from its cache never reaches this mode)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_keep_less(pair):
    """``full`` keeps each layer's input and reruns the layer in the
    backward, weight products included; ``selective`` reruns the layer but
    serves the weight products (``aten.mm``) from what it kept; ``none``
    keeps everything and reruns nothing.  So: fewer bytes saved for the
    backward under both checkpoints than without, as many ``mm`` as without
    under ``selective`` and more under ``full``, more elementwise ops under
    both; and the gradients do not move (rtol 1e-5: the same ops)."""
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    batch = {"tokens": torch.from_numpy(np.tile(tokens, (1, 4)))}
    saved, grads, counts = {}, {}, {}
    for remat in ("none", "selective", "full"):
        live = {}

        def run():
            with _OpCounter() as counter:
                live["g"] = value_and_grad(model, params, batch,
                                           remat=remat)[2]
            counts[remat] = counter.counts
        saved[remat] = _saved_bytes(run)
        grads[remat] = flat(live["g"])
    mm, mul = torch.ops.aten.mm.default, torch.ops.aten.mul.Tensor
    assert saved["full"] < saved["none"] and \
        saved["selective"] < saved["none"], saved
    assert counts["selective"][mm] == counts["none"][mm] \
        < counts["full"][mm]
    assert counts["none"][mul] < counts["selective"][mul]
    assert counts["none"][mul] < counts["full"][mul]
    for remat in ("full", "selective"):
        for key, g in grads[remat].items():
            np.testing.assert_allclose(g, grads["none"][key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEPS = 3
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
# (name, remat, microbatches, compress scheme, use_kernel); the reference
# runs each (microbatches, scheme) once, with remat "none" (remat changes
# what is kept, not what is computed)
VARIANTS = [("plain", "none", 1, "none", False),
            ("remat full", "full", 1, "none", False),
            ("remat selective", "selective", 1, "none", False),
            ("microbatches 2", "none", 2, "none", False),
            ("int8_ef", "none", 1, "int8_ef", False),
            ("kernel path", "none", 1, "none", True),
            ("kernel path, remat full, int8_ef", "full", 1, "int8_ef", True)]


@pytest.fixture(scope="module")
def reference_runs():
    """{(arch, microbatches, scheme): (losses, params, m, v, vs)} of the
    reference's jitted ``make_train_step(use_kernel=False)``, made once;
    ``vs`` is the flat second moment after each step."""
    cache = {}

    def run(arch, micro, scheme):
        key = (arch, micro, scheme)
        if key not in cache:
            ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                          dtype="float32")
            model = ref_build_model(ref_cfg)
            params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
            opt_cfg = radamw.AdamWConfig(**OPT)
            step = jax.jit(ref_make_train_step(
                model, opt_cfg, RefPlan(microbatches=micro),
                compress_scheme=scheme))
            opt = radamw.init(opt_cfg, params)
            ef = rcompress.init_error_feedback(params)
            losses, vs = [], []
            for batch in train_batches(ref_cfg.vocab_size):
                params, opt, ef, m = step(params, opt, ef,
                                          {"tokens": jnp.asarray(batch)})
                losses.append(float(m["loss"]))
                vs.append(flat(to_numpy_tree(opt.v)))
            cache[key] = (losses, to_numpy_tree(params),
                          to_numpy_tree(opt.m), to_numpy_tree(opt.v), vs)
        return cache[key]
    return run


def train_batches(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, (4, 17)) for _ in range(STEPS)]


# AdamW moves a weight by lr x m_hat / sqrt(v_hat) a step: about lr whatever
# its gradient's size, so the change of a weight whose gradient is noise at
# some step may go either way.  Per compress scheme: (noise share, change
# share).  A weight is noise where the reference's sqrt(v) after any step is
# at most the noise share of the leaf's largest: fp32 gradients differ by
# rounding (about 1e-6 of the largest), so 1e-3 leaves m_hat / sqrt(v_hat)
# off by at most about 1e-3; int8_ef may round an element one quantization
# step (1 / 127 of the largest) the other way, so 4 / 127 leaves it off by
# at most 1 / 4.  Any other weight's change is held to the change share of
# the lrs summed (the size of every change); a noise weight's to 2 x the
# lrs summed.
PARAM_TOL = {"none": (1e-3, 1e-2), "int8_ef": (4 / 127, 0.25)}


def assert_param_changes_match(p0, mine, ref, ref_vs, lr_sum, scheme):
    """Each leaf's change over the steps, ``mine - p0``, against the
    reference's, ``ref - p0`` (flat dicts of numpy arrays), to the
    tolerances of :data:`PARAM_TOL`."""
    noise_share, change_share = PARAM_TOL[scheme]
    assert mine.keys() == ref.keys() == p0.keys()
    for key in ref:
        noise = np.zeros(ref[key].shape, bool)
        for v in ref_vs:
            s = np.sqrt(v[key])
            noise |= s <= noise_share * s.max()
        atol = np.where(noise, 2 * lr_sum, change_share * lr_sum)
        err = np.abs((mine[key] - p0[key]) - (ref[key] - p0[key]))
        assert (err <= atol).all(), (
            f"{key}: change off by {float(err.max())} at "
            f"{int((err > atol).sum())} of {err.size} weights, lrs summed "
            f"{lr_sum}")


# qwen and mamba2 under every variant; the hybrid (shared blocks under
# remat) under the plain one and the kernel path's
TRAIN_CASES = [(arch, v) for arch in ARCHS for v in VARIANTS] + [
    ("zamba2-2.7b", VARIANTS[0]), ("zamba2-2.7b", VARIANTS[-1])]


@pytest.mark.parametrize("arch,variant", TRAIN_CASES,
                         ids=[f"{a}-{v[0]}" for a, v in TRAIN_CASES])
def test_train_steps_match_reference(arch, variant, reference_runs):
    """Three steps of the port's ``make_train_step`` against the reference's
    from the same weights and batches, fp32.  Loss of each step: rtol 2e-5
    (sums in another order).  Moments: the same gradients summed, atol 1e-4
    x the largest; with ``int8_ef`` a gradient element that lands within
    rounding of a half step of the int8 grid may round the other way on one
    side, one quantization step (max |g| / 127) that the residual carries
    to the next step: atol 1 / 127 x the largest moment.  Parameters: each
    weight's change against the reference's, :func:`assert_param_changes_match`.
    """
    _, remat, micro, scheme, use_kernel = variant
    losses_ref, p_ref, m_ref, v_ref, vs_ref = reference_runs(arch, micro,
                                                             scheme)
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = params_from_numpy(
        to_numpy_tree(RT.init_params(ref_cfg, jax.random.PRNGKey(0))), cfg,
        device="cpu")
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = make_train_step(build_model(cfg, "cpu"), opt_cfg,
                           ShardingPlan(remat=remat, microbatches=micro),
                           compress_scheme=scheme, use_kernel=use_kernel)
    opt = adamw.init(opt_cfg, params)
    ef = compress.init_error_feedback(params)
    p0 = {k: a.copy() for k, a in flat(params).items()}
    losses = []
    for batch in train_batches(cfg.vocab_size):
        params, opt, ef, metrics = step(params, opt, ef,
                                        {"tokens": torch.from_numpy(batch)})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, losses_ref, rtol=2e-5)
    moment_atol = 1 / 127 if scheme == "int8_ef" else 1e-4
    for mine, ref in ((opt.m, m_ref), (opt.v, v_ref)):
        a, b = flat(mine), flat(ref)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(
                a[key], b[key], rtol=1e-4,
                atol=moment_atol * float(np.abs(b[key]).max()), err_msg=key)
    lr_sum = sum(adamw.schedule(opt_cfg, k) for k in range(1, STEPS + 1))
    assert_param_changes_match(p0, flat(params), flat(p_ref), vs_ref, lr_sum,
                               scheme)


PLANTED = [("qwen1.5-0.5b", "none"), ("mamba2-1.3b", "int8_ef")]


@pytest.mark.parametrize("fault", ["params unchanged", "step of wrong sign"])
@pytest.mark.parametrize("arch,scheme", PLANTED)
def test_param_check_catches_planted_faults(arch, scheme, fault,
                                            reference_runs):
    """:func:`assert_param_changes_match` passes the reference's own
    parameters and fails a train step that returned the old parameters or
    stepped against the gradient, under the looser ``int8_ef`` tolerances
    too."""
    _, p_ref, _, _, vs_ref = reference_runs(arch, 1, scheme)
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    p0 = flat(to_numpy_tree(RT.init_params(ref_cfg, jax.random.PRNGKey(0))))
    ref = flat(p_ref)
    lr_sum = sum(adamw.schedule(adamw.AdamWConfig(**OPT), k)
                 for k in range(1, STEPS + 1))
    assert_param_changes_match(p0, ref, ref, vs_ref, lr_sum, scheme)
    faulty = (p0 if fault == "params unchanged"
              else {k: 2 * p0[k] - ref[k] for k in ref})
    with pytest.raises(AssertionError, match="change off by"):
        assert_param_changes_match(p0, faulty, ref, vs_ref, lr_sum, scheme)


# ---------------------------------------------------------------------------
# the backward kernels' plain versions
# ---------------------------------------------------------------------------

FLASH_CASES = [  # b, hq, hkv, sq, skv, d, causal, window
    (2, 4, 2, 24, 24, 16, True, None),      # GQA
    (1, 2, 2, 37, 37, 8, True, 5),          # ragged S, window
    (1, 4, 1, 20, 20, 8, False, 6),         # GQA 4, window, not causal
    (1, 2, 2, 12, 30, 8, False, None),      # Sq < Skv
    (1, 2, 1, 30, 9, 8, True, 4),           # Sq > Skv: rows that see no key
]


def _flash_inputs(case, seed):
    b, hq, hkv, sq, skv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
             (b, hq, sq, d))]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_plain_matches_autograd_and_jax_vjp(case):
    """Against autograd through ``flash_attention_plain`` and against
    ``jax.vjp`` of the reference's ``attention_dense``: fp32, rtol / atol
    1e-5 (sums in another order)."""
    *_, causal, window = case
    q, k, v, do = _flash_inputs(case, 6)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    lse = flash_lse_plain(tq.detach(), tk.detach(), causal=causal,
                          window=window)
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                    o.detach(), lse, torch.tensor(do),
                                    causal=causal, window=window)
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
    ref = jax.jit(lambda q_, k_, v_, do_: jax.vjp(
        lambda *a: RL.attention_dense(*a, causal=causal, window=window),
        q_, k_, v_)[1](do_))(q, k, v, do)
    for g, a, r in zip(got, auto, ref):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_flash_lse_marks_rows_without_keys():
    case = FLASH_CASES[-1]
    q, k, _, _ = _flash_inputs(case, 7)
    lse = flash_lse_plain(torch.tensor(q), torch.tensor(k), causal=True,
                          window=4)
    # Sq > Skv with a window of 4: rows 12.. see no key of 9
    assert bool((lse[..., 12:] == L.NEG_INF).all())
    assert bool(torch.isfinite(lse[..., :12]).all())


SSD_CASES = [  # b, s, h, p, g, n, chunk, init
    (2, 32, 4, 8, 2, 8, 8, False),          # groups
    (1, 48, 2, 4, 1, 8, 16, True),          # initial state
    (1, 64, 4, 4, 1, 4, 64, False),         # one chunk
    (1, 37, 2, 4, 1, 8, 16, True),          # ragged S (the reference asserts
]                                           # S % chunk == 0)


def _ssd_inputs(case, seed):
    b, s, h, p, g, n, _, init = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a_log = rng.uniform(-1, 1, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    st = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dfin = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, a_log, bm, cm, d, st, dy, dfin


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_bwd_plain_matches_autograd(case):
    """Against autograd through ``ssd_scan_plain`` on pre-scaled inputs
    (ragged S included): fp32, rtol 1e-4 and atol 1e-4 x the largest
    gradient (a long sum of exponentially weighted terms)."""
    chunk = case[6]
    x, dt, a_log, bm, cm, _, st, dy, dfin = _ssd_inputs(case, 8)
    xbar = torch.tensor(x * dt[..., None], requires_grad=True)
    log_a = torch.tensor(dt * -np.exp(a_log), requires_grad=True)
    tb, tc = (torch.tensor(a, requires_grad=True) for a in (bm, cm))
    ts = torch.tensor(st, requires_grad=True) if st is not None else None
    ins = [xbar, log_a, tb, tc] + ([ts] if ts is not None else [])
    y, fin = ssd_scan_plain(xbar, log_a, tb, tc, chunk=chunk, init_state=ts)
    auto = torch.autograd.grad((y, fin), ins,
                               (torch.tensor(dy), torch.tensor(dfin)))
    got = ssd_scan_bwd_plain(*(t.detach() for t in ins[:4]),
                             torch.tensor(dy), torch.tensor(dfin),
                             chunk=chunk,
                             init_state=ts.detach() if ts is not None
                             else None)
    assert (got[4] is None) == (st is None)
    for g, a in zip(got, auto):
        a = a.numpy()
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(a).max()))


@pytest.mark.parametrize("case", [c for c in SSD_CASES
                                  if c[1] % min(c[6], c[1]) == 0])
def test_ssd_scan_gradients_match_jax_vjp(case):
    """``ops.ssd_scan`` (the Function with its plain backward, and the plain
    ``x * dt``, ``dt * A`` and ``D * x`` around it) against ``jax.vjp`` of
    the reference's ``ssd_chunked``, through every input: fp32, rtol 1e-4,
    atol 1e-4 x the largest gradient."""
    chunk = case[6]
    x, dt, a_log, bm, cm, d, st, dy, dfin = _ssd_inputs(case, 9)
    arrays = [x, dt, a_log, bm, cm, d] + ([st] if st is not None else [])
    tens = [torch.tensor(a, requires_grad=True) for a in arrays]
    y, fin = ops.ssd_scan(*tens[:6], chunk=chunk,
                          init_state=tens[6] if st is not None else None)
    got = torch.autograd.grad((y, fin), tens,
                              (torch.tensor(dy), torch.tensor(dfin)))

    def ref_fn(*a):
        return RM.ssd_chunked(*a[:6], chunk=chunk,
                              init_state=a[6] if len(a) > 6 else None)
    ref = jax.jit(lambda cot, *a: jax.vjp(ref_fn, *a)[1](cot))(
        (dy, dfin), *arrays)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()))


# ---------------------------------------------------------------------------
# no wrapper cuts the graph
# ---------------------------------------------------------------------------


def test_every_wrapper_output_has_a_grad_fn():
    rng = np.random.default_rng(10)

    def leaf(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            requires_grad=True)
    q, k, v = leaf(1, 2, 8, 8), leaf(1, 1, 8, 8), leaf(1, 1, 8, 8)
    outs = [ops.flash_attention(q, k, v)]
    x, dt = leaf(1, 8, 2, 4), torch.rand(1, 8, 2, requires_grad=True)
    outs += list(ops.ssd_scan(x, dt, leaf(2), leaf(1, 8, 1, 4),
                              leaf(1, 8, 1, 4), leaf(2), chunk=4))
    a, w, bias = leaf(3, 5), leaf(5, 4), leaf(4)
    for epi in (None, "silu", "gelu"):
        outs.append(ops.matmul_epilogue(a, w, epilogue=epi,
                                        out_dtype=torch.float32))
    outs.append(ops.matmul_epilogue(a, w, bias, epilogue="bias"))
    assert all(o.grad_fn is not None for o in outs)
    # only the input that requires a gradient needs one
    outs = [ops.flash_attention(q.detach(), k.detach(), v),
            ops.matmul_epilogue(a.detach(), w)]
    assert all(o.grad_fn is not None for o in outs)
    with pytest.raises(NotImplementedError, match="layernorm"):
        ops.matmul_epilogue(a, w, epilogue="layernorm")
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
        ops.matmul_epilogue(a, w, epilogue="layernorm")


def test_no_grad_calls_prepare_no_backward(monkeypatch):
    """Under ``torch.no_grad`` an input that requires a gradient gets no
    backward: flash attention computes no log-sum-exp (on the card, one
    that would need D = 64 or 80) and the SSD scan saves nothing."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS

    def no_lse(*args, **kwargs):
        raise AssertionError("log-sum-exp computed without a backward")
    monkeypatch.setattr(FA, "flash_lse_plain", no_lse)
    saved = []
    monkeypatch.setattr(SS.SsdScanFn, "forward", staticmethod(
        lambda ctx, *a: saved.append(a[-1]) or SS.ssd_scan_plain(
            *a[:4], chunk=a[5], init_state=a[4])))
    rng = np.random.default_rng(12)

    def leaf(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            requires_grad=True)
    q, k, v = leaf(1, 2, 8, 32), leaf(1, 2, 8, 32), leaf(1, 2, 8, 32)
    with torch.no_grad():
        assert FA.flash_attention(q, k, v).grad_fn is None
        y, _ = SS.ssd_scan(leaf(1, 8, 2, 4), leaf(1, 8, 2), leaf(1, 8, 1, 4),
                           leaf(1, 8, 1, 4), chunk=4)
        assert y.grad_fn is None
    SS.ssd_scan(leaf(1, 8, 2, 4), leaf(1, 8, 2), leaf(1, 8, 1, 4),
                leaf(1, 8, 1, 4), chunk=4)
    assert saved == [False, True]


# ---------------------------------------------------------------------------
# the chunked-attention checkpoint
# ---------------------------------------------------------------------------


def test_chunked_attention_recomputes_in_the_backward():
    """Above 2048 positions ``layers.attention`` runs ``attention_chunked``
    under a checkpoint when grad mode is on, as the reference does: the
    forward values are the same, the gradients equal autograd through the
    bare function (rtol 1e-5: the same ops, recomputed), and the backward
    keeps only the inputs instead of every KV chunk's residuals."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.normal(size=(1, 2, 2100, 8)).astype(
        np.float32), requires_grad=True) for _ in range(3))
    g = torch.tensor(rng.normal(size=(1, 2, 2100, 8)).astype(np.float32))
    kw = dict(causal=True, window=700)
    with torch.no_grad():
        plain = L.attention_chunked(q, k, v, **kw)
    box = {}
    saved_ckpt = _saved_bytes(lambda: box.update(
        out=L.attention(q, k, v, **kw)))
    saved_bare = _saved_bytes(lambda: box.update(
        bare=L.attention_chunked(q, k, v, **kw)))
    torch.testing.assert_close(box["out"], plain, rtol=0, atol=0)
    torch.testing.assert_close(box["bare"], plain, rtol=0, atol=0)
    got = torch.autograd.grad(box["out"], (q, k, v), g)
    ref = torch.autograd.grad(box["bare"], (q, k, v), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    inputs = 3 * q.numel() * q.element_size()
    assert saved_ckpt <= inputs < saved_bare / 4, (saved_ckpt, saved_bare)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_step_matches_the_functional_step(dtype):
    """``make_train_step(donate=True)`` updates the given weights and
    moments in place, as the reference's trainer donates them: three steps
    give the functional step's numbers bit for bit, and every leaf of the
    returned params and moments is the given one (same storage)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              dtype=dtype)
    model = build_model(cfg, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=10)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(3))}
    runs = {}
    for donate in (False, True):
        params = model.init(0)
        opt = adamw.init(opt_cfg, params)
        step = make_train_step(model, opt_cfg, ShardingPlan(remat="full"),
                               donate=donate)
        given = [t.data_ptr() for t in tree_leaves([params, opt.m, opt.v])]
        losses = []
        for _ in range(3):
            params, opt, _, m = step(params, opt, None, batch)
            losses.append(float(m["loss"]))
        kept = [t.data_ptr() for t in tree_leaves([params, opt.m, opt.v])]
        assert (kept == given) == donate
        runs[donate] = (losses, tree_leaves([params, opt.m, opt.v]),
                        opt.step)
    assert runs[True][0] == runs[False][0] and runs[True][2] == 3
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))
