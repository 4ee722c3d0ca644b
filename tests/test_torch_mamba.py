"""repro_torch's Mamba2 path against the reference on the CPU: each function
of ``models/mamba.py`` against its JAX original, then ``mamba2-1.3b`` at the
reduced size (4 layers, d_model 64, 8 SSD heads of 16, state 16, chunk 32)
through forward / prefill / decode from the reference's weights, all from the
same numpy inputs, in fp32.

Tolerances: the scan's own, rtol = atol = 2e-4 (tests/test_kernels.py holds
the reference's kernel to its oracle with these: fp32 sums in another
order, through exp of cumulative sums); the model's, rtol 1e-4 / atol 2e-4
(tests/test_serving.py holds the reference's prefill/decode to these)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba as RM
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import mamba as M
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=2e-4)


def to_numpy_tree(tree):
    def leaf(a):
        return np.asarray(a, np.float32) if jnp.issubdtype(
            a.dtype, jnp.floating) else np.asarray(a)
    return jax.tree.map(leaf, tree)


def scan_inputs(seed, b, s, h, p, g, n, init=False):
    """x, dt, A_log, B, C, D (and an initial state) as the reference's
    kernel tests draw them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = [rng.normal(size=(b, s, h, p)).astype(f),
           rng.uniform(0.01, 0.2, (b, s, h)).astype(f),
           rng.uniform(-1, 1, (h,)).astype(f),
           rng.normal(size=(b, s, g, n)).astype(f),
           rng.normal(size=(b, s, g, n)).astype(f),
           rng.normal(size=(h,)).astype(f)]
    out.append(rng.normal(size=(b, h, p, n)).astype(f) if init else None)
    return out


def jx(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def th(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ functions
def test_segsum_matches_the_reference():
    la = np.random.default_rng(0).uniform(-1, 0, (2, 3, 16)).astype(np.float32)
    expect = np.asarray(RM.segsum(jnp.asarray(la)))
    out = M.segsum(torch.from_numpy(la)).numpy()
    assert np.array_equal(np.isinf(out), np.isinf(expect))
    fin = np.isfinite(expect)
    np.testing.assert_allclose(out[fin], expect[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_the_reference(with_state):
    rng = np.random.default_rng(1)
    xc = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    ey, es = RM._causal_conv(*jx([xc, w, b, st]))
    y, s = M._causal_conv(*th([xc, w, b, st]))
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(es), rtol=0, atol=0)


def test_ssd_decode_step_matches_the_reference():
    rng = np.random.default_rng(2)
    b, h, p, g, n = 2, 4, 8, 2, 16
    f = np.float32
    args = [rng.normal(size=(b, h, p, n)).astype(f),
            rng.normal(size=(b, h, p)).astype(f),
            rng.uniform(0.01, 0.2, (b, h)).astype(f),
            rng.uniform(-1, 1, (h,)).astype(f),
            rng.normal(size=(b, g, n)).astype(f),
            rng.normal(size=(b, g, n)).astype(f),
            rng.normal(size=(h,)).astype(f)]
    ey, es = RM.ssd_decode_step(*jx(args))
    y, s = M.ssd_decode_step(*th(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(es), **SCAN_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", [
    (2, 64, 4, 16, 1, 32, 16, False),
    (1, 96, 8, 16, 2, 16, 32, True),
    (2, 40, 2, 8, 1, 16, 8, True),
])
def test_ssd_chunked_matches_the_reference(b, s, h, p, g, n, chunk, init):
    args = scan_inputs(3, b, s, h, p, g, n, init)
    *rest, st = args
    ey, es = RM.ssd_chunked(*jx(rest), chunk=chunk,
                            init_state=None if st is None else jnp.asarray(st))
    y, s_ = M.ssd_chunked(*th(rest), chunk=chunk,
                          init_state=None if st is None else
                          torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), **SCAN_TOL)
    np.testing.assert_allclose(s_.numpy(), np.asarray(es), **SCAN_TOL)


def _recurrence(x, dt, A_log, B, C, D, init):
    """The reference's sequential ssd_decode_step over every position."""
    b, s, h, p = x.shape
    st = jnp.asarray(init) if init is not None else \
        jnp.zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(s):
        y_t, st = RM.ssd_decode_step(st, x[:, t], dt[:, t], A_log, B[:, t],
                                     C[:, t], D)
        ys.append(np.asarray(y_t))
    return np.stack(ys, axis=1), np.asarray(st)


@pytest.mark.parametrize("s,chunk,ref_chunk", [(40, 16, 8), (333, 64, 37),
                                               (7, 32, 7)])
def test_ragged_length_and_initial_state(s, chunk, ref_chunk):
    """S that the reference refuses at this chunk: the port pads the last
    chunk; held against the reference at a chunk that divides S and against
    its sequential recurrence, from a non-zero initial state."""
    x, dt, A_log, B, C, D, st = scan_inputs(4, 2, s, 4, 16, 2, 16, init=True)
    ey, es = RM.ssd_chunked(*jx([x, dt, A_log, B, C, D]), chunk=ref_chunk,
                            init_state=jnp.asarray(st))
    ry, rs = _recurrence(*jx([x, dt, A_log, B, C, D]), st)
    for use_ops in (False, True):
        fn = ops.ssd_scan if use_ops else M.ssd_chunked
        y, s_ = fn(*th([x, dt, A_log, B, C, D]), chunk=chunk,
                   init_state=torch.from_numpy(st))
        assert y.shape == (2, s, 4, 16)
        for ref_y, ref_s in ((ey, es), (ry, rs)):
            np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                       **SCAN_TOL)
            np.testing.assert_allclose(s_.numpy(), np.asarray(ref_s),
                                       **SCAN_TOL)


def test_padding_rows_leave_the_scan_exactly_as_it_is():
    """Zero rows after pre-scaling (xbar = 0, log_a = 0, B = C = 0) change
    neither y at the real positions nor the final state."""
    rng = np.random.default_rng(5)
    xbar = torch.from_numpy(rng.normal(size=(1, 48, 2, 16)).astype(np.float32))
    la = torch.from_numpy(-rng.uniform(0, 0.3, (1, 48, 2)).astype(np.float32))
    B, C = (torch.from_numpy(rng.normal(size=(1, 48, 1, 16)).astype(np.float32))
            for _ in range(2))
    y, st = ssd_scan_plain(xbar, la, B, C, chunk=16)
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:, :16])], dim=1)
    y2, st2 = ssd_scan_plain(pad(xbar), pad(la), pad(B), pad(C), chunk=16)
    torch.testing.assert_close(y2[:, :48], y, rtol=0, atol=0)
    torch.testing.assert_close(st2, st, rtol=0, atol=0)
    assert ssd_scan(xbar, la, B, C, chunk=16)[0].equal(y)   # CPU: plain


@pytest.fixture(scope="module")
def block():
    cfg = ref_get_config("mamba2-1.3b").reduced()
    ref_p = RM.mamba_block_init(jax.random.PRNGKey(3), 64, cfg.ssm,
                                jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    x = np.random.default_rng(6).normal(size=(2, 40, 64)).astype(np.float32)
    return cfg.ssm, ref_p, p, x


def test_mamba_block_init_has_the_reference_shapes_and_types(block):
    ssm, ref_p, _, _ = block
    gen = torch.Generator().manual_seed(0)
    mine = M.mamba_block_init(gen, 64, ssm, torch.bfloat16, lead=(3,))
    assert set(mine) == set(ref_p)
    for k, v in ref_p.items():
        assert tuple(mine[k].shape) == (3,) + v.shape, k
        assert mine[k].dtype == (torch.float32 if v.dtype == jnp.float32
                                 and k in ("A_log", "D", "dt_bias",
                                           "norm_scale") else torch.bfloat16)
        if k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
            np.testing.assert_allclose(mine[k][2].float().numpy(),
                                       np.asarray(v), rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_apply_without_cache(block, use_kernel):
    ssm, ref_p, p, x = block
    x = x[:, :32]                  # the reference's kernel path: S % chunk
    expect, _ = RM.mamba_block_apply(ref_p, jnp.asarray(x), ssm,
                                     use_kernel=use_kernel)
    out, cache = M.mamba_block_apply(p, torch.from_numpy(x), ssm,
                                     use_kernel=use_kernel)
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_mamba_block_apply_with_cache_prefill_then_decode(block):
    ssm, ref_p, p, x = block
    h, di = ssm.n_heads(64), ssm.d_inner(64)
    conv_ch = di + 2 * ssm.n_groups * ssm.state_size
    rng = np.random.default_rng(7)
    cache = {"conv": rng.normal(size=(2, 3, conv_ch)).astype(np.float32),
             "state": rng.normal(size=(2, h, ssm.head_dim,
                                       ssm.state_size)).astype(np.float32)}
    ref_c = {k: jnp.asarray(v) for k, v in cache.items()}
    c = {k: torch.from_numpy(v) for k, v in cache.items()}
    for t0, t1 in ((0, 32), (32, 33), (33, 34)):       # prefill, 2 decodes
        e, ref_c = RM.mamba_block_apply(ref_p, jnp.asarray(x[:, t0:t1]), ssm,
                                        ref_c)
        o, c = M.mamba_block_apply(p, torch.from_numpy(x[:, t0:t1]), ssm, c)
        np.testing.assert_allclose(o.numpy(), np.asarray(e), **TOL)
        for k in ("conv", "state"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(ref_c[k]),
                                       **TOL)


def test_kernel_path_passes_the_initial_state(block):
    """The port's kernel path takes the cache's state (the reference's drops
    it): with a non-zero state both paths agree."""
    ssm, _, p, x = block
    h = ssm.n_heads(64)
    rng = np.random.default_rng(8)
    c = {"conv": torch.zeros(2, 3, 128 + 2 * 16),
         "state": torch.from_numpy(rng.normal(size=(2, h, 16, 16))
                                   .astype(np.float32))}
    outs = [M.mamba_block_apply(p, torch.from_numpy(x), ssm, dict(c),
                                use_kernel=k) for k in (False, True)]
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               rtol=1e-6, atol=1e-6)
    zero = M.mamba_block_apply(p, torch.from_numpy(x), ssm,
                               {"conv": c["conv"],
                                "state": torch.zeros_like(c["state"])},
                               use_kernel=True)[0]
    assert not torch.allclose(zero, outs[1][0])


# ---------------------------------------------------------------- model
@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_get_config("mamba2-1.3b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              dtype="float32")
    ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(to_numpy_tree(ref_params), cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    return ref_cfg, ref_params, cfg, params, tokens


def test_params_from_numpy_keeps_the_fp32_leaves(pair):
    ref_cfg, ref_params, cfg, _, _ = pair
    bf = params_from_numpy(to_numpy_tree(ref_params),
                           dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    m = bf["blocks"]["mamba"]
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        assert m[k].dtype == torch.float32, k
    assert bf["blocks"]["ln"].dtype == torch.float32
    assert m["w_in"].dtype == m["conv_w"].dtype == torch.bfloat16
    ref_cache = ref_build_model(ref_cfg).init_cache(2, 8)
    c = cache_from_numpy(to_numpy_tree(ref_cache),
                         dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    assert c["mamba"]["state"].dtype == torch.float32
    assert c["mamba"]["conv"].dtype == torch.bfloat16 and c["pos"] == 0


def test_forward_logits_match(pair):
    ref_cfg, ref_params, cfg, params, tokens = pair
    expect, _ = RT.forward(ref_cfg, ref_params, jnp.asarray(tokens[:, :32]))
    out, aux = TT.forward(cfg, params, torch.from_numpy(tokens[:, :32]))
    assert out.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_prefill_and_eight_decode_steps_match(pair):
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :32]),
                                      ref_model.init_cache(2, 40))
    lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :32]),
                              model.init_cache(2, 40))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    assert cache["pos"] == 32 == int(c_ref["pos"])
    for t in range(32, 40):
        lg_ref, c_ref = ref_model.decode_step(
            ref_params, jnp.asarray(tokens[:, t]), c_ref)
        lg, cache = model.decode_step(params, torch.from_numpy(tokens[:, t]),
                                      cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(cache["mamba"][k].numpy(),
                                   np.asarray(c_ref["mamba"][k]), **TOL)


def test_prefill_decode_matches_forward(pair):
    """As tests/test_serving.py holds the reference: prefill of 16 tokens
    (less than a chunk) and of 33 (ragged: the reference refuses it), then
    decode to the end."""
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    full, _ = model.forward(params, torch.from_numpy(tokens))
    for p in (16, 33):
        lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :p]),
                                  model.init_cache(2, 40))
        np.testing.assert_allclose(lg.numpy(), full[:, p - 1].numpy(),
                                   rtol=1e-4, atol=1e-4)
        for t in range(p, 40):
            lg, cache = model.decode_step(params,
                                          torch.from_numpy(tokens[:, t]),
                                          cache)
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), **TOL)


def test_decode_from_a_converted_cache(pair):
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    _, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :16]),
                                 ref_model.init_cache(2, 24))
    cache = cache_from_numpy(to_numpy_tree(c_ref), cfg, device="cpu")
    lg_ref, _ = ref_model.decode_step(ref_params, jnp.asarray(tokens[:, 16]),
                                      c_ref)
    lg, _ = model.decode_step(params, torch.from_numpy(tokens[:, 16]), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)


def test_reference_prefill_through_its_kernel_matches_the_port(pair):
    """The reference's prefill with use_kernel=True (its Pallas SSD kernel
    in interpret mode, zero initial state) against the port's prefill with
    and without use_kernel."""
    ref_cfg, ref_params, cfg, params, tokens = pair
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg, "cpu")
    lg_ref, c_ref = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :32]),
                                      ref_model.init_cache(2, 40),
                                      use_kernel=True)
    for use_kernel in (True, False):
        lg, cache = model.prefill(params, torch.from_numpy(tokens[:, :32]),
                                  model.init_cache(2, 40),
                                  use_kernel=use_kernel)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
        np.testing.assert_allclose(cache["mamba"]["state"].numpy(),
                                   np.asarray(c_ref["mamba"]["state"]), **TOL)


def test_kernel_route_equals_the_plain_route_on_the_cpu(pair):
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    ops.reset_launch_counts()
    outs = [model.prefill(params, torch.from_numpy(tokens),
                          model.init_cache(2, 40), use_kernel=k)
            for k in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["mamba"]["state"],
                       outs[1][1]["mamba"]["state"])
    assert ops.launch_counts()["ssd_scan"] == 0         # CPU: plain version


def test_cache_is_written_in_place(pair):
    _, _, cfg, params, tokens = pair
    model = build_model(cfg, "cpu")
    cache = model.init_cache(2, 40)
    state = cache["mamba"]["state"]
    _, new = model.prefill(params, torch.from_numpy(tokens[:, :8]), cache)
    assert new["mamba"]["state"] is state and float(state.abs().sum()) > 0
    assert state.dtype == torch.float32 and new["pos"] == 8


def test_own_init_params_have_the_reference_shapes_types_and_statistics():
    cfg = get_config("mamba2-1.3b").reduced()              # bf16
    ref_params = RT.init_params(ref_get_config("mamba2-1.3b").reduced(),
                                jax.random.PRNGKey(1))
    model = build_model(cfg, "cpu")
    params = model.init(1)
    assert torch.equal(params["embed"], model.init(1)["embed"])
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    assert len(leaves) == 12
    for path, leaf in leaves:
        mine = params
        for p in path:
            mine = mine[p.key]
        key = "/".join(p.key for p in path)
        assert tuple(mine.shape) == leaf.shape, key
        assert mine.dtype == names[str(leaf.dtype)], key
        ref = np.asarray(leaf, np.float32)
        got = mine.to(torch.float32).numpy()
        if ref.std() == 0.0 or key.endswith("A_log"):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
        else:
            assert abs(got.std() - ref.std()) < 0.1 * ref.std(), key


def test_full_config_shapes_and_parameter_count():
    """init at full width is for the GPU; here the arithmetic only."""
    cfg = get_config("mamba2-1.3b")
    s = cfg.ssm
    d, di, h = cfg.d_model, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    assert (cfg.n_layers, d, di, h, s.head_dim, s.state_size,
            s.chunk_size) == (48, 2048, 4096, 64, 64, 128, 256)
    assert 1.2e9 < cfg.n_params < 1.5e9
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TT.require_ported(dataclasses.replace(cfg, family="moe"))
