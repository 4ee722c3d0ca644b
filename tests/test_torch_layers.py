"""repro_torch.models.layers against repro.models.layers: the same numpy
inputs through both, in fp32 on the CPU.  Tolerances: 1e-5 / 1e-6 for
elementwise code and single products (fp32 sums in another order; sin/cos and
exp from two math libraries), as noted per test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels import ops
from repro_torch.models import layers as TL


def randn(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(j, np.float32), rtol=rtol, atol=atol)


def test_rms_norm_scales_by_one_plus_scale():
    rng = np.random.default_rng(0)
    x, scale = randn(rng, (2, 5, 64)), 0.1 * randn(rng, (64,))
    close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
          RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    zero = TL.rms_norm(torch.from_numpy(x), torch.zeros(64))
    np.testing.assert_allclose(zero.square().mean(-1).numpy(), 1.0, rtol=1e-3)


def test_rms_norm_keeps_the_activation_type():
    x = torch.from_numpy(randn(np.random.default_rng(1), (3, 64)))
    out = TL.rms_norm(x.to(torch.bfloat16), torch.zeros(64))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_split_half(theta):
    rng = np.random.default_rng(2)
    x = randn(rng, (2, 4, 12, 16))
    pos = np.broadcast_to(np.arange(12) + 3, (2, 12)).astype(np.int32)
    expect = RL.apply_rope(jnp.asarray(x),
                           jnp.asarray(pos)[:, None, :].repeat(4, 1), theta)
    out = TL.apply_rope(torch.from_numpy(x),
                        torch.from_numpy(pos.copy())[:, None, :], theta)
    close(out, expect, atol=2e-5)           # angles up to 15 rad in fp32
    close(TL.rope_freqs(16, theta), RL.rope_freqs(16, theta), atol=1e-7)


def test_dense_layout_and_bias():
    rng = np.random.default_rng(3)
    x, w, b = randn(rng, (2, 7, 32)), randn(rng, (32, 48)), randn(rng, (48,))
    close(TL.dense(*(torch.from_numpy(a) for a in (x, w, b))),
          RL.dense(*(jnp.asarray(a) for a in (x, w, b))), atol=1e-5)
    y = TL.dense(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w))
    assert y.dtype == torch.bfloat16         # weights follow the activation


@pytest.mark.parametrize("causal,window,q_offset,sq,skv,hq,hkv", [
    (True, None, 0, 40, 40, 4, 4),
    (True, None, 0, 40, 40, 8, 2),          # GQA
    (True, 8, 0, 40, 40, 4, 2),             # sliding window
    (False, None, 0, 24, 40, 4, 4),         # non-causal, Sq != Skv
    (True, None, 39, 1, 40, 4, 2),          # decode: one query at an offset
    (True, 16, 30, 10, 40, 4, 4),           # offset + window
])
def test_attention_dense(causal, window, q_offset, sq, skv, hq, hkv):
    rng = np.random.default_rng(4)
    q, k, v = randn(rng, (2, hq, sq, 16)), randn(rng, (2, hkv, skv, 16)), \
        randn(rng, (2, hkv, skv, 16))
    expect = RL.attention_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window,
                                q_offset=q_offset)
    out = TL.attention_dense(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, window=window,
                             q_offset=q_offset)
    close(out, expect)


def test_attention_dense_dk_differs_from_dv():
    rng = np.random.default_rng(5)
    q, k, v = randn(rng, (1, 2, 8, 24)), randn(rng, (1, 2, 8, 24)), \
        randn(rng, (1, 2, 8, 16))
    out = TL.attention_dense(*(torch.from_numpy(a) for a in (q, k, v)),
                             scale=0.2)
    close(out, RL.attention_dense(*(jnp.asarray(a) for a in (q, k, v)),
                                  scale=0.2))
    assert out.shape == (1, 2, 8, 16)


def test_band_mask():
    qp, kp = np.arange(6) + 2, np.arange(9)
    for causal, window in ((True, None), (True, 3), (False, 4), (False, None)):
        expect = np.asarray(RL._band_mask(jnp.asarray(qp), jnp.asarray(kp),
                                          causal, window))
        out = TL._band_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                            causal, window)
        assert np.array_equal(out.numpy(), expect)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 700),
                                           (False, None)])
def test_attention_chunked_long_sequence(causal, window):
    """S = 2304 > 2048 with a ragged tail (2304 = 2 x 1024 + 256), one KV
    head: the chunked path against the reference's chunked path and against
    the port's dense path."""
    rng = np.random.default_rng(6)
    s = 2304
    q, k, v = randn(rng, (1, 2, s, 16)), randn(rng, (1, 1, s, 16)), \
        randn(rng, (1, 1, s, 16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = TL.attention_chunked(tq, tk, tv, causal=causal, window=window)
    expect = RL.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, window=window)
    close(out, expect, atol=2e-5)
    close(out, TL.attention_dense(tq, tk, tv, causal=causal,
                                  window=window).numpy(), atol=2e-5)


def _attention_f64(q, k, v, causal, window):
    """Softmax attention in float64 (numpy), one KV head per query head."""
    s = np.einsum("hqd,hkd->hqk", q, k) / np.sqrt(q.shape[-1])
    qp, kp = np.arange(q.shape[1])[:, None], np.arange(k.shape[1])[None, :]
    keep = (kp <= qp) if causal else np.ones_like(qp * kp, bool)
    if window is not None:
        keep &= qp - kp < window
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("hqk,hkd->hqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 700)])
def test_attention_chunked_long_sequence_bf16(causal, window):
    """bf16 at S = 2304 (chunked, ragged tail): scores and p @ v are summed
    in fp32 from the bf16 operands, as the reference's
    preferred_element_type=float32 sums them.  Rounding either product to
    bf16 first multiplies the error against float64 about eightfold (0.121
    against the reference's 0.016 at this case)."""
    rng = np.random.default_rng(16)
    s = 2304
    tq, tk, tv = (torch.from_numpy(2 * randn(rng, (1, 2, s, 64)))
                  .to(torch.bfloat16) for _ in range(3))
    q, k, v = (t.to(torch.float32).numpy() for t in (tq, tk, tv))
    out = TL.attention_chunked(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    out = out.to(torch.float32).numpy()
    expect = np.asarray(RL.attention_chunked(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal, window=window), np.float32)
    exact = _attention_f64(*(a[0].astype(np.float64) for a in (q, k, v)),
                           causal, window)[None]
    err, ref_err = np.abs(out - exact).max(), np.abs(expect - exact).max()
    assert err <= 1.1 * ref_err, (err, ref_err)
    np.testing.assert_allclose(out, expect, rtol=0, atol=2e-2)


def test_attention_chunked_short_is_dense():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(randn(rng, (1, 2, 64, 16))) for _ in range(3))
    assert torch.equal(TL.attention_chunked(q, k, v),
                       TL.attention_dense(q, k, v))


def test_attention_dispatch(monkeypatch):
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(randn(rng, (1, 2, 32, 16))) for _ in range(3))
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    dense = TL.attention(q, k, v)
    assert not calls
    # kernel route: taken for sq > 1 and Dk == Dv; a CPU tensor then gets the
    # kernel's plain version, which is attention_dense
    assert torch.equal(TL.attention(q, k, v, use_kernel=True), dense)
    assert len(calls) == 1 and calls[0]["causal"] is True
    TL.attention(q[:, :, -1:], k, v, q_offset=31, use_kernel=True)   # decode
    TL.attention(q, k, v[..., :8], use_kernel=True)                  # Dk != Dv
    assert len(calls) == 1
    # beyond 2048 positions the plain route is the chunked one
    chunked = []
    monkeypatch.setattr(TL, "attention_chunked",
                        lambda *a, **kw: chunked.append(1) or a[0])
    big = torch.zeros(1, 1, 2049, 16)
    TL.attention(big, big, big)
    assert chunked == [1]
    close(TL.attention(q[:, :, -1:], k, v, q_offset=31),
          RL.attention(jnp.asarray(q.numpy())[:, :, -1:],
                       jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                       q_offset=31))


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"),
                                       (False, "silu")])
def test_ffn(gated, act):
    rng = np.random.default_rng(9)
    x = randn(rng, (2, 5, 32))
    p = {"w_up": randn(rng, (32, 64)) / 6, "w_down": randn(rng, (64, 32)) / 8}
    if gated:
        p["w_gate"] = randn(rng, (32, 64)) / 6
    else:
        p["b_up"], p["b_down"] = randn(rng, (64,)), randn(rng, (32,))
    expect = RL.ffn(jnp.asarray(x), {k: jnp.asarray(a) for k, a in p.items()},
                    gated, act)
    out = TL.ffn(torch.from_numpy(x),
                 {k: torch.from_numpy(a) for k, a in p.items()}, gated, act)
    close(out, expect)          # gelu is the tanh approximation on both sides
