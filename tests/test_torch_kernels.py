"""The plain PyTorch versions of the port's kernels against the reference's
Pallas kernels in interpret mode (as tests/test_kernels.py runs them), from
the same numpy inputs.  The CUDA kernels themselves are held against these
plain versions on the GPU by chip_smoke.py.

Tolerances are the reference's own: fp32 rtol 2e-5 (both sides multiply in
full fp32 and differ in the order of the sums), bf16 3e-2 (8 bits of
mantissa); the SSD scan 2e-4 in fp32 (sums through exp of cumulative sums);
the matmul epilogue 2e-5 / 2e-4 in fp32 and 3e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels import tsmm as ref_tsmm
from repro.models.mamba import ssd_decode_step as ref_ssd_decode_step
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_body)
from repro_torch.kernels.flash_attention import \
    reads_in_place as flash_reads_in_place
from repro_torch.kernels.matmul_epilogue import (matmul_body,
                                                 matmul_epilogue,
                                                 matmul_epilogue_plain,
                                                 tma_describable)
from repro_torch.kernels.ssd_scan import reads_in_place as ssd_reads_in_place
from repro_torch.kernels.ssd_scan import scratch_shapes
from repro_torch.kernels.tsmm import (PRODUCTS, TILE, _splits, tsmm_upper,
                                      tsmm_upper_plain)
from repro_torch.models.layers import attention_dense
from repro_torch.models.mamba import ssd_decode_step


def randn(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def to_np(t):
    return t.to(torch.float32).numpy()


# --------------------------------------------------------------- tsmm
@pytest.mark.parametrize("m,n,bm,bn", [
    (512, 256, 256, 128),
    (1024, 512, 512, 256),
    (768, 384, 256, 128),
    (2048, 128, 512, 128),
])
def test_tsmm_shapes(m, n, bm, bn):
    x = randn(np.random.default_rng(7), (m, n))
    expect = np.asarray(ref_ops.tsmm(jnp.asarray(x), bm=bm, bn=bn))
    out = ops.tsmm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), expect, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, 2e-5), (torch.bfloat16, jnp.bfloat16, 3e-2)])
def test_tsmm_dtypes(dtype, jdtype, tol):
    x = randn(np.random.default_rng(8), (512, 256))
    expect = np.asarray(ref_ops.tsmm(jnp.asarray(x, jdtype), bm=256, bn=128),
                        np.float32)
    out = ops.tsmm(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype
    np.testing.assert_allclose(to_np(out), expect, rtol=tol, atol=tol * 30)


def test_tsmm_symmetry():
    x = torch.from_numpy(randn(np.random.default_rng(9), (512, 256)))
    out = ops.tsmm(x)
    assert torch.equal(out, out.T)


def test_tsmm_ridge_epilogue():
    x = randn(np.random.default_rng(10), (512, 256))
    reg = 7.25
    out = to_np(ops.tsmm(torch.from_numpy(x), reg=reg))
    plain = to_np(ops.tsmm(torch.from_numpy(x)))
    np.testing.assert_allclose(out - plain, reg * np.eye(256, dtype=np.float32),
                               rtol=0, atol=1e-4)
    expect = np.asarray(ref_ops.tsmm(jnp.asarray(x), bm=256, bn=128, reg=reg))
    np.testing.assert_allclose(out, expect, rtol=2e-5, atol=2e-4)


def test_tsmm_upper_tiles_match_the_reference_kernel():
    """Same upper tiles as the TPU kernel at bn = 128, whole diagonal tiles
    included.  Below them the port writes zeros; the reference kernel leaves
    those tiles unwritten (interpret mode shows NaN there) and relies on the
    mirror in ops.tsmm to drop them."""
    x = randn(np.random.default_rng(11), (512, 384))
    expect = np.asarray(ref_tsmm.tsmm_upper(jnp.asarray(x), bm=256, bn=TILE,
                                            reg=0.5))
    out = to_np(tsmm_upper(torch.from_numpy(x), reg=0.5))
    blk = np.arange(384) // TILE
    upper = blk[:, None] <= blk[None, :]
    np.testing.assert_allclose(out[upper], expect[upper], rtol=2e-5, atol=2e-4)
    assert np.all(out[~upper] == 0)
    assert np.any(out[1:TILE, 0] != 0)          # diagonal tile is whole


def test_tsmm_split_heuristic():
    assert _splits(512, 256) == 1                # short: one pass
    assert _splits(262144, 1024) == 11           # 36 tiles x 11 = 3 waves
    assert _splits(262144, 128) == 132           # one tile: one wave
    assert _splits(4096, 4096) == 1              # 528 tiles = 4 waves
    assert _splits(262144, 1536) == 22           # 78 tiles x 22 = 13 waves
    assert _splits(5000, 200) == 4               # 3 tiles, 1024 rows each


def test_tsmm_splits_fill_whole_waves():
    """Of every count the rows allow, the one chosen needs the fewest waves
    of 132 blocks per row it covers."""
    for m, n in ((262144, 1024), (262144, 1536), (65536, 512), (20000, 100)):
        nb = -(-n // TILE)
        tiles = nb * (nb + 1) // 2
        cost = [-(-tiles * s // 132) / s
                for s in range(1, max(1, m // 1024) + 1)]
        assert abs(cost[_splits(m, n) - 1] - min(cost)) < 1e-12


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna.tf32.f32``: the low 13 bits of the
    mantissa rounded off to nearest, ties away from zero, by integer
    arithmetic on the bits (the sign sits apart, so adding half of the
    dropped unit to the bits rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tsmm_tf32_model(x: torch.Tensor, products: int) -> torch.Tensor:
    """The kernel's arithmetic: x = hi + lo in tf32, products of tf32 values
    (exact in fp32) summed in fp32; three products lo.hi + hi.lo + hi.hi,
    or hi.hi alone."""
    x = x.to(torch.float32)
    hi = tf32_rna(x)
    g = hi.T @ hi
    if products == 3:
        lo = tf32_rna(x - hi)
        g = (lo.T @ hi + hi.T @ lo) + g
    return g


def tsmm_tol(m: int) -> dict:
    """chip_smoke.py's fp32 tolerance for the kernel: the reference's rtol
    2e-5 / atol 2e-4, atol growing with m beyond 512."""
    return dict(rtol=2e-5, atol=2e-4 * max(1.0, m / 512))


def test_tf32_rounding_is_to_nearest_ties_away():
    rng = np.random.default_rng(17)
    v = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 7, 4096)) \
        .astype(np.float32)
    # ties: the 13 dropped bits exactly half a tf32 unit, both signs
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3 + 3 * 2.0 ** -10],
                   np.float32)
    v = np.concatenate([v, tie])
    mant, exp = np.frexp(v.astype(np.float64))          # |mant| in [0.5, 1)
    expect = np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5) \
        * 2.0 ** (exp - 11)
    out = tf32_rna(torch.from_numpy(v)).numpy().astype(np.float64)
    np.testing.assert_array_equal(out, expect)
    assert out[-3] == 1 + 2.0 ** -10 and out[-2] == -(1 + 2.0 ** -10)


@pytest.mark.parametrize("m,n", [(512, 256), (1024, 512), (768, 384),
                                 (2048, 128), (16384, 256)])
def test_tsmm_3xtf32_holds_the_kernel_tolerance(m, n):
    """Three tf32 products hold tsmm_tol against the reference kernel
    (interpret mode) and against the float64 Gram matrix; one product
    (hi.hi alone, plain TF32) does not."""
    x = randn(np.random.default_rng(18), (m, n))
    ref = np.asarray(ref_tsmm.tsmm_upper(jnp.asarray(x), bm=256, bn=TILE),
                     np.float64)
    g64 = x.astype(np.float64).T @ x.astype(np.float64)
    blk = np.arange(n) // TILE
    upper = blk[:, None] <= blk[None, :]
    three = tsmm_tf32_model(torch.from_numpy(x), 3).numpy()
    one = tsmm_tf32_model(torch.from_numpy(x), 1).numpy()
    for expect in (ref, g64):
        np.testing.assert_allclose(three[upper], expect[upper], **tsmm_tol(m))
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(one[upper], expect[upper],
                                       **tsmm_tol(m))


def test_tsmm_products_by_dtype():
    """fp32 takes three products; bf16 one, since a bf16 value is a tf32
    value and its lo part is zero."""
    assert PRODUCTS == {torch.float32: 3, torch.bfloat16: 1}
    x = torch.from_numpy(randn(np.random.default_rng(19), (256, 64)))
    xb = x.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(tf32_rna(xb), xb)
    assert torch.equal(tsmm_tf32_model(xb, 1), tsmm_tf32_model(xb, 3))
    assert not torch.equal(tf32_rna(x), x)


def test_tsmm_rejects_a_vector():
    with pytest.raises(ValueError):
        tsmm_upper(torch.zeros(8))


# ----------------------------------------------------------- flash attn
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, None),
    (1, 4, 4, 256, 32, False, None),
    (2, 8, 2, 512, 64, True, 128),
    (1, 2, 1, 512, 128, True, None),
    (1, 4, 1, 256, 64, False, 64),
    # gemma3-12b's head dim and GQA ratio, its global and local bands
    (1, 4, 2, 256, 256, True, None),
    (1, 4, 2, 256, 256, True, 64),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
def test_flash_attention_sweep(b, hq, hkv, s, d, causal, window):
    rng = np.random.default_rng(7)
    q, k, v = randn(rng, (b, hq, s, d)), randn(rng, (b, hkv, s, d)), \
        randn(rng, (b, hkv, s, d))
    expect = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=128, bk=128))
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(to_np(out), expect, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16():
    rng = np.random.default_rng(12)
    q, k, v = (randn(rng, (1, 2, 256, 64)) for _ in range(3))
    expect = np.asarray(ref_ops.flash_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), bq=128, bk=128),
        np.float32)
    out = ops.flash_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), expect, rtol=3e-2, atol=3e-2)


def test_flash_attention_scale_argument():
    rng = np.random.default_rng(13)
    q, k, v = (randn(rng, (1, 2, 128, 32)) for _ in range(3))
    expect = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
        bq=64, bk=64))
    out = ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              scale=0.3)
    np.testing.assert_allclose(to_np(out), expect, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,window", [(600, None), (333, 100), (77, 5)])
def test_flash_attention_ragged_length(s, window):
    """Lengths the reference kernel refuses (S % block != 0): the plain
    version is the port's own attention_dense, at any S."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(randn(rng, (2, 4, s, 32))) for _ in range(3))
    out = flash_attention(q, k[:, :2], v[:, :2], causal=True, window=window)
    expect = attention_dense(q, k[:, :2], v[:, :2], causal=True,
                             window=window)
    assert out.shape == (2, 4, s, 32)
    assert torch.equal(out, expect)
    assert torch.equal(out, flash_attention_plain(q, k[:, :2], v[:, :2],
                                                  causal=True, window=window))


@pytest.mark.parametrize("d,causal,window", [(64, True, 64), (64, False, 32),
                                               (80, True, 64), (256, True, 64)])
def test_flash_attention_more_queries_than_keys_with_a_window(d, causal,
                                                              window):
    """Query rows at or past Skv + window see no key and come out zero, as
    the reference's do."""
    rng = np.random.default_rng(15)
    q = randn(rng, (1, 2, 512, d))
    k, v = randn(rng, (1, 2, 64, d)), randn(rng, (1, 2, 64, d))
    expect = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=128, bk=64))
    out = ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(to_np(out), expect, rtol=2e-5, atol=2e-5)
    assert not to_np(out)[:, :, 64 + window:].any()


# The body a CUDA call takes goes by type alone, at every head dim; window
# and GQA do not change it.
@pytest.mark.parametrize("dtype,d,body", [
    (torch.float32, 32, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 80, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 160, "fma"), (torch.float32, 256, "fma"),
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 160, "wgmma"), (torch.bfloat16, 256, "wgmma")])
def test_flash_body_goes_by_type_and_head_dim(dtype, d, body):
    assert flash_body(dtype, d) == body


def _strided(shape, strides, dtype, offset=0):
    storage = torch.zeros(offset + 1 + sum((n - 1) * st for n, st in
                                           zip(shape, strides)), dtype=dtype)
    return torch.as_strided(storage, shape, strides, offset)


# (shape, strides in elements, offset in elements, dtype, read in place?)
# TMA and 16-byte cp.async both need a 16-byte-aligned base, unit stride
# along D and every other stride a multiple of 16 bytes.
READ_CASES = {
    "contiguous [B,H,S,D]": ((2, 4, 8, 64), (2048, 512, 64, 1), 0,
                             torch.bfloat16, True),
    "transposed view of [B,S,H,D]": ((2, 4, 8, 64), (2048, 64, 256, 1), 0,
                                     torch.bfloat16, True),
    "zamba2's D = 80 view": ((2, 32, 8, 80), (20480, 80, 2560, 1), 0,
                             torch.bfloat16, True),
    "fp32 view": ((2, 4, 8, 64), (2048, 64, 256, 1), 0, torch.float32, True),
    "base 8 bytes off": ((1, 2, 8, 64), (1152, 72, 144, 1), 4,
                         torch.bfloat16, False),
    "row stride of 100 elements": ((1, 2, 8, 64), (1600, 800, 100, 1), 0,
                                   torch.bfloat16, False),
    "row stride of 6 fp32": ((1, 2, 8, 4), (96, 48, 6, 1), 0,
                             torch.float32, False),
    "D not unit-strided": ((1, 2, 8, 64), (1024, 512, 1, 8), 0,
                           torch.bfloat16, False),
}


@pytest.mark.parametrize("case", list(READ_CASES))
def test_flash_reads_in_place_follows_the_tensor_map_rule(case):
    shape, strides, offset, dtype, expect = READ_CASES[case]
    t = _strided(shape, strides, dtype, offset)
    assert t.stride() == strides
    assert flash_reads_in_place(t) == expect
    assert flash_reads_in_place(t.contiguous())


@pytest.mark.parametrize("dtype,offset,expect", [
    (torch.bfloat16, 4096, True),     # mamba2: B after H * P = 4096 columns
    (torch.bfloat16, 4100, False),    # 8 bytes off: the bf16 body copies
    (torch.float32, 4100, True),      # the fp32 body loads element-wise
])
def test_ssd_reads_b_and_c_in_place_where_rows_are_aligned(dtype, offset,
                                                           expect):
    width = offset + 2 * 128
    proj = torch.zeros((2, 16, width), dtype=dtype)
    bm = proj[..., offset:offset + 128].reshape(2, 16, 1, 128)
    assert ssd_reads_in_place(bm) == expect


def test_ssd_scratch_at_the_serve_shapes():
    """The bf16 body's fp32 scratch: 138 MB at mamba2's prefill, 89 MB at
    zamba2's; no C B^T scratch (the chunk-output kernel forms it in shared
    memory); the cumsums' rows padded to whole 64-row tiles, the states by
    (b, head, chunk)."""
    def mb(shapes):
        return sum(4 * np.prod(v) for v in shapes.values()) / 1e6
    m = scratch_shapes(8, 2048, 64, 1, 64, 128, 256)
    assert m == {"cum": (8, 64, 8, 256), "st": (8, 64, 8, 64, 128)}
    assert round(mb(m)) == 138
    assert round(mb(scratch_shapes(8, 2048, 80, 1, 64, 64, 256))) == 89
    assert scratch_shapes(2, 600, 4, 1, 64, 128, 256) == {
        "cum": (2, 4, 3, 256), "st": (2, 4, 3, 64, 128)}
    assert scratch_shapes(1, 7, 2, 1, 16, 16, 256) == {
        "cum": (1, 2, 1, 64), "st": (1, 2, 1, 16, 16)}


# ------------------------------------------------------------- ssd scan
def ssd_inputs(rng, b, s, h, p, g, n):
    """x, dt, A_log, B, C, D drawn as tests/test_kernels.py draws them."""
    return (randn(rng, (b, s, h, p)),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            rng.uniform(-1, 1, (h,)).astype(np.float32),
            randn(rng, (b, s, g, n)), randn(rng, (b, s, g, n)),
            randn(rng, (h,)))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 4, 16, 32, 32),
    (1, 256, 2, 64, 128, 64),
    (2, 64, 8, 32, 16, 16),
])
def test_ssd_scan_sweep(b, s, h, p, n, chunk):
    args = ssd_inputs(np.random.default_rng(7), b, s, h, p, 1, n)
    ey, es = ref_ops.ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    y, st = ops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    np.testing.assert_allclose(to_np(y), np.asarray(ey), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_np(st), np.asarray(es), rtol=2e-4,
                               atol=2e-4)


def test_ssd_scan_matches_sequential_decode():
    b, s, h, p, n = 1, 32, 2, 8, 16
    x, dt, A_log, B, C, D = ssd_inputs(np.random.default_rng(15), b, s, h, p,
                                       1, n)
    y, st = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A_log, B, C,
                                                         D)), chunk=8)
    ref_st = jnp.zeros((b, h, p, n))
    my_st = torch.zeros((b, h, p, n))
    for t in range(s):
        ref_y, ref_st = ref_ssd_decode_step(
            ref_st, jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]),
            jnp.asarray(A_log), jnp.asarray(B[:, t]), jnp.asarray(C[:, t]),
            jnp.asarray(D))
        my_y, my_st = ssd_decode_step(
            my_st, *(torch.from_numpy(a) for a in (
                x[:, t], dt[:, t], A_log, B[:, t], C[:, t], D)))
        np.testing.assert_allclose(to_np(y[:, t]), np.asarray(ref_y),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(to_np(my_y), np.asarray(ref_y),
                                   rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_np(st), np.asarray(ref_st), rtol=2e-4,
                               atol=2e-4)


def test_ssd_scan_groups_read_by_index():
    """G > 1: the reference repeats B and C to heads; the port reads them by
    group index.  Same function."""
    args = ssd_inputs(np.random.default_rng(16), 2, 64, 8, 16, 2, 32)
    ey, es = ref_ops.ssd_scan(*(jnp.asarray(a) for a in args), chunk=32)
    y, st = ops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=32)
    np.testing.assert_allclose(to_np(y), np.asarray(ey), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_np(st), np.asarray(es), rtol=2e-4,
                               atol=2e-4)


def test_ssd_scan_bf16():
    """bf16 x, B, C: xbar and the D residual are formed in bf16 on both
    sides (the reference wrapper's arithmetic), the scan in fp32."""
    args = ssd_inputs(np.random.default_rng(17), 1, 128, 4, 32, 1, 32)
    cast = {0, 3, 4}                                   # x, B, C
    ey, es = ref_ops.ssd_scan(*(jnp.asarray(a, jnp.bfloat16) if i in cast
                                else jnp.asarray(a)
                                for i, a in enumerate(args)), chunk=32)
    y, st = ops.ssd_scan(*(torch.from_numpy(a).to(torch.bfloat16) if i in cast
                           else torch.from_numpy(a)
                           for i, a in enumerate(args)), chunk=32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(to_np(y), np.asarray(ey, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(to_np(st), np.asarray(es), rtol=3e-2,
                               atol=3e-2)


# ------------------------------------------------------ matmul epilogue
def _mm_inputs(seed, m, n, k, epilogue):
    rng = np.random.default_rng(seed)
    x, w = randn(rng, (m, k)), randn(rng, (k, n))
    bias = randn(rng, (n,)) if epilogue == "bias" else None
    return x, w, bias


def _th(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype)
            for a in arrays]


def _jx(*arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("epilogue", [None, "bias", "silu", "gelu"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", [
    (512, 256, 256, 256, 128, 128),
    (256, 512, 384, 128, 256, 128),     # non-square, 3 k-steps
])
def test_matmul_epilogue_sweep(epilogue, m, n, k, bm, bn, bk):
    x, w, bias = _mm_inputs(7, m, n, k, epilogue)
    expect = np.asarray(ref_ops.matmul_epilogue(
        *_jx(x, w, bias), epilogue=epilogue, bm=bm, bn=bn, bk=bk))
    out = ops.matmul_epilogue(*_th(x, w, bias), epilogue=epilogue)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    np.testing.assert_allclose(to_np(out), expect, rtol=2e-5, atol=2e-4)


def test_matmul_epilogue_layernorm_full_row():
    x, w, _ = _mm_inputs(8, 256, 256, 256, None)
    expect = np.asarray(ref_ops.matmul_epilogue(
        *_jx(x, w), epilogue="layernorm", bm=128, bn=256, bk=128))
    out = to_np(ops.matmul_epilogue(*_th(x, w), epilogue="layernorm"))
    np.testing.assert_allclose(out, expect, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(out.mean(axis=-1), 0.0, atol=1e-4)


@pytest.mark.parametrize("out_dtype,jdtype,tol", [
    (torch.bfloat16, jnp.bfloat16, 3e-2), (torch.float32, jnp.float32, 2e-4)])
def test_matmul_epilogue_cast_sinking(out_dtype, jdtype, tol):
    """out_dtype narrows during the single write (fp32 accumulate)."""
    x, w, _ = _mm_inputs(9, 256, 256, 256, None)
    expect = np.asarray(ref_ops.matmul_epilogue(
        *_jx(x, w), epilogue="silu", out_dtype=jdtype, bm=128, bn=128,
        bk=128), np.float32)
    out = ops.matmul_epilogue(*_th(x, w), epilogue="silu",
                              out_dtype=out_dtype)
    assert out.dtype == out_dtype
    np.testing.assert_allclose(to_np(out), expect, rtol=tol, atol=tol)


def test_matmul_epilogue_bf16_inputs_and_fp32_logits():
    """bf16 operands with gelu, as the reference's case; and the serving
    head's cast sinking, bf16 operands to fp32 output."""
    x, w, _ = _mm_inputs(10, 256, 256, 256, None)
    expect = np.asarray(ref_ops.matmul_epilogue(
        *_jx(x, w, dtype=jnp.bfloat16), epilogue="gelu", bm=128, bn=128,
        bk=128), np.float32)
    out = ops.matmul_epilogue(*_th(x, w, dtype=torch.bfloat16),
                              epilogue="gelu")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), expect, rtol=3e-2, atol=3e-2)
    logits = ops.matmul_epilogue(*_th(x, w, dtype=torch.bfloat16),
                                 out_dtype=torch.float32)
    expect = np.asarray(ref_ops.matmul_epilogue(
        *_jx(x, w, dtype=jnp.bfloat16), out_dtype=jnp.float32, bm=128,
        bn=128, bk=128))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(to_np(logits), expect, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("epilogue", [None, "bias", "silu", "gelu",
                                      "layernorm"])
def test_matmul_epilogue_ragged_shapes(epilogue):
    """m, n and k the reference kernel refuses (no exact tiling), against the
    reference's oracle; w read through a transposed view."""
    x, w, bias = _mm_inputs(11, 77, 131, 45, epilogue)
    expect = np.asarray(ref_oracles.matmul_epilogue_ref(
        *_jx(x, w, bias), epilogue=epilogue))
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).T     # strides (1, k)
    for w_arg in (torch.from_numpy(w), wt):
        out = matmul_epilogue(torch.from_numpy(x), w_arg,
                              *_th(bias) if bias is not None else [],
                              epilogue=epilogue)
        np.testing.assert_allclose(to_np(out), expect, rtol=2e-5, atol=2e-4)
    assert torch.equal(out, matmul_epilogue_plain(
        torch.from_numpy(x), wt, *_th(bias) if bias is not None else [],
        epilogue=epilogue))


def test_matmul_epilogue_rejects_what_the_reference_rejects():
    x, w = torch.zeros(8, 16), torch.zeros(16, 4)
    for bad in (lambda: matmul_epilogue(x, w, epilogue="relu"),
                lambda: matmul_epilogue(x, w, torch.zeros(4)),
                lambda: matmul_epilogue(x, w, epilogue="bias"),
                lambda: matmul_epilogue(x, w.T, epilogue=None)):
        with pytest.raises(ValueError):
            bad()


def test_cpu_tensors_launch_nothing():
    """Nor does their backward: the backward kernels' counts stay 0 too."""
    ops.reset_launch_counts()
    x = torch.ones(64, 32)
    ops.tsmm(x)
    qkv = [torch.ones(1, 1, 8, 64, requires_grad=True) for _ in range(3)]
    ops.flash_attention(*qkv).sum().backward()
    y, _ = ops.ssd_scan(torch.ones(1, 8, 2, 16, requires_grad=True),
                        torch.ones(1, 8, 2), torch.zeros(2),
                        torch.ones(1, 8, 1, 16), torch.ones(1, 8, 1, 16),
                        torch.ones(2), chunk=4)
    y.sum().backward()
    ops.matmul_epilogue(torch.ones(4, 8, requires_grad=True), torch.ones(8, 3),
                        epilogue="silu").sum().backward()
    y, _ = ops.causal_conv(torch.ones(1, 8, 16, requires_grad=True),
                           torch.ones(4, 16), torch.zeros(16))
    y.sum().backward()
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0, "tsmm_upper": 0,
                                   "ssd_scan": 0, "ssd_scan_bwd": 0,
                                   "matmul_epilogue": 0, "causal_conv": 0,
                                   "causal_conv_bwd": 0}


# ------------------------------------------------- matmul_epilogue bodies
BF16, F32 = torch.bfloat16, torch.float32

# The body a CUDA call takes: (m, k, n, type, out type, epilogue, w given as
# the transposed view of an [n, k] tensor, body).  Meta tensors: shapes and
# strides without storage, at a 16-byte-aligned base.
BODY_CASES = {
    "zamba2 prefill gate": (16384, 2560, 10240, BF16, BF16, "silu", False,
                            "wgmma"),
    "qwen prefill gate": (16384, 1024, 2816, BF16, BF16, "silu", False,
                          "wgmma"),
    "zamba2 decode gate": (8, 2560, 10240, BF16, BF16, "silu", False,
                           "small_m"),
    "qwen decode gate": (8, 1024, 2816, BF16, BF16, "silu", False,
                         "small_m"),
    "zamba2 head": (8, 2560, 32000, BF16, F32, None, False, "small_m"),
    "mamba2 head": (8, 2048, 50280, BF16, F32, None, False, "small_m"),
    "qwen head": (8, 1024, 151936, BF16, F32, None, False, "small_m"),
    "a decode step of one request": (1, 2560, 10240, BF16, BF16, "silu",
                                     False, "small_m"),
    "64 rows": (64, 1024, 2816, BF16, BF16, "silu", False, "small_m"),
    "65 rows": (65, 1024, 2816, BF16, BF16, "silu", False, "wgmma"),
    "fp32 out, 129 rows": (129, 1024, 2816, BF16, F32, "gelu", False,
                           "wgmma"),
    "fp32 prefill gate": (16384, 1024, 2816, F32, F32, "silu", False, "fma"),
    "fp32 head": (8, 1024, 151936, F32, F32, None, False, "fma"),
    "layernorm, bf16": (256, 256, 256, BF16, BF16, "layernorm", False,
                        "layernorm"),
    "layernorm, fp32, 8 rows": (8, 256, 256, F32, F32, "layernorm", False,
                                "layernorm"),
    "aligned transposed w (K-major)": (1024, 2048, 4096, BF16, BF16, "silu",
                                       True, "wgmma"),
    "ragged, transposed w": (77, 45, 131, BF16, BF16, "bias", True,
                             "mma_sync"),
    "ragged, odd n": (1000, 520, 1001, BF16, BF16, "silu", False,
                      "mma_sync"),
    "transposed w, output rows off 16 bytes": (256, 1024, 1001, BF16, F32,
                                               None, True, "mma_sync"),
}


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_matmul_body_goes_by_type_rows_epilogue_and_layout(case):
    m, k, n, dtype, out_dtype, epilogue, transposed, body = BODY_CASES[case]
    x = torch.empty((m, k), dtype=dtype, device="meta")
    w = (torch.empty((n, k), dtype=dtype, device="meta").T if transposed
         else torch.empty((k, n), dtype=dtype, device="meta"))
    assert matmul_body(x, w, out_dtype, epilogue) == body


# (shape, strides in elements, offset in elements, dtype, the unit-stride
# axis asked for, describable?)  A TMA tensor map needs a 16-byte-aligned
# base, unit stride along the inner axis, and the other stride a multiple
# of 16 bytes no shorter than a row.
TMA_CASES = {
    "contiguous x": ((64, 128), (128, 1), 0, BF16, 1, True),
    "a layer of a stacked weight": ((64, 128), (128, 1), 3 * 64 * 128, BF16,
                                    1, True),
    "transposed view of [n, k] (K-major w)": ((128, 64), (1, 128), 0, BF16,
                                              0, True),
    "the same view asked row-major": ((128, 64), (1, 128), 0, BF16, 1,
                                      False),
    "columns of a wider tensor": ((64, 64), (256, 1), 0, BF16, 1, True),
    "base 8 bytes off": ((64, 64), (64, 1), 4, BF16, 1, False),
    "rows of 90 bytes": ((77, 45), (45, 1), 0, BF16, 1, False),
    "rows overlapping": ((64, 64), (32, 1), 0, BF16, 1, False),
    "fp32 rows of 16 bytes": ((8, 4), (4, 1), 0, F32, 1, True),
    "fp32 rows of 24 bytes": ((8, 6), (6, 1), 0, F32, 1, False),
}


@pytest.mark.parametrize("case", list(TMA_CASES))
def test_matmul_tma_rule(case):
    shape, strides, offset, dtype, axis, expect = TMA_CASES[case]
    t = _strided(shape, strides, dtype, offset)
    assert t.stride() == strides
    assert tma_describable(t, axis) == expect


def test_cpu_matmul_calls_leave_body_counts_at_zero():
    ops.reset_launch_counts()
    x, w = torch.ones(65, 32, dtype=BF16), torch.ones(32, 16, dtype=BF16)
    for m in (8, 65):
        ops.matmul_epilogue(x[:m], w, epilogue="silu")
    ops.matmul_epilogue(torch.ones(8, 32), torch.ones(32, 16))
    assert ops.launch_counts()["matmul_epilogue"] == 0
    assert set(ops.matmul_body_launches().values()) == {0}
