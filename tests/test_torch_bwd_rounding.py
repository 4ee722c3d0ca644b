"""The rounding plans of the two backward kernels' bf16 bodies, on the CPU.

``flash_attention_bwd_tc_plain`` is the flash backward's ``wgmma`` body in
plain PyTorch (P and dS rounded once to bf16 for the products that take
them); ``ssd_scan_bwd_split_plain`` is the SSD backward's tensor-core body
(each fp32 operand of a product split into a bf16 hi and lo part, on chunks
of at most 256 rows).  Each is held against the port's fp32 plain backward
on the same bf16 inputs with the tolerance ``chip_smoke.py`` holds the
kernels to on the card (``BWD_RTOL`` per output, relative to the output's
largest magnitude), so that a rounding plan that cannot pass shows before
the CUDA body runs.  The SSD plan's control, each fp32 operand rounded once
to bf16, must fail dlog_a's fp32 tolerance at the reference's kernel case.
The plain backwards themselves are held against the reference in
``tests/test_torch_train.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    FMA_BLOCK_KEYS, FMA_DQ_SCRATCH_BYTES, _scores, bwd_block_keys,
    dq_fixed_order_plain, flash_attention_bwd_fma_plain,
    flash_attention_bwd_plain, flash_attention_bwd_tc_plain,
    flash_attention_plain, flash_bwd_body, flash_lse_plain, fma_dq_run)
from repro_torch.kernels.ssd_scan import (TC_BWD_CHUNK, ssd_bwd_body,
                                          ssd_fwd_body, ssd_scan_bwd_plain,
                                          ssd_scan_bwd_split_plain,
                                          tile_heads)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (BWD_RTOL, compare_rel,  # noqa: E402
                        unexchanged_dq_fault)

BF16 = torch.bfloat16


def bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(BF16)


# (b, hq, hkv, sq, skv, d, causal, window): chip_smoke.py's check_flash_bwd
# cases, cut in length
FLASH_CASES = {
    "GQA": (2, 4, 2, 128, 128, 64, True, None),
    "ragged S, window, D = 80": (1, 4, 4, 150, 150, 80, True, 40),
    "not causal, D = 80": (1, 2, 2, 70, 70, 80, False, None),
    "GQA 4, window, not causal": (1, 4, 1, 100, 100, 64, False, 32),
    "Sq < Skv, causal": (2, 4, 2, 50, 120, 64, True, None),
    "Sq > Skv, causal, window": (1, 2, 2, 100, 40, 80, True, 16),
    "D = 128, GQA 8": (1, 8, 1, 200, 200, 128, True, None),
    "D = 128, not causal": (1, 4, 4, 90, 90, 128, False, None),
    "D = 160, GQA 4, window": (1, 8, 2, 150, 150, 160, True, 48),
    "D = 160, ragged, Sq < Skv": (1, 4, 1, 70, 130, 160, True, None),
    "D = 256, GQA 2": (1, 4, 2, 150, 150, 256, True, None),
    "D = 256, window, not causal": (1, 4, 2, 100, 100, 256, False, 32),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_tc_plan_within_the_kernel_tolerance(case):
    b, hq, hkv, sq, skv, d, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(11)
    q, k, v = bf16(rng, b, hq, sq, d), bf16(rng, b, hkv, skv, d), \
        bf16(rng, b, hkv, skv, d)
    kw = dict(causal=causal, window=window)
    o = flash_attention_plain(q, k, v, **kw)
    lse = flash_lse_plain(q, k, **kw)
    do = bf16(rng, b, hq, sq, d)
    got = flash_attention_bwd_tc_plain(q, k, v, o, lse, do, **kw)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for a, r in zip(got, ref):
        assert a.dtype == BF16 and a.shape == r.shape
        compare_rel(a, r, BWD_RTOL[BF16])
    # the plan does round: P and dS in bf16 move dV and dK off the fp32 sums
    assert any(not torch.equal(a, r) for a, r in zip(got, ref))


def ssd_inputs(seed, b, s, h, p, g, n, init=False, serve=False):
    """bf16 xbar, B, C and dy, fp32 log_a, d final_state and init_state,
    dt and A_log drawn as the reference's kernel tests draw them or, with
    ``serve``, as the serve path makes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    if serve:
        dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
        a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    else:
        dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
        a_log = rng.uniform(-1, 1, (h,)).astype(np.float32)
    log_a = torch.from_numpy(dt * -np.exp(a_log))
    xbar = torch.from_numpy(x * dt[..., None]).to(BF16)
    f32 = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    bm, cm = bf16(rng, b, s, g, n), bf16(rng, b, s, g, n)
    dy, dfin = bf16(rng, b, s, h, p), f32(b, h, p, n)
    return (xbar, log_a, bm, cm, dy, dfin), (f32(b, h, p, n) if init
                                             else None)


# (b, s, h, p, g, n, chunk, init, serve): chip_smoke.py's check_ssd_bwd
# cases, the serve path's decays, and a chunk above the body's 256
SSD_CASES = {
    "reference case": (1, 256, 2, 64, 1, 128, 64, False, False),
    "sweep 1": (2, 128, 4, 16, 1, 32, 32, False, False),
    "sweep 3": (2, 64, 8, 32, 1, 16, 16, False, False),
    "ragged S": (2, 600, 4, 64, 1, 128, 256, False, False),
    "groups G = 2": (2, 256, 8, 64, 2, 128, 64, False, False),
    "initial state": (2, 300, 4, 64, 1, 128, 128, True, False),
    "serve decays, initial state": (1, 512, 8, 64, 1, 128, 256, True, True),
    "chunk 512, ragged S": (1, 600, 2, 32, 1, 64, 512, False, False),
}
SSD_OUTPUTS = ("dxbar", "dlog_a", "dB", "dC", "dinit")


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_split_plan_within_the_kernel_tolerance(case):
    b, s, h, p, g, n, chunk, init, serve = SSD_CASES[case]
    args, st0 = ssd_inputs(5, b, s, h, p, g, n, init, serve)
    got = ssd_scan_bwd_split_plain(*args, chunk=chunk, init_state=st0)
    ref = ssd_scan_bwd_plain(*args, chunk=chunk, init_state=st0)
    for name, a, r in zip(SSD_OUTPUTS, got, ref):
        if r is None:
            assert a is None, name
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        compare_rel(a, r, BWD_RTOL[a.dtype])


def test_ssd_rounded_once_control_fails_dlog_a():
    """Each fp32 operand rounded once to bf16 (no lo part): dlog_a leaves
    its fp32 tolerance at the reference's kernel case, so the check that the
    split passes has the power to fail."""
    args, _ = ssd_inputs(5, 1, 256, 2, 64, 1, 128)
    ref = ssd_scan_bwd_plain(*args, chunk=64)
    split = ssd_scan_bwd_split_plain(*args, chunk=64)
    once = ssd_scan_bwd_split_plain(*args, chunk=64, split=False)
    compare_rel(split[1], ref[1], BWD_RTOL[torch.float32])
    with pytest.raises(AssertionError):
        compare_rel(once[1], ref[1], BWD_RTOL[torch.float32])
    # the bf16 outputs' tolerance does not tell the two apart
    for a, r in zip(once[:4:2], ref[:4:2]):
        compare_rel(a, r, BWD_RTOL[BF16])


@pytest.mark.parametrize("dtype,d,body", [
    (BF16, 64, "wgmma"), (BF16, 80, "wgmma"),
    (torch.float32, 64, "fma"), (torch.float32, 80, "fma"),
    (BF16, 128, "wgmma"), (BF16, 160, "wgmma"),
    (torch.float32, 128, "fma"), (torch.float32, 160, "fma"),
    (BF16, 256, "wgmma"), (torch.float32, 256, "fma")])
def test_flash_bwd_body(dtype, d, body):
    assert flash_bwd_body(dtype, d) == body


@pytest.mark.parametrize("d", [32, 96])
def test_flash_bwd_body_refuses_other_head_dims(d):
    with pytest.raises(ValueError):
        flash_bwd_body(BF16, d)


@pytest.mark.parametrize("dtype,body", [(BF16, "wgmma"),
                                        (torch.float32, "fma")])
def test_ssd_bwd_body(dtype, body):
    assert ssd_bwd_body(dtype) == body
    assert TC_BWD_CHUNK == 256


@pytest.mark.parametrize("dtype,body", [(BF16, "wgmma"),
                                        (torch.float32, "fma")])
def test_ssd_fwd_body(dtype, body):
    assert ssd_fwd_body(dtype) == body


@pytest.mark.parametrize("b,nc,h,sms,hs", [
    (8, 8, 64, 132, 22),    # mamba2's train step: 256 tiles, 3 slices
    (8, 8, 80, 132, 27),    # zamba2's: 3 slices of 27, 27 and 26 heads
    (1, 1, 2, 132, 1),      # few tiles: a slice a head
    (64, 8, 64, 132, 64),   # tiles enough alone: one slice
])
def test_ssd_tile_heads(b, nc, h, sms, hs):
    """The tile kernel's slices of a group's heads make about four blocks an
    SM: it runs one block an SM."""
    lt = 256
    assert tile_heads(b, nc, 1, lt, h, sms) == hs
    tiles, slices = b * nc * lt // 64, -(-h // hs)
    assert slices == 1 or tiles * (slices - 1) < 4 * sms <= tiles * slices \
        or hs == 1


@pytest.mark.parametrize("d", [64, 80, 128, 160, 256])
def test_fixed_order_dq_repeats_and_matches_fp32(d):
    """The bf16 bodies' dQ plan: each key tile's dQ apart, added into a zero
    fp32 accumulator in a fixed order, the last key tile first.  Two runs
    give the same bits, the sum stays within the kernel tolerance of the
    fp32 plain backward's one product, and it is the tile-by-tile sum the
    docstring names (128 keys a tile up to D = 128, 64 beyond)."""
    rng = np.random.default_rng(d)
    b, hq, hkv, sq, skv = 1, 4, 2, 200, 330
    q, k, v = bf16(rng, b, hq, sq, d), bf16(rng, b, hkv, skv, d), \
        bf16(rng, b, hkv, skv, d)
    do = bf16(rng, b, hq, sq, d)
    o = flash_attention_plain(q, k, v, causal=False)
    lse = flash_lse_plain(q, k, causal=False)
    runs = [flash_attention_bwd_tc_plain(q, k, v, o, lse, do, causal=False)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    compare_rel(runs[0][0], ref[0], BWD_RTOL[BF16])
    s, mask, scale = _scores(q, k, False, None, None)
    ds = torch.where(mask, s, 0.0)
    tiles = bwd_block_keys(d)
    assert tiles == (128 if d <= 128 else 64)
    want = torch.zeros(ds.shape[:-1] + (d,))
    for lo in sorted(range(0, skv, tiles), reverse=True):
        want = want + torch.einsum(
            "bhgqk,bhkd->bhgqd", ds[..., lo:lo + tiles],
            k[:, :, lo:lo + tiles].float()) * scale
    assert torch.equal(dq_fixed_order_plain(ds, k, scale, tiles), want)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_fp32_fixed_order_dq_repeats_and_matches_fp32(case):
    """The fp32 FMA body's dQ plan: every product in fp32, each 64-key
    tile's dQ apart, summed in the bf16 bodies' order, the last tile first.
    Two runs give the same bits; each output stays within the fp32 kernel
    tolerance of the plain backward's single products, dK and dV equal to
    them; and dQ is the tile-by-tile sum of ``dq_fixed_order_plain``."""
    b, hq, hkv, sq, skv, d, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(23)
    f32 = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    q, k, v = f32(b, hq, sq, d), f32(b, hkv, skv, d), f32(b, hkv, skv, d)
    kw = dict(causal=causal, window=window)
    o = flash_attention_plain(q, k, v, **kw)
    lse = flash_lse_plain(q, k, **kw)
    do = f32(b, hq, sq, d)
    runs = [flash_attention_bwd_fma_plain(q, k, v, o, lse, do, **kw)
            for _ in range(2)]
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for a, r in zip(runs[0], ref):
        assert a.dtype == torch.float32 and a.shape == r.shape
        compare_rel(a, r, BWD_RTOL[torch.float32])
    assert all(torch.equal(a, r) for a, r in zip(runs[0][1:], ref[1:]))
    assert FMA_BLOCK_KEYS == 64
    s, mask, scale = _scores(q, k, causal, window, None)
    p = torch.where(mask, torch.exp(s - lse.reshape(s.shape[:-1] + (1,))),
                    0.0)
    dog = do.reshape(b, hkv, hq // hkv, sq, d)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v)
    ds = p * (dp - (dog * o.reshape(dog.shape)).sum(-1, keepdim=True))
    want = dq_fixed_order_plain(ds, k, scale, 64).reshape(b, hq, sq, d)
    assert torch.equal(runs[0][0], want)


@pytest.mark.parametrize("b, hq, sq, skv, d, want", [
    (2, 64, 1024, 1024, 128, 16),      # qwen1.5-110b's parity cut: one run
    (2, 32, 2048, 2048, 128, 32),      # pixtral-12b's parity cut: one run
    (8, 16, 2048, 2048, 64, 32),       # the kernels phase's fp32 shape
    (8, 32, 8192, 8192, 128, 2),       # 1.07 GB a slice: runs of 2 tiles
    (8, 64, 16384, 16384, 128, 1),     # a slice above the bound: one tile
    (1, 1, 5, 130, 64, 3),             # ragged Skv: all 3 tiles
])
def test_fma_dq_scratch_is_bounded(b, hq, sq, skv, d, want):
    """The fp32 backward body's dQ scratch (:func:`fma_dq_run` slices of
    ``[B,Hq,Sq,D]`` fp32) stays within 2 GiB or one slice, so it grows
    linearly with Sq, and takes all the key tiles in one run where they
    fit."""
    slice_bytes = b * hq * sq * d * 4
    run = fma_dq_run(b, hq, sq, skv, d)
    assert run == want
    assert 1 <= run <= -(-skv // FMA_BLOCK_KEYS)
    assert run * slice_bytes <= max(FMA_DQ_SCRATCH_BYTES, slice_bytes)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, 32)])
def test_d256_plans_match_autograd_of_the_plain_forward(causal, window):
    """gemma3-12b's head dim, GQA 2: the bf16 body's plan
    (``flash_attention_bwd_tc_plain``, 64 keys a tile) and the fp32 body's
    order (``flash_attention_bwd_fma_plain``) against ``torch.autograd`` of
    the plain forward in fp32 on the same values, each within the kernel
    tolerance of its type (``BWD_RTOL``)."""
    rng = np.random.default_rng(256)
    b, hq, hkv, s, d = 1, 4, 2, 160, 256
    q, k, v, do = (bf16(rng, b, h, s, d) for h in (hq, hkv, hkv, hq))
    kw = dict(causal=causal, window=window)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o32 = flash_attention_plain(*leaves, **kw)
    want = torch.autograd.grad(o32, leaves, do.float())
    assert bwd_block_keys(d) == 64
    for dtype, plan in ((BF16, flash_attention_bwd_tc_plain),
                        (torch.float32, flash_attention_bwd_fma_plain)):
        qq, kk, vv, dd = (t.to(dtype) for t in (q, k, v, do))
        o = flash_attention_plain(qq, kk, vv, **kw)
        lse = flash_lse_plain(qq, kk, **kw)
        got = plan(qq, kk, vv, o, lse, dd, **kw)
        for a, r in zip(got, want):
            assert a.dtype == dtype and a.shape == r.shape
            compare_rel(a, r, BWD_RTOL[dtype])


# (d, b, hq, hkv, sq, skv, causal, window): the split-D heads with Skv of
# 200 and 330 (no multiple of 128), GQA, a window and Sq != Skv both ways
SPLIT_D_CASES = [
    (128, 1, 8, 1, 200, 200, True, None),
    (128, 1, 4, 2, 150, 330, True, 48),
    (128, 1, 4, 1, 330, 200, False, 64),
    (160, 1, 4, 1, 200, 200, False, 64),
    (160, 1, 8, 2, 150, 330, True, None),
    (160, 1, 4, 2, 330, 200, True, 100),
]


@pytest.mark.parametrize("d,b,hq,hkv,sq,skv,causal,window", SPLIT_D_CASES)
def test_split_d_plans_match_autograd_of_the_plain_forward(
        d, b, hq, hkv, sq, skv, causal, window):
    """D = 128 and 160: the bf16 body's plan (``flash_attention_bwd_tc_plain``,
    128 keys a tile at D = 128, 64 at 160) against ``torch.autograd`` of the
    plain forward in fp32 on the same values within ``BWD_RTOL``, and its dQ
    order (``dq_fixed_order_plain`` at ``bwd_block_keys``) the tile-by-tile
    sum, the last tile first."""
    rng = np.random.default_rng(d + skv)
    q, do = bf16(rng, b, hq, sq, d), bf16(rng, b, hq, sq, d)
    k, v = bf16(rng, b, hkv, skv, d), bf16(rng, b, hkv, skv, d)
    kw = dict(causal=causal, window=window)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, **kw), leaves,
                               do.float())
    o = flash_attention_plain(q, k, v, **kw)
    lse = flash_lse_plain(q, k, **kw)
    got = flash_attention_bwd_tc_plain(q, k, v, o, lse, do, **kw)
    for a, r in zip(got, want):
        assert a.dtype == BF16 and a.shape == r.shape
        compare_rel(a, r, BWD_RTOL[BF16])
    tiles = bwd_block_keys(d)
    assert tiles == (128 if d == 128 else 64)
    s, mask, scale = _scores(q, k, causal, window, None)
    ds = torch.where(mask, s, 0.0)
    want_dq = torch.zeros(ds.shape[:-1] + (d,))
    for lo in sorted(range(0, skv, tiles), reverse=True):
        want_dq = want_dq + torch.einsum(
            "bhgqk,bhkd->bhgqd", ds[..., lo:lo + tiles],
            k[:, :, lo:lo + tiles].float()) * scale
    assert torch.equal(dq_fixed_order_plain(ds, k, scale, tiles), want_dq)


@pytest.mark.parametrize("d,b,hq,hkv,sq,skv,causal,window",
                         [c for c in SPLIT_D_CASES if c[0] == 128])
def test_unexchanged_dq_control_fails(d, b, hq, hkv, sq, skv, causal,
                                      window):
    """The control ``chip_smoke.py`` holds beside the D = 128 body: dQ with
    the hand-over of dS^T between the two warpgroups left out (each 64
    columns summed over its own 64-key half of every block) leaves dQ's
    bf16 tolerance, so the check that the body passes has the power to
    fail."""
    rng = np.random.default_rng(d + skv)
    q, do = bf16(rng, b, hq, sq, d), bf16(rng, b, hq, sq, d)
    k, v = bf16(rng, b, hkv, skv, d), bf16(rng, b, hkv, skv, d)
    kw = dict(causal=causal, window=window)
    o = flash_attention_plain(q, k, v, **kw)
    lse = flash_lse_plain(q, k, **kw)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    compare_rel(flash_attention_bwd_tc_plain(q, k, v, o, lse, do, **kw)[0],
                ref[0], BWD_RTOL[BF16])
    with pytest.raises(AssertionError):
        compare_rel(unexchanged_dq_fault(q, k, v, o, lse, do, **kw),
                    ref[0].float(), BWD_RTOL[BF16])
