"""Flash attention: the hand-written Hopper kernels (forward and backward),
their wrappers, the autograd Function that joins them, and their plain
PyTorch versions.

Replaces the TPU kernel ``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py``: blockwise online-softmax attention
with GQA by index, causal and sliding-window bands, fp32 running state.  The
CUDA source is ``csrc/flash_attention.cu``; its header says how the design
differs from the TPU kernel (KV loop inside the block over the band's tiles,
longest query tiles first, ragged edges masked in the kernel).  Two bodies,
chosen by :func:`flash_body`: ``wgmma`` + TMA for bf16 at every head dim,
full-fp32 FMA for fp32.

On this card causal attention is bound by operations, not bytes: at
``B=8, H=16, S=2048, D=64`` it is about 69 GFLOP against 134 MB moved.

The backward (``csrc/flash_attention_bwd.cu``) has no TPU kernel of its
own: the reference differentiates its plain attention.  It recomputes P from
the row log-sum-exp that the forward leaves behind and forms dQ, dK and dV
(D = 64, 80, 128, 160 and 256) with dK and dV
summed over each GQA group.  Two bodies, chosen by :func:`flash_bwd_body`:
``wgmma`` + TMA for bf16, with P and dS rounded once to bf16 for the
products that take them (:func:`flash_attention_bwd_tc_plain` is the same
rounding in plain PyTorch) and dQ summed over the key tiles in a fixed order
(:func:`dq_fixed_order_plain` is that order in plain PyTorch; a tile is
:func:`bwd_block_keys` keys: 128 up to D = 128, 64 beyond), and
full-fp32 FMA for fp32, which sums dQ over 64-key tiles in the same order
(:func:`flash_attention_bwd_fma_plain`): either body repeats bit for bit.
:class:`FlashAttentionFn` runs the forward kernel and saves q, k, v, o and
the log-sum-exp; its backward runs the backward kernel.  On CPU tensors the
same Function runs :func:`flash_attention_plain`, :func:`flash_lse_plain`
and :func:`flash_attention_bwd_plain`.

The wrappers decide by the tensor's device and by nothing else: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.models.layers import NEG_INF, _band_mask, attention_dense

SUPPORTED_HEAD_DIMS = (32, 64, 80, 128, 160, 256)
# head dims the backward takes (a forward that saves the lse for it refuses
# the others)
BACKWARD_HEAD_DIMS = (64, 80, 128, 160, 256)
_BODY_CODE = {"fma": 0, "wgmma": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Direct softmax attention with the kernel's arithmetic: fp32 scores,
    ``-1e30`` masking, ``p = exp(s - m) * mask``, ``l`` clamped at 1e-30."""
    return attention_dense(q, k, v, causal=causal, window=window, scale=scale)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], scale: Optional[float]):
    """fp32 scaled scores ``[B,Hkv,G,Sq,Skv]`` of q against k, the band mask
    and the scale used."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, hq // hkv, sq, d).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) * scale
    mask = _band_mask(torch.arange(sq, device=q.device),
                      torch.arange(skv, device=q.device), causal, window)
    return s, mask, scale


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The row log-sum-exp ``[B,Hq,Sq]`` fp32 of the scaled scores on the
    band, as the forward kernel writes it: ``NEG_INF`` for a row that sees
    no key."""
    b, hq, sq, _ = q.shape
    s, mask, _ = _scores(q, k, causal, window, scale)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    l = (torch.exp(s - m) * mask).sum(dim=-1)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l),
                      torch.full_like(l, NEG_INF))
    return lse.reshape(b, hq, sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None):
    """The backward kernel's formulas in plain PyTorch, in fp32: P =
    exp(S - lse) on the band, dV = P^T dO, dP = dO V^T, dS = P o (dP -
    rowsum(dO o O)), dQ = dS K * scale, dK = dS^T Q * scale, dK and dV
    summed over each GQA group.  Returns (dq, dk, dv) in the types of q, k,
    v."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    s, mask, scale = _scores(q, k, causal, window, scale)
    f32 = lambda t: t.to(torch.float32).reshape(b, hkv, g, sq, -1)
    p = torch.where(mask, torch.exp(s - f32(lse)), 0.0)
    dog = f32(do)
    delta = (dog * f32(o)).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.to(torch.float32))
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, f32(q)) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


# keys a block of the fp32 backward body takes: its dQ partials come in
# tiles of this many keys
FMA_BLOCK_KEYS = 64
# the most bytes of dQ partials the fp32 backward body holds at once (or one
# [B,Hq,Sq,D] fp32 slice, where that is larger): the key tiles run in runs
# that fit
FMA_DQ_SCRATCH_BYTES = 2 ** 31


def fma_dq_run(b: int, hq: int, sq: int, skv: int, d: int) -> int:
    """Key tiles in one run of the fp32 backward body: as many as fit in
    :data:`FMA_DQ_SCRATCH_BYTES` of fp32 dQ partials, at least 1, at most
    all of them.  Its scratch, one ``[B,Hq,Sq,D]`` fp32 slice a tile of the
    run, thus grows at most linearly with Sq.  The run changes no bit of
    dQ: the sum is in key-tile order across runs."""
    n_tiles = -(-skv // FMA_BLOCK_KEYS)
    return max(1, min(n_tiles, FMA_DQ_SCRATCH_BYTES // (b * hq * sq * d * 4)))


def bwd_block_keys(d: int) -> int:
    """Keys a block of the bf16 backward body takes at head dim ``d``: 128
    at D = 64, 80 and 128 (each of the block's two warpgroups takes 64 of
    them; at D = 128 each then forms its half of dQ's columns over all 128),
    64 at D = 160 and 256 (the warpgroups split the tile's query columns for
    the scores and D for the gradients)."""
    return 128 if d <= 128 else 64


def dq_fixed_order_plain(ds: torch.Tensor, k: torch.Tensor, scale: float,
                         block_keys: int) -> torch.Tensor:
    """dQ = dS K * scale in fp32, summed over the key tiles of
    ``block_keys`` keys in the bf16 backward body's fixed order: each
    tile's dQ apart, then added into a zero accumulator, the last tile
    first.  ds ``[B,Hkv,G,Sq,Skv]``, k ``[B,Hkv,Skv,D]``; returns
    ``[B,Hkv,G,Sq,D]`` fp32."""
    skv = k.shape[2]
    acc = torch.zeros(ds.shape[:-1] + (k.shape[-1],), dtype=torch.float32,
                      device=ds.device)
    for lo in reversed(range(0, skv, block_keys)):
        hi = min(lo + block_keys, skv)
        acc = acc + torch.einsum("bhgqk,bhkd->bhgqd", ds[..., lo:hi],
                                 k[:, :, lo:hi].to(torch.float32)) * scale
    return acc


def flash_attention_bwd_fma_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None):
    """The fp32 FMA body's order in plain PyTorch: every product in fp32 as
    :func:`flash_attention_bwd_plain`, and dQ summed over tiles of
    ``FMA_BLOCK_KEYS`` keys in the fixed order of
    :func:`dq_fixed_order_plain`, each tile's dQ apart, the last tile first.
    Returns (dq, dk, dv) in the types of q, k, v.  Only the tests use it."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    s, mask, scale = _scores(q, k, causal, window, scale)
    f32 = lambda t: t.to(torch.float32).reshape(b, hkv, g, sq, -1)
    p = torch.where(mask, torch.exp(s - f32(lse)), 0.0)
    dog = f32(do)
    delta = (dog * f32(o)).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.to(torch.float32))
    ds = p * (dp - delta)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dq = dq_fixed_order_plain(ds, k, scale, FMA_BLOCK_KEYS)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, f32(q)) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_tc_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None):
    """The ``wgmma`` body's decomposition in plain PyTorch, in its order and
    with its roundings: S and dP in fp32 from the inputs, P = exp(S - lse)
    on the band and dS = P o (dP - delta) in fp32, then P and dS rounded
    once to bf16 for the products dV = P^T dO, dK = dS^T Q * scale and dQ =
    dS K * scale, which sum in fp32, dQ over the key tiles in the body's
    fixed order (:func:`dq_fixed_order_plain`).  Returns (dq, dk, dv) in the
    types of q, k, v.  Only the tests and the checks of ``chip_smoke.py``
    use it."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    s, mask, scale = _scores(q, k, causal, window, scale)
    f32 = lambda t: t.to(torch.float32).reshape(b, hkv, g, sq, -1)
    p = torch.where(mask, torch.exp(s - f32(lse)), 0.0)
    dog = f32(do)
    delta = (dog * f32(o)).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.to(torch.float32))
    ds = _bf16_round(p * (dp - delta))
    p = _bf16_round(p)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dq = dq_fixed_order_plain(ds, k, scale, bwd_block_keys(d))
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, f32(q)) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _entry():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if not fn.argtypes:
        ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = ([vp] * 4 + [ci] * 6 + [ll] * 12
                       + [ctypes.c_float, ci, ci, ci, vp, vp, vp])
        fn.restype = ci
    return lib, fn


def _bwd_entry():
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if not fn.argtypes:
        ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = ([vp] * 12 + [ci] * 6 + [ll] * 15
                       + [ctypes.c_float, ci, ci, ci, ci, vp])
        fn.restype = ci
    return lib, fn


def _mask_key(causal: bool) -> str:
    """The key of a launch in the wrappers' ``mask_launches``."""
    return "causal" if causal else "not_causal"


def window_key(window: Optional[int]) -> str:
    """The key of a launch in the wrappers' ``window_launches``: ``"global"``
    without a window, else ``"w<window>"``."""
    return "global" if window is None else f"w{window}"


def _count(fn, causal: bool, window: Optional[int]) -> None:
    """One launch of ``fn``'s kernel: in all, by mask and by window."""
    fn.launches += 1
    fn.mask_launches[_mask_key(causal)] += 1
    key = window_key(window)
    fn.window_launches[key] = fn.window_launches.get(key, 0) + 1


def flash_body(dtype: torch.dtype, d: int) -> str:
    """The body a CUDA call runs, by type alone: ``"wgmma"`` (wgmma + TMA)
    for bf16, ``"fma"`` for fp32, at every head dim, window and GQA ratio."""
    return "fma" if dtype == torch.float32 else "wgmma"


def flash_bwd_body(dtype: torch.dtype, d: int) -> str:
    """The backward body a CUDA call runs, by type and head dim alone:
    ``"wgmma"`` (wgmma + TMA) for bf16, ``"fma"`` for fp32, at D = 64, 80,
    128, 160 and 256.  Other head dims have no backward and raise."""
    if d not in BACKWARD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d} not in "
                         f"{BACKWARD_HEAD_DIMS}")
    return "fma" if dtype == torch.float32 else "wgmma"


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` through its strides (else the wrapper
    makes it contiguous first): unit stride along D, a 16-byte-aligned base
    and every other stride a multiple of 16 bytes below 2^40, which is what
    a TMA tensor map and a 16-byte ``cp.async`` both need."""
    esize = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * esize % 16 == 0 and 0 <= s * esize < 2 ** 40
                    for s in t.stride()[:-1]))


def _check_fwd(q, k, v, window) -> None:
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q/k/v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in SUPPORTED_HEAD_DIMS or dv != d or k.shape[-1] != d:
        raise ValueError(f"flash_attention: head dim {d} (v: {dv}) not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if k.shape != (b, hkv, skv, d) or v.shape[:3] != (b, hkv, skv) \
            or hq % hkv != 0:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError("flash_attention: window must be >= 1")


@tracing.spanned("kernel.flash_attention")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, with_lse: bool = False):
    """One launch of the forward kernel on CUDA tensors: (o, the row
    log-sum-exp ``[B,Hq,Sq]`` fp32 with ``with_lse``, else None).  The
    arguments are :func:`flash_attention`'s; ``with_lse`` needs a head dim
    of ``BACKWARD_HEAD_DIMS``."""
    _check_fwd(q, k, v, window)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = v.shape
    body = flash_body(q.dtype, d)
    if with_lse and d not in BACKWARD_HEAD_DIMS:
        raise ValueError(f"flash_attention: the backward takes head dims "
                         f"{BACKWARD_HEAD_DIMS}, got {d}")
    q, k, v = (t if reads_in_place(t) else t.contiguous() for t in (q, k, v))
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    # the wgmma body's blocks take their work items from this counter
    next_item = (torch.zeros(1, dtype=torch.int32, device=q.device)
                 if body == "wgmma" else None)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  b, hq, hkv, sq, skv, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *o.stride()[:3], scale, int(causal),
                  int(window) if window is not None else 0,
                  _BODY_CODE[body],
                  next_item.data_ptr() if next_item is not None else None,
                  lse.data_ptr() if lse is not None else None, stream)
    _build.check(lib, code, "flash_attention launch",
                 "repro_flash_attention_error_string")
    _count(flash_attention, causal, window)
    return o, lse


@tracing.spanned("kernel.flash_attention_bwd")
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The backward kernel: (dq [B,Hq,Sq,D], dk, dv [B,Hkv,Skv,D]),
    contiguous, in the input type.  q, k, v, o and do are read through their
    strides (the ``wgmma`` body's TMA needs what :func:`reads_in_place`
    checks, the FMA body a unit stride along D; a tensor without it is made
    contiguous first); lse is the forward's ``[B,Hq,Sq]`` fp32.  CUDA tensors
    only: float32 or bfloat16, a head dim of ``BACKWARD_HEAD_DIMS``, the body
    :func:`flash_bwd_body`'s; anything else raises.  Both bodies sum dQ
    over the key tiles in a fixed order, the last tile first, so a call
    repeats bit for bit.  fp32 scratch: the bf16 body's dQ buffer
    ``[B,Hq,ceil(Sq / 64),64 D]``; the fp32 body's dQ partials, one
    ``[B,Hq,Sq,D]`` for each tile of 64 keys of a run of
    :func:`fma_dq_run` tiles, at most 2 GiB or one such slice (a run holds
    all the tiles at the parity cuts: 1.07 GB at qwen1.5-110b's, B 2 x S
    1024, 64 heads of 128; 2.1 GB at pixtral-12b's, 1024 patches + 1024
    tokens, 32 heads of 128)."""
    _check_fwd(q, k, v, window)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = v.shape
    body = flash_bwd_body(q.dtype, d)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or lse.shape != (b, hq, sq) \
            or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)} {do.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} for q "
                         f"{tuple(q.shape)} {q.dtype}")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: tensors on different devices")
    readable = reads_in_place if body == "wgmma" else (
        lambda t: t.stride(-1) == 1)
    q, k, v, o, do = (t if readable(t) else t.contiguous()
                      for t in (q, k, v, o, do))
    lse = lse.contiguous()
    scale = float(scale) if scale is not None else d ** -0.5
    dev = q.device
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    bf16 = body == "wgmma"
    # the wgmma body sums dQ in 64-row tiles, each in its register order,
    # the key tiles taking turns by a counter a tile and warpgroup; the FMA
    # body writes each key tile's partials apart, summed in order afterwards
    if bf16:
        run = 0
        dq_acc = torch.zeros((b, hq, -(-sq // 64), 64 * d),
                             dtype=torch.float32, device=dev)
        turns = torch.zeros((b, hq, -(-sq // 64), 2), dtype=torch.int32,
                            device=dev)
    else:
        run = fma_dq_run(b, hq, sq, skv, d)
        dq_acc = torch.empty((run, b, hq, sq, d), dtype=torch.float32,
                             device=dev)
        turns = None
    dq = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, hkv, skv, d), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    lib, fn = _bwd_entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq_acc.data_ptr(), dq.data_ptr(),
                  turns.data_ptr() if bf16 else None,
                  dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *o.stride()[:3], *do.stride()[:3], scale, int(causal),
                  int(window) if window is not None else 0,
                  _BODY_CODE[body], run, stream)
    _build.check(lib, code, "flash_attention_bwd launch",
                 "repro_flash_attention_bwd_error_string")
    _count(flash_attention_bwd, causal, window)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.mask_launches = {"causal": 0, "not_causal": 0}
flash_attention_bwd.window_launches = {}


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward.  CUDA tensors: the forward kernel
    (with the row log-sum-exp when a gradient is wanted), then the backward
    kernel.  CPU tensors: the plain versions of both.  The forward saves q,
    k, v, o and the log-sum-exp when ``want`` (grad mode on and an input
    that requires a gradient); nothing but q, k and v gets a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, want):
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         with_lse=want)
        else:
            o = flash_attention_plain(q, k, v, causal=causal, window=window,
                                      scale=scale)
            lse = (flash_lse_plain(q, k, causal=causal, window=window,
                                   scale=scale) if want else None)
        if want:
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.args = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if q.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,D], k/v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in ``q.dtype``,
    through :class:`FlashAttentionFn` (differentiable on both devices).

    Key ``j`` is visible to query ``i`` when ``j <= i`` (causal) and
    ``j > i - window`` (window); both count from 0, there is no ``q_offset``.

    CUDA tensors: q, k and v are read through their strides (the model hands
    over ``transpose(1, 2)`` views of ``[B,S,H,D]`` projections); a tensor
    that fails :func:`reads_in_place` is made contiguous first.  The body is
    :func:`flash_body`'s: bf16 runs the ``wgmma`` + TMA body, fp32 the FMA
    body.  The output is allocated as ``[B,Sq,Hq,D]`` and returned as its
    ``transpose(1, 2)`` view, so the caller's merge of heads is free.
    ``Sq`` and ``Skv`` are arbitrary; ``D`` must be 32, 64, 80, 128, 160 or
    256 (not 32 when a gradient is wanted) and the type float32 or bfloat16,
    anything else raises.  Counts forward launches, in all, by mask
    (``mask_launches``: causal or not) and by window (``window_launches``,
    keyed by :func:`window_key`); the backward kernel counts its own
    (:func:`flash_attention_bwd`).
    """
    # the Function's forward runs with grad mode off, so the wrapper decides
    # whether a backward can follow (and the lse is wanted)
    want = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, window, scale, want)


flash_attention.launches = 0
flash_attention.mask_launches = {"causal": 0, "not_causal": 0}
flash_attention.window_launches = {}
