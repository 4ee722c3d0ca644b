"""Mamba2 SSD chunked scan: the hand-written Hopper kernels (forward and
backward), their wrappers, the autograd Function that joins them, and their
plain PyTorch versions.

Replaces the TPU kernel ``ssd_scan_kernel`` / ``_ssd_kernel`` of
``src/repro/kernels/ssd_scan.py``: the chunked scan on pre-scaled inputs
(``xbar = x * dt``, ``log_a = dt * A``), the fp32 ``[P, N]`` state carried
across chunks and returned.  The CUDA source is ``csrc/ssd_scan.cu``; its
header says how the design differs from the TPU kernel.  Two bodies:

* bf16 (the served path): chunk-parallel on wgmma, the tiles brought in by
  TMA, three CUDA kernels a call (chunk states, state passing, chunk
  outputs, which forms C B^T itself), each fp32 operand of a product split
  into a bf16 hi and lo part.  :func:`ssd_scan_split_plain` is the same
  order of work and the same roundings in plain PyTorch; the tests hold it
  against the reference.
* fp32: one block per ``(b, h)`` looping over the chunks with the state in
  shared memory, full-fp32 FMA, no tensor cores.

Both read B and C by group index, never repeated to heads in device memory,
and mask ragged S in the kernel.  At the serve shape (B=8, S=2048, H=64,
P=64, N=128, chunk 256) the scan moves about 0.30 GB, so its roofline bound
is set by bytes.

The backward (``csrc/ssd_scan_bwd.cu``) has no TPU kernel of its own: the
reference differentiates its plain ``ssd_chunked``.  It recomputes the chunk
states, runs the state gradient through the chunks in reverse and forms
every intra-chunk term from the same decay masks, with dB and dC summed over
the heads of each group.  Two bodies, chosen by :func:`ssd_bwd_body`: bf16
on wgmma with TMA, chunk-parallel, six CUDA kernels a call, every fp32
operand of a product split hi + lo (:func:`ssd_scan_bwd_split_plain` is the
same order of work and the same roundings in plain PyTorch), on chunks of at
most :data:`TC_BWD_CHUNK` rows; fp32 FMA, four CUDA kernels a call.
:class:`SsdScanFn` runs the forward kernel and the backward kernel; on CPU
tensors it runs :func:`ssd_scan_plain` and :func:`ssd_scan_bwd_plain`.

The wrappers decide by the tensor's device and by nothing else: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.models.mamba import ssd_scan_prescaled

SUPPORTED_HEAD_DIMS = (16, 32, 64)
SUPPORTED_STATE_SIZES = (16, 32, 64, 128)
MAX_CHUNK = 1024
# rows a chunk of the backward's tensor-core body, at most: the gradient does
# not depend on the chunk, and four 64-row tiles keep a tile's work in
# shared memory
TC_BWD_CHUNK = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BWD_BODY_CODE = {"fma": 0, "wgmma": 1}


def ssd_scan_plain(xbar: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's function in plain PyTorch, in fp32, for any S (the
    last chunk's tail is padded with zero rows after pre-scaling)."""
    return ssd_scan_prescaled(xbar, log_a, B, C, chunk=chunk,
                              init_state=init_state)


def _split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``t = hi + lo`` as the bf16 body splits an fp32 operand: hi = bf16(t),
    lo = bf16(t - hi), both returned in fp32."""
    hi = t.to(torch.bfloat16).to(torch.float32)
    return hi, (t - hi).to(torch.bfloat16).to(torch.float32)


def ssd_scan_split_plain(xbar: torch.Tensor, log_a: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                         init_state: Optional[torch.Tensor] = None,
                         split_state: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 body's decomposition in plain PyTorch, in its order and with
    its roundings: chunk states ``(exp(total - cum) o Xbar)^T B`` with the
    decayed Xbar split hi + lo; the state passed over the chunks in fp32; C
    B^T once per group, then the decay mask per head, split hi + lo; chunk
    outputs ``exp(cum) o (C S_in^T) + ((C B^T) o L) Xbar`` with S_in split
    hi + lo.  Chunks of ``min(chunk, S)`` rows, the last one padded with
    zero rows.  ``split_state=False`` drops the lo part of the decayed Xbar:
    the rounding fault that the state's tolerance must catch.  Only the
    tests and the checks of ``chip_smoke.py`` use it."""
    b, s, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    ln = min(chunk, s)
    nc = -(-s // ln)
    pad = nc * ln - s

    def chunks(t, *tail):
        t = F.pad(t.to(torch.float32), (0, 0) * len(tail) + (0, pad))
        return t.reshape(b, nc, ln, *tail)
    xb, la = chunks(xbar, h, p), chunks(log_a, h)
    Bc, Cc = chunks(B, g, n), chunks(C, g, n)
    cum = torch.cumsum(la, dim=2)                              # [b,c,l,h]
    total = cum[:, :, -1]                                      # [b,c,h]

    # chunk states, the decayed Xbar split hi + lo
    Bh = Bc.repeat_interleave(rep, dim=3)                      # [b,c,l,h,n]
    parts = _split(torch.exp(total[:, :, None] - cum)[..., None] * xb)
    emit = sum(torch.einsum("bclhp,bclhn->bchpn", part, Bh)
               for part in parts[:2 if split_state else 1])

    # state passing: the state entering each chunk, and the final state
    state = (init_state.to(torch.float32) if init_state is not None
             else xbar.new_zeros((b, h, p, n), dtype=torch.float32))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + emit[:, c]
    s_in = torch.stack(s_in, dim=1)                            # [b,c,h,p,n]

    # chunk outputs: C B^T once per group, then the decay mask of each head
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    ct = cum.transpose(2, 3)                                   # [b,c,h,l]
    ii = torch.arange(ln, device=xbar.device)
    seg = (ct[..., :, None] - ct[..., None, :]).masked_fill(
        ii[:, None] < ii[None, :], float("-inf"))
    pm = cb.repeat_interleave(rep, dim=2) * torch.exp(seg)     # [b,c,h,l,l]
    y = sum(torch.einsum("bchij,bcjhp->bcihp", part, xb)
            for part in _split(pm))
    Ch = Cc.repeat_interleave(rep, dim=3)                      # [b,c,l,h,n]
    y_off = sum(torch.einsum("bclhn,bchpn->bclhp", Ch, part)
                for part in _split(s_in))
    y = y_off * torch.exp(cum)[..., None] + y
    return y.reshape(b, nc * ln, h, p)[:, :s].to(xbar.dtype), state


def ssd_scan_bwd_plain(xbar: torch.Tensor, log_a: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                       dfinal: Optional[torch.Tensor], *, chunk: int,
                       init_state: Optional[torch.Tensor] = None):
    """The backward kernel's formulas in plain PyTorch, in fp32, for any S.

    Per chunk (cum the cumsum of log_a in it, total its last value, S_in the
    state entering it, dS_out the gradient of the state leaving it, Lmask =
    exp(cum_t - cum_s) for s <= t): M = (C B^T) o Lmask, W = dY Xbar^T, Wd =
    W o Lmask; dXbar = M^T dY + exp(total - cum) (B dS_out^T); dB = Wd^T C +
    exp(total - cum) (Xbar dS_out); dC = Wd B + exp(cum) (dY S_in); dcum =
    rowsum(M o W) - colsum(M o W) + C . (exp(cum) dY S_in) - Xbar .
    (exp(total - cum) dS_out B), with dtotal = exp(total) sum(dS_out o S_in)
    + sum of the last term on the last row; dlog_a the reverse cumsum of
    dcum; dS_in = exp(total) dS_out + (exp(cum) dY)^T C through the chunks
    in reverse.  Returns (dxbar in ``xbar.dtype``, dlog_a fp32, dB and dC in
    ``B.dtype`` summed over each group's heads, d init_state fp32 or None).
    """
    b, s, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    ln = min(chunk, s)
    nc = -(-s // ln)
    pad = nc * ln - s

    def chunks(t, *tail):
        t = F.pad(t.to(torch.float32), (0, 0) * len(tail) + (0, pad))
        return t.reshape(b, nc, ln, *tail)
    xb, la, dyc = chunks(xbar, h, p), chunks(log_a, h), chunks(dy, h, p)
    Bh = chunks(B, g, n).repeat_interleave(rep, dim=3)        # [b,c,l,h,n]
    Ch = chunks(C, g, n).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(la, dim=2)                              # [b,c,l,h]
    total = cum[:, :, -1]                                      # [b,c,h]
    w_end = torch.exp(total[:, :, None] - cum)[..., None]      # [b,c,l,h,1]
    w_cum = torch.exp(cum)[..., None]

    # the state entering each chunk, and the gradient of the one leaving it
    emit = torch.einsum("bclhn,bclhp->bchpn", Bh, xb * w_end)
    demit = torch.einsum("bclhp,bclhn->bchpn", dyc * w_cum, Ch)
    state = (init_state.to(torch.float32) if init_state is not None
             else xbar.new_zeros((b, h, p, n), dtype=torch.float32))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + emit[:, c]
    ds = (dfinal.to(torch.float32) if dfinal is not None
          else torch.zeros_like(state))
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = ds
        ds = ds * torch.exp(total[:, c])[..., None, None] + demit[:, c]
    s_in, ds_out = torch.stack(s_in, dim=1), torch.stack(ds_out, dim=1)

    # intra-chunk terms
    ct = cum.transpose(2, 3)                                   # [b,c,h,l]
    ii = torch.arange(ln, device=xbar.device)
    seg = (ct[..., :, None] - ct[..., None, :]).masked_fill(
        ii[:, None] < ii[None, :], float("-inf"))
    lmask = torch.exp(seg)                                     # [b,c,h,t,s]
    m = torch.einsum("bcthn,bcshn->bchts", Ch, Bh) * lmask
    w = torch.einsum("bcthp,bcshp->bchts", dyc, xb)
    wd = w * lmask
    mw = m * w
    # state terms
    dx_off = w_end * torch.einsum("bcshn,bchpn->bcshp", Bh, ds_out)
    dc_off = w_cum * torch.einsum("bcthp,bchpn->bcthn", dyc, s_in)
    e = (xb * dx_off).sum(-1)                                  # [b,c,l,h]
    dxbar = torch.einsum("bchts,bcthp->bcshp", m, dyc) + dx_off
    dBh = torch.einsum("bchts,bcthn->bcshn", wd, Ch) \
        + w_end * torch.einsum("bcshp,bchpn->bcshn", xb, ds_out)
    dCh = torch.einsum("bchts,bcshn->bcthn", wd, Bh) + dc_off
    dcum = (mw.sum(-1) - mw.sum(-2)).transpose(2, 3) \
        + (Ch * dc_off).sum(-1) - e
    dtotal = torch.exp(total) * (ds_out * s_in).sum((-1, -2)) + e.sum(2)
    dcum[:, :, -1] += dtotal
    dla = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))

    def unchunk(t, dtype):
        return t.reshape(b, nc * ln, *t.shape[3:])[:, :s].to(dtype)
    dB = dBh.reshape(b, nc, ln, g, rep, n).sum(4)
    dC = dCh.reshape(b, nc, ln, g, rep, n).sum(4)
    return (unchunk(dxbar, xbar.dtype), unchunk(dla, torch.float32),
            unchunk(dB, B.dtype), unchunk(dC, C.dtype),
            ds if init_state is not None else None)


def ssd_scan_bwd_split_plain(xbar: torch.Tensor, log_a: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor,
                             dy: torch.Tensor, dfinal: Optional[torch.Tensor],
                             *, chunk: int,
                             init_state: Optional[torch.Tensor] = None,
                             split: bool = True):
    """The backward's tensor-core body in plain PyTorch, in its order and
    with its roundings, on its chunks of ``min(chunk, TC_BWD_CHUNK, S)``
    rows: emit and demit from the decayed Xbar and dY split hi + lo; S_in
    and dS_out passed over the chunks in fp32, then split hi + lo for every
    product that takes them (and for dtotal's exp(total) sum(dS_out o
    S_in), with dS_out in fp32); M = (C B^T) o Lmask, W = dY Xbar^T and Wd
    = W o Lmask in fp32; dXbar = split(M)^T dY + exp(total - cum) o (B
    dS_out^T); Wd summed over each group's heads, then split, for dB = Wd^T
    C and dC = Wd B (the kernel sums Wd over a slice of the group's heads at
    a time; the sum's rounding is fp32's either way); the state terms of dB,
    dC and dcum.  ``split=False`` rounds each of those fp32 operands once to
    bf16 instead: the control that dlog_a's tolerance must catch.  Returns
    what :func:`ssd_scan_bwd_plain` returns.  Only the tests and the checks
    of ``chip_smoke.py`` use it."""
    b, s, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    ln = min(chunk, TC_BWD_CHUNK, s)
    nc = -(-s // ln)
    pad = nc * ln - s
    parts = _split if split else (
        lambda t: (t.to(torch.bfloat16).to(torch.float32),))
    both = lambda t: sum(parts(t))  # the operand as the products see it

    def chunks(t, *tail):
        t = F.pad(t.to(torch.float32), (0, 0) * len(tail) + (0, pad))
        return t.reshape(b, nc, ln, *tail)
    xb, la, dyc = chunks(xbar, h, p), chunks(log_a, h), chunks(dy, h, p)
    Bc, Cc = chunks(B, g, n), chunks(C, g, n)
    Bh = Bc.repeat_interleave(rep, dim=3)                      # [b,c,l,h,n]
    Ch = Cc.repeat_interleave(rep, dim=3)
    cum = torch.cumsum(la, dim=2)                              # [b,c,l,h]
    total = cum[:, :, -1]                                      # [b,c,h]
    w_end = torch.exp(total[:, :, None] - cum)[..., None]      # [b,c,l,h,1]
    w_cum = torch.exp(cum)[..., None]

    # emit and demit, the decayed Xbar and dY split
    emit = sum(torch.einsum("bclhp,bclhn->bchpn", part, Bh)
               for part in parts(w_end * xb))
    demit = sum(torch.einsum("bclhp,bclhn->bchpn", part, Ch)
                for part in parts(w_cum * dyc))
    # the state passes, in fp32
    state = (init_state.to(torch.float32) if init_state is not None
             else xbar.new_zeros((b, h, p, n), dtype=torch.float32))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + emit[:, c]
    ds = (dfinal.to(torch.float32) if dfinal is not None
          else torch.zeros_like(state))
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = ds
        ds = ds * torch.exp(total[:, c])[..., None, None] + demit[:, c]
    s_in, ds_out = torch.stack(s_in, dim=1), torch.stack(ds_out, dim=1)
    s_in_k, ds_out_k = both(s_in), both(ds_out)

    # intra-chunk terms
    ct = cum.transpose(2, 3)                                   # [b,c,h,l]
    ii = torch.arange(ln, device=xbar.device)
    seg = (ct[..., :, None] - ct[..., None, :]).masked_fill(
        ii[:, None] < ii[None, :], float("-inf"))
    lmask = torch.exp(seg)                                     # [b,c,h,t,s]
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    m = cb.repeat_interleave(rep, dim=2) * lmask
    w = torch.einsum("bcthp,bcshp->bchts", dyc, xb)
    mw = m * w
    wd = (w * lmask).reshape(b, nc, g, rep, ln, ln).sum(3)     # [b,c,g,t,s]
    # state terms
    dx_off = w_end * torch.einsum("bcshn,bchpn->bcshp", Bh, ds_out_k)
    db_off = w_end * torch.einsum("bcshp,bchpn->bcshn", xb, ds_out_k)
    dc_off = w_cum * torch.einsum("bcthp,bchpn->bcthn", dyc, s_in_k)
    e = (xb * dx_off).sum(-1)                                  # [b,c,l,h]
    dxbar = sum(torch.einsum("bchts,bcthp->bcshp", part, dyc)
                for part in parts(m)) + dx_off
    wd_k = both(wd)
    dB = torch.einsum("bcgts,bctgn->bcsgn", wd_k, Cc) \
        + db_off.reshape(b, nc, ln, g, rep, n).sum(4)
    dC = torch.einsum("bcgts,bcsgn->bctgn", wd_k, Bc) \
        + dc_off.reshape(b, nc, ln, g, rep, n).sum(4)
    dcum = (mw.sum(-1) - mw.sum(-2)).transpose(2, 3) \
        + (Ch * dc_off).sum(-1) - e
    dtotal = torch.exp(total) * (ds_out * s_in_k).sum((-1, -2)) + e.sum(2)
    dcum[:, :, -1] += dtotal
    dla = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))

    def unchunk(t, dtype):
        return t.reshape(b, nc * ln, *t.shape[3:])[:, :s].to(dtype)
    return (unchunk(dxbar, xbar.dtype), unchunk(dla, torch.float32),
            unchunk(dB, B.dtype), unchunk(dC, C.dtype),
            ds if init_state is not None else None)


def _entry():
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if not fn.argtypes:
        ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [vp] * 9 + [ci] * 7 + [ll] * 4 + [ci, vp]
        fn.restype = ci
    return lib, fn


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the kernel reads B or C ``[B,S,G,N]`` through its strides or
    the wrapper makes it contiguous first.  Unit stride along N and stride N
    between groups; batch and row strides may be anything (the model hands
    over views of its projection), except that the bf16 body reads them by
    TMA: there the base and both strides must be 16-byte aligned."""
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        return False
    if t.dtype != torch.bfloat16:
        return True
    per16 = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(0) % per16 == 0
            and t.stride(1) % per16 == 0)


def scratch_shapes(b: int, s: int, h: int, g: int, p: int, n: int,
                   chunk: int) -> dict:
    """Shapes of the bf16 body's fp32 scratch buffers, with L = min(chunk,
    S) rows a chunk: the chunk cumsums, rows of L rounded up to whole 64-row
    tiles (the backward reads a head's as one bulk copy; both bodies keep
    one layout), and the per-chunk states (emit, then the state entering
    each chunk), by (b, head, chunk) as the backward's.  C B^T has none: the
    chunk-output kernel forms it in shared memory."""
    ln = min(chunk, s)
    nc = -(-s // ln)
    lt = -(-ln // 64) * 64
    return {"cum": (b, h, nc, lt), "st": (b, h, nc, p, n)}


def ssd_fwd_body(dtype: torch.dtype) -> str:
    """The forward body a CUDA call runs, by type alone: ``"wgmma"`` (wgmma
    and TMA, every fp32 operand split hi + lo) for bf16, ``"fma"`` for
    fp32."""
    return "fma" if dtype == torch.float32 else "wgmma"


def _check(xbar, log_a, B, C, chunk, init_state) -> None:
    b, s, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    tensors = [log_a, B, C] + ([init_state] if init_state is not None else [])
    if any(t.device != xbar.device for t in tensors):
        raise ValueError("ssd_scan: tensors on different devices")
    if xbar.dtype not in _DTYPE_CODE or B.dtype != xbar.dtype \
            or C.dtype != xbar.dtype:
        raise TypeError(f"ssd_scan: float32 or bfloat16 xbar/B/C of one "
                        f"type, got {xbar.dtype}, {B.dtype}, {C.dtype}")
    if log_a.dtype != torch.float32 or (
            init_state is not None and init_state.dtype != torch.float32):
        raise TypeError("ssd_scan: log_a and init_state must be float32")
    if (log_a.shape != (b, s, h) or B.shape != (b, s, g, n)
            or C.shape != B.shape or s < 1 or h % g != 0
            or (init_state is not None
                and init_state.shape != (b, h, p, n))):
        raise ValueError(f"ssd_scan: shapes {tuple(xbar.shape)}, "
                         f"{tuple(log_a.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    if p not in SUPPORTED_HEAD_DIMS or n not in SUPPORTED_STATE_SIZES:
        raise ValueError(f"ssd_scan: head dim {p} not in "
                         f"{SUPPORTED_HEAD_DIMS} or state size {n} not in "
                         f"{SUPPORTED_STATE_SIZES}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} outside [1, {MAX_CHUNK}]")


def _launch_fwd(xbar, log_a, B, C, chunk, init_state):
    """One launch of the forward kernel: (y, final_state)."""
    _check(xbar, log_a, B, C, chunk, init_state)
    b, s, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    xbar, log_a = xbar.contiguous(), log_a.contiguous()
    B, C = (t if reads_in_place(t) else t.contiguous() for t in (B, C))
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty_like(xbar, memory_format=torch.contiguous_format)
    state = torch.empty((b, h, p, n), dtype=torch.float32,
                        device=xbar.device)
    scratch = [None] * 2
    if xbar.dtype == torch.bfloat16:
        scratch = [torch.empty(shape, dtype=torch.float32, device=xbar.device)
                   for shape in scratch_shapes(b, s, h, g, p, n,
                                               chunk).values()]
    lib, fn = _entry()
    with torch.cuda.device(xbar.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(xbar.data_ptr(), log_a.data_ptr(), B.data_ptr(),
                  C.data_ptr(),
                  init_state.data_ptr() if init_state is not None else None,
                  y.data_ptr(), state.data_ptr(),
                  *(t.data_ptr() if t is not None else None
                    for t in scratch), b, s, h, g, p, n, chunk,
                  B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                  _DTYPE_CODE[xbar.dtype], stream)
    _build.check(lib, code, "ssd_scan launch", "repro_ssd_scan_error_string")
    ssd_scan.launches += 1
    return y, state


def _bwd_entry():
    lib = _build.load("ssd_scan_bwd")
    fn = lib.repro_ssd_scan_bwd
    if not fn.argtypes:
        ci, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [vp] * 19 + [ci] * 9 + [vp]
        fn.restype = ci
    return lib, fn


def ssd_bwd_body(dtype: torch.dtype) -> str:
    """The backward body a CUDA call runs, by type alone: ``"wgmma"``
    (wgmma and TMA, every fp32 operand split hi + lo) for bf16, ``"fma"``
    for fp32."""
    return "fma" if dtype == torch.float32 else "wgmma"


def tile_heads(b: int, nc: int, g: int, lt: int, rep: int, sms: int) -> int:
    """Heads of a group that one block of the wgmma backward's tile kernel
    takes (a slice): as few as make about four blocks an SM of the ``b * nc
    * g * lt / 64`` tiles and the slices, at least 1, at most the group's
    ``rep`` heads.  The kernel runs one block an SM (216 KB of shared memory
    at N = 128), so four waves keep the last one's idle SMs few; each slice
    more adds a dB and a dC ``[B,S,G,N]`` in fp32 and the Wd products once
    more."""
    tiles = b * nc * g * (lt // 64)
    slices = min(max(-(-4 * sms // tiles), 1), rep)
    return -(-rep // slices)


def ssd_scan_bwd(xbar: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, dy: torch.Tensor,
                 dfinal: Optional[torch.Tensor], *, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """The backward kernel: (dxbar, dlog_a fp32, dB, dC summed over each
    group's heads, d init_state fp32 or None), as
    :func:`ssd_scan_bwd_plain`.  CUDA tensors of the forward's types and
    shapes (dy in ``xbar.dtype``, dfinal fp32 or None); every input is made
    contiguous first.  The body is :func:`ssd_bwd_body`'s; the tensor-core
    body runs on chunks of ``min(chunk, TC_BWD_CHUNK)`` rows, a choice made
    here alone: the kernel takes the rows a chunk, which size its scratch,
    and refuses more than its shared memory holds.  fp32 scratch:
    the chunk states and their gradients, ``2 x [B,H,nc,P,N]`` (268 MB at
    mamba2-1.3b's ``[8, 2048]`` tokens), dB and dC of each slice of heads
    summed in fp32 in order (bf16: :func:`tile_heads`'s slices, before the
    cast; fp32: one head a slice, ``2 x [H/G,B,S,G,N]``, 67 MB each at
    mamba2-1.3b's gradient-parity cut, B 2 x S 1024), and for bf16 the
    chunk cumsums ``[B,H,nc,LT]`` (LT: the chunk's rows rounded up to whole
    64-row tiles, so that a head's cumsum is one bulk copy), dcum in two
    parts ``[2,B,H,nc,L]`` and dtotal ``[B,H,nc,1 + LT / 64]``.  Both bodies
    sum in a fixed order, so a call repeats bit for bit."""
    _check(xbar, log_a, B, C, chunk, init_state)
    b, s, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    if dy.shape != xbar.shape or dy.dtype != xbar.dtype or dy.device != \
            xbar.device or (dfinal is not None and (
                dfinal.shape != (b, h, p, n) or dfinal.dtype != torch.float32
                or dfinal.device != xbar.device)):
        raise ValueError("ssd_scan_bwd: dy must match xbar, dfinal the "
                         "fp32 state")
    xbar, log_a, B, C, dy = (t.contiguous() for t in (xbar, log_a, B, C, dy))
    dfinal = dfinal.contiguous() if dfinal is not None else None
    init = init_state.contiguous() if init_state is not None else None
    dev = xbar.device
    body = ssd_bwd_body(xbar.dtype)
    ln = min(chunk, s) if body == "fma" else min(chunk, TC_BWD_CHUNK, s)
    nc = -(-s // ln)
    lt = -(-ln // 64) * 64
    f32 = dict(dtype=torch.float32, device=dev)
    dxbar = torch.empty_like(xbar)
    dla = torch.empty((b, s, h), **f32)
    hs = 1
    if body == "wgmma":  # each slice of hs heads writes its own dB and dC
        hs = tile_heads(b, nc, g, lt, h // g,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    # the FMA body adds each query tile's dC into its head's slice
    db_acc = torch.empty((-(-(h // g) // hs), b, s, g, n), **f32)
    dc_acc = (torch.empty_like if body == "wgmma" else
              torch.zeros_like)(db_acc)
    db, dc = torch.empty_like(B), torch.empty_like(C)
    dinit = torch.empty((b, h, p, n), **f32) if init is not None else None
    s_in = torch.empty((b, h, nc, p, n), **f32)
    ds_out = torch.empty_like(s_in)
    tc = [None] * 3
    if body == "wgmma":  # cum, dcum's two parts, dtotal
        tc = [torch.empty(shape, **f32) for shape in (
            (b, h, nc, lt), (2, b, h, nc, ln), (b, h, nc, 1 + lt // 64))]
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib, fn = _bwd_entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(ptr(xbar), ptr(log_a), ptr(B), ptr(C), ptr(dy), ptr(dfinal),
                  ptr(init), ptr(dxbar), ptr(dla), ptr(db_acc), ptr(dc_acc),
                  ptr(db), ptr(dc),
                  ptr(dinit), ptr(s_in), ptr(ds_out), *map(ptr, tc),
                  b, s, h, g, p, n, ln, hs, _BWD_BODY_CODE[body], stream)
    _build.check(lib, code, "ssd_scan_bwd launch",
                 "repro_ssd_scan_bwd_error_string")
    ssd_scan_bwd.launches += 1
    return dxbar, dla, db, dc, dinit


ssd_scan_bwd.launches = 0


class SsdScanFn(torch.autograd.Function):
    """The SSD scan with its backward.  CUDA tensors: the forward kernel,
    then the backward kernel (which recomputes the chunk states).  CPU
    tensors: the plain versions of both.  Saves the inputs only, and only
    when ``want`` (grad mode on and an input that requires a gradient)."""

    @staticmethod
    def forward(ctx, xbar, log_a, B, C, init_state, chunk, want):
        if xbar.is_cuda:
            y, state = _launch_fwd(xbar, log_a, B, C, chunk, init_state)
        else:
            y, state = ssd_scan_plain(xbar, log_a, B, C, chunk=chunk,
                                      init_state=init_state)
        if want:
            ctx.save_for_backward(xbar, log_a, B, C, init_state)
            ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dfinal):
        xbar, log_a, B, C, init_state = ctx.saved_tensors
        bwd = ssd_scan_bwd if xbar.is_cuda else ssd_scan_bwd_plain
        dx, dla, db, dc, dinit = bwd(xbar, log_a, B, C, dy, dfinal,
                                     chunk=ctx.chunk, init_state=init_state)
        return dx, dla, db, dc, dinit, None, None


def ssd_scan(xbar: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xbar [B,S,H,P], log_a [B,S,H] fp32, B/C [B,S,G,N], init_state
    [B,H,P,N] fp32 or None -> (y [B,S,H,P] in ``xbar.dtype``, final_state
    [B,H,P,N] fp32), through :class:`SsdScanFn` (differentiable on both
    devices).

    CUDA tensors: xbar, B and C float32 or bfloat16 of one type; P in
    (16, 32, 64), N in (16, 32, 64, 128), H a multiple of G,
    1 <= chunk <= 1024, any S >= 1.  B and C are read through their batch and
    row strides; a tensor the kernel cannot read in place is made contiguous
    first.  Anything else raises.  Counts forward launches; the backward
    kernel counts its own (:func:`ssd_scan_bwd`).

    bf16 runs the wgmma body (:func:`ssd_fwd_body`): three CUDA kernels in
    one launch count, with fp32 scratch from ``torch.empty``
    (:func:`scratch_shapes`: 139 MB at mamba2-1.3b's prefill, ``[8, 2048]``
    tokens).  fp32 runs the FMA body.
    """
    want = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (xbar, log_a, B, C, init_state))
    return SsdScanFn.apply(xbar, log_a, B, C, init_state, chunk, want)


ssd_scan.launches = 0
