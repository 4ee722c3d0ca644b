"""The Mamba2 block's causal conv: the hand-written Hopper kernels (forward
and backward), their wrappers, the autograd Function that joins them, and
their plain PyTorch versions.

Replaces no TPU kernel: the reference runs ``_causal_conv``
(``src/repro/models/mamba.py``) as array ops, which XLA fuses; eagerly in
PyTorch it is a concatenation with the conv state and some nine passes over
``[B, S, C]``.  The kernels (``csrc/causal_conv.cu``, whose header gives the
design) do the depthwise causal conv of width W, the bias and the SiLU in
one pass, reading the input in place as the strided slice of the
in-projection it is, with the sum and the SiLU in fp32 and one rounding to
the input's type.  Bytes bound them: at mamba2-1.3b's ``[8, 2048]`` tokens
(C = 4352) the forward moves 285 MB and the backward 428 MB.

The backward recomputes the pre-activation, writes dx once and dstate only
where the state needs a gradient, and sums dw and db over the tiles in a
fixed order from fp32 partials: a call repeats bit for bit.
:class:`CausalConvFn` runs both kernels on CUDA tensors and
:func:`causal_conv_plain` / :func:`causal_conv_bwd_plain` on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.models.mamba import _causal_conv

MAX_WIDTH = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# rows of a tile at most, and at least: fewer where the grid would leave
# the card's SMs short of threads (short prompts, decode)
TILE_ROWS, MIN_TILE_ROWS = 64, 8


def causal_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``mamba._causal_conv`` in
    fp32, its outputs rounded once to ``x.dtype``.  At fp32 it is
    ``_causal_conv`` itself, bit for bit."""
    f32 = lambda t: t.to(torch.float32) if t is not None else None
    out, new_state = _causal_conv(f32(x), f32(w), f32(b), f32(state))
    return out.to(x.dtype), new_state.to(x.dtype)


def causal_conv_bwd_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          state: Optional[torch.Tensor], dout: torch.Tensor,
                          want_dstate: bool):
    """The gradients of :func:`causal_conv_plain`'s ``out`` by autograd in
    fp32: (dx, dw, db, dstate or None) in their inputs' types."""
    with torch.enable_grad():
        leaves = [t.detach().to(torch.float32).requires_grad_()
                  for t in (x, w, b)]
        st = None if state is None else state.detach().to(torch.float32)
        if want_dstate:
            leaves.append(st.requires_grad_())
        out, _ = _causal_conv(*leaves[:3], st)
        grads = torch.autograd.grad(out, leaves, dout.to(torch.float32))
    dx, dw, db = (g.to(t.dtype) for g, t in zip(grads, (x, w, b)))
    return dx, dw, db, grads[3].to(state.dtype) if want_dstate else None


def check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          state: Optional[torch.Tensor]) -> None:
    """Raise on what the kernels do not take, on either device."""
    if x.dim() != 3 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"causal_conv: x [B,S,C], w [W,C], b [C]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    bsz, s, c = x.shape
    width = w.shape[0]
    if w.shape[1] != c or b.shape != (c,) or s < 1 or (
            state is not None and state.shape != (bsz, width - 1, c)):
        raise ValueError(f"causal_conv: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}, "
                         f"{None if state is None else tuple(state.shape)}")
    if not 2 <= width <= MAX_WIDTH:
        raise ValueError(f"causal_conv: width {width} outside "
                         f"[2, {MAX_WIDTH}]")
    tensors = [w, b] + ([state] if state is not None else [])
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in tensors):
        raise TypeError(f"causal_conv: float32 or bfloat16 x, w, b and "
                        f"state of one type, got {x.dtype}, "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("causal_conv: tensors on different devices")


def tile_rows(b: int, s: int, c: int, dtype: torch.dtype, sms: int) -> int:
    """Rows a thread walks: :data:`TILE_ROWS`, halved down to
    :data:`MIN_TILE_ROWS` while the grid has fewer than 1024 threads an SM
    (a thread takes 16 bytes of channels of a tile's rows)."""
    vecs = -(-c // (16 // dtype.itemsize))
    rows = TILE_ROWS
    while rows > MIN_TILE_ROWS and b * -(-s // rows) * vecs < 1024 * sms:
        rows //= 2
    return rows


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptr: int):
    lib = _build.load("causal_conv")
    fn = getattr(lib, name)
    ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [vp] * n_ptr + [ci] * 4 + [ll] * 2 + [ci] * 2 + [vp]
    fn.restype = ci
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _prepare(x, w, b, state):
    """Checks; the operands as the kernel reads them (x through its batch
    and row strides, unit stride along C) and the tile rows."""
    if not x.is_cuda:
        raise ValueError("causal_conv: the kernel takes CUDA tensors (CPU "
                         "tensors take causal_conv_plain)")
    check(x, w, b, state)
    if x.stride(2) != 1:
        x = x.contiguous()
    w, b = w.contiguous(), b.contiguous()
    state = state.contiguous() if state is not None else None
    bsz, s, c = x.shape
    rows = tile_rows(bsz, s, c, x.dtype, _sms(x.device))
    return x, w, b, state, rows


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


@tracing.spanned("kernel.causal_conv")
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel: (silu(conv + b) [B,S,C]
    contiguous, new_state [B,W-1,C]), as :func:`causal_conv_plain`.  CUDA
    tensors of one type, float32 or bfloat16; x read through its batch and
    row strides (made contiguous only if its channels are not)."""
    x, w, b, state, rows = _prepare(x, w, b, state)
    bsz, s, c = x.shape
    width = w.shape[0]
    out = torch.empty((bsz, s, c), dtype=x.dtype, device=x.device)
    new_state = torch.empty((bsz, width - 1, c), dtype=x.dtype,
                            device=x.device)
    lib, fn = _entry("repro_causal_conv_fwd", 6)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(state),
                  out.data_ptr(), new_state.data_ptr(), bsz, s, c, width,
                  x.stride(0), x.stride(1), rows, _DTYPE_CODE[x.dtype],
                  stream)
    _build.check(lib, code, "causal_conv launch",
                 "repro_causal_conv_error_string")
    causal_conv.launches += 1
    return out, new_state


causal_conv.launches = 0


@tracing.spanned("kernel.causal_conv_bwd")
def causal_conv_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    state: Optional[torch.Tensor], dout: torch.Tensor,
                    want_dstate: bool):
    """The backward kernel and its fixed-order sum of the tiles' dw and db:
    (dx, dw, db, dstate or None), as :func:`causal_conv_bwd_plain`.  fp32
    scratch ``[B * ceil(S / rows), W + 1, C]`` for the tiles' partials
    (22 MB at mamba2-1.3b's ``[8, 2048]`` tokens)."""
    x, w, b, state, rows = _prepare(x, w, b, state)
    bsz, s, c = x.shape
    width = w.shape[0]
    if dout.shape != (bsz, s, c) or dout.dtype != x.dtype \
            or dout.device != x.device:
        raise ValueError("causal_conv_bwd: dout must match x")
    if want_dstate and state is None:
        raise ValueError("causal_conv_bwd: dstate asked for with no state")
    dout = dout.contiguous()
    dx = torch.empty((bsz, s, c), dtype=x.dtype, device=x.device)
    dstate = torch.empty_like(state) if want_dstate else None
    part = torch.empty((bsz * -(-s // rows), width + 1, c),
                       dtype=torch.float32, device=x.device)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    lib, fn = _entry("repro_causal_conv_bwd", 10)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(state),
                  dout.data_ptr(), dx.data_ptr(), _ptr(dstate),
                  part.data_ptr(), dw.data_ptr(), db.data_ptr(), bsz, s, c,
                  width, x.stride(0), x.stride(1), rows,
                  _DTYPE_CODE[x.dtype], stream)
    _build.check(lib, code, "causal_conv_bwd launch",
                 "repro_causal_conv_error_string")
    causal_conv_bwd.launches += 1
    return dx, dw, db, dstate


causal_conv_bwd.launches = 0


class CausalConvFn(torch.autograd.Function):
    """The conv with its backward.  CUDA tensors: the forward kernel, then
    the backward kernel.  CPU tensors: the plain versions of both.  Saves
    the inputs only (x as the view it is), and only when ``want``.  The new
    state's gradient, where one flows, is added to dx and dstate here (its
    rows are the last W-1 of ``[state | x]``)."""

    @staticmethod
    def forward(ctx, x, w, b, state, want):
        fwd = causal_conv if x.is_cuda else causal_conv_plain
        out, new_state = fwd(x, w, b, state)
        ctx.set_materialize_grads(False)
        if want:
            ctx.save_for_backward(x, w, b, state)
        return out, new_state

    @staticmethod
    def backward(ctx, dout, dnew):
        x, w, b, state = ctx.saved_tensors
        want_dstate = ctx.needs_input_grad[3]
        if dout is None:
            dout = x.new_zeros(x.shape)
        bwd = causal_conv_bwd if x.is_cuda else causal_conv_bwd_plain
        dx, dw, db, dstate = bwd(x, w, b, state, dout, want_dstate)
        if dnew is not None:
            s, keep = x.shape[1], w.shape[0] - 1
            k = min(keep, s)                  # rows of the new state from x
            dx[:, s - k:] += dnew[:, keep - k:]
            if dstate is not None and k < keep:
                dstate[:, s:] += dnew[:, :keep - k]
        return dx, dw, db, dstate, None
