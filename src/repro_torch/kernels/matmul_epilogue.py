"""Matrix product with a fused epilogue: the hand-written Hopper kernel, its
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``matmul_epilogue`` / ``_mm_epi_kernel`` (epilogue
``_epilogue_f32``) of ``src/repro/kernels/matmul_epilogue.py``:
``epilogue(x @ w)`` with the product accumulated in fp32, the epilogue (bias,
silu, gelu in its tanh form, or an affine-free layernorm over the full row)
applied in fp32 before the single write, and the result cast to
``out_dtype`` on that write (cast sinking: bf16 operands, fp32 logits).  The
CUDA source is ``csrc/matmul_epilogue.cu``; its header says how each body
differs from the TPU kernel.  :func:`matmul_body` picks the body a CUDA call
runs, and every body replaces the same TPU kernel:

* ``"wgmma"`` (bf16, M > 64, operands and output describable by TMA): the
  prefill gates, bound by operations (zamba2's ``[16384,2560]x[2560,10240]``
  0.87 ms at 989 TFLOP/s).  Persistent, warp-specialised ``wgmma`` + TMA on
  128 x 256 tiles (128 x 128 for fp32 out), the epilogue's tile stored by TMA
  while the next tile runs.
* ``"small_m"`` (bf16, M <= 64): the decode-step gates and the heads, bound
  by the bytes of w.  Persistent blocks stream units of w (a slab of 64
  columns, 128 for the widest heads, and a share of K), all at the same
  rows, through a ring of TMA boxes (``cp.async`` for a w that TMA cannot
  describe), with the operands swapped on the tensor cores; where K is
  split the partial sums meet in a fixed order in a workspace that is made
  once per device and stream.  A weight's tensor map is made at its first
  call and kept in the library, so a decode step encodes none.
* ``"mma_sync"`` (bf16, M > 64, not describable by TMA), ``"layernorm"``
  (whole rows in shared memory, N <= 3072), ``"fma"`` (fp32, full-fp32 FMA).

The gradient (:class:`MatmulEpilogueFn`) has no kernel of its own: the
reference computes the gate and the head as einsums outside any Pallas
kernel, and their gradients are plain products.  For silu and gelu the
backward recomputes ``z = x @ w`` with the forward kernel and an fp32 out
(the plain version on the CPU), forms ``dz = g o act'(z)`` and then
``dx = dz w^T``, ``dw = x^T dz`` and ``dbias = sum dz`` with ``torch.matmul``
in the operands' type; the layernorm epilogue, on no training path, raises
under grad.

The wrapper decides by the tensor's device and by nothing else: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

EPILOGUES = (None, "bias", "silu", "gelu", "layernorm")
LN_EPS = 1e-6
# Layernorm keeps 16 fp32 rows of the full width in one block's shared memory.
LN_MAX_N = 3072
_EPILOGUE_CODE = {None: 0, "bias": 1, "silu": 2, "gelu": 3, "layernorm": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODE = {"fma": 0, "mma_sync": 1, "wgmma": 2, "small_m": 3,
              "layernorm": 4}
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}
# The small-M body: at most 64 rows; slabs of 64 columns of w or more, one
# arrival counter a slab.
SMALL_M_MAX = 64
SMALL_M_COLS = 64


def _epilogue_f32(acc: torch.Tensor, epilogue: Optional[str],
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue on an fp32 accumulator, as the reference's
    ``_epilogue_f32``."""
    if epilogue is None:
        return acc
    if epilogue == "bias":
        return acc + bias.to(torch.float32)
    if epilogue == "silu":
        return F.silu(acc)
    if epilogue == "gelu":
        return F.gelu(acc, approximate="tanh")
    if epilogue == "layernorm":
        mu = acc.mean(dim=-1, keepdim=True)
        var = (acc - mu).square().mean(dim=-1, keepdim=True)
        return (acc - mu) * torch.rsqrt(var + LN_EPS)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def matmul_epilogue_plain(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          epilogue: Optional[str] = None,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The reference's oracle (``ref.matmul_epilogue_ref``): an fp32
    product, the epilogue in fp32, one cast."""
    acc = x.to(torch.float32) @ w.to(torch.float32)
    return _epilogue_f32(acc, epilogue, bias).to(out_dtype or x.dtype)


def _entry():
    lib = _build.load("matmul_epilogue")
    fn = lib.repro_matmul_epilogue
    if not fn.argtypes:
        ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [vp] * 4 + [ci] * 3 + [ll] * 4 + [ci] * 8 + [vp] * 3
        fn.restype = ci
    return lib, fn


def tma_describable(t: torch.Tensor, unit_axis: int) -> bool:
    """Whether the 2-D ``t`` is what a TMA tensor map describes with
    ``unit_axis`` innermost: unit stride there, a 16-byte-aligned base, and
    the other stride a multiple of 16 bytes, no shorter than a row and below
    2^40 bytes."""
    other = 1 - unit_axis
    row = t.stride(other) * t.element_size()
    return (t.stride(unit_axis) == 1 and t.data_ptr() % 16 == 0
            and row % 16 == 0 and t.shape[unit_axis] <= t.stride(other)
            and row < 2 ** 40)


def matmul_body(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype],
                epilogue: Optional[str]) -> str:
    """The body a CUDA call runs: ``"layernorm"`` for that epilogue;
    ``"fma"`` for fp32; for bf16, ``"small_m"`` at M <= 64, ``"wgmma"`` when
    x has unit stride along K, w along either axis (a transposed w is a
    K-major operand), both as :func:`tma_describable` asks, and the output's
    rows are a multiple of 16 bytes; else ``"mma_sync"``."""
    if epilogue == "layernorm":
        return "layernorm"
    if x.dtype == torch.float32:
        return "fma"
    if x.shape[0] <= SMALL_M_MAX:
        return "small_m"
    osize = _ELEMENT_SIZE.get(out_dtype or x.dtype, 0)
    if (osize and w.shape[1] * osize % 16 == 0 and tma_describable(x, 1)
            and (tma_describable(w, 1) or tma_describable(w, 0))):
        return "wgmma"
    return "mma_sync"


# per (device, stream, m, n, k): the small-M body's slab width (in tiles of
# 64 columns), split of K and block count, and the addresses of its
# workspace (None without a split); one lookup a decode call
_small_m_calls: Dict[Tuple[int, int, int, int, int], tuple] = {}
# per (device, stream): the small-M body's fp32 partials and its int32
# arrival counters (0 between calls: the kernel resets them); calls on one
# stream run in turn, calls on two streams never share them
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _small_m_args(lib, dev: int, stream: int, m: int, n: int, k: int
                  ) -> tuple:
    """The kernel's slab width, split of K and block count for the shape,
    asked of the library once per shape, device and stream (a function of
    the shape and the card alone, so a call sums its partials in the same
    order every time), and the workspace's addresses."""
    key = (dev, stream, m, n, k)
    args = _small_m_calls.get(key)
    if args is not None:
        return args
    fn = lib.repro_matmul_epilogue_small_m_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    plan = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(dev):
        code = fn(m, n, k, *(ctypes.byref(v) for v in plan))
    _build.check(lib, code, "matmul_epilogue small-M plan",
                 "repro_matmul_epilogue_error_string")
    slab_tiles, splits, blocks = (v.value for v in plan)
    ws = counters = None
    if splits > 1:
        ws, counters = _small_m_workspace(dev, stream, splits * m * n,
                                          -(-n // SMALL_M_COLS))
    args = (slab_tiles, splits, blocks,
            ws.data_ptr() if ws is not None else None,
            counters.data_ptr() if counters is not None else None)
    _small_m_calls[key] = args
    return args


def _small_m_workspace(dev: int, stream: int, floats: int, slabs: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The workspace of the device and stream, made at first use and made
    again, larger, only when a call needs more (which forgets the addresses
    :func:`_small_m_args` kept)."""
    ws, counters = _workspaces.get((dev, stream), (None, None))
    if ws is None or ws.numel() < floats or counters.numel() < slabs:
        device = torch.device("cuda", dev)
        size = max(floats, 0 if ws is None else ws.numel())
        ws = torch.empty(size, dtype=torch.float32, device=device)
        count = max(slabs, 0 if counters is None else counters.numel())
        counters = torch.zeros(count, dtype=torch.int32, device=device)
        _workspaces[(dev, stream)] = (ws, counters)
        for key in [key for key in _small_m_calls
                    if key[:2] == (dev, stream)]:
            del _small_m_calls[key]
    return ws, counters


def _check_args(x, w, bias, epilogue) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_epilogue: x [m, k] and w [k, n], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (epilogue == "bias") != (bias is not None):
        raise ValueError("bias operand required iff epilogue == 'bias'")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"matmul_epilogue: bias [n], got {tuple(bias.shape)}")


def _launch(x, w, bias, epilogue, out_dtype) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors."""
    out_dtype = out_dtype or x.dtype
    m, k = x.shape
    n = w.shape[1]
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("matmul_epilogue: tensors on different devices")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype \
            or out_dtype not in _DTYPE_CODE \
            or (bias is not None and bias.dtype not in _DTYPE_CODE):
        raise TypeError(f"matmul_epilogue: float32 or bfloat16 x/w of one "
                        f"type, bias and output, got {x.dtype}, {w.dtype}, "
                        f"{None if bias is None else bias.dtype}, {out_dtype}")
    if m < 1 or n < 1 or k < 1 or min(x.stride() + w.stride()) < 0:
        raise ValueError(f"matmul_epilogue: empty or negatively strided "
                         f"operands {tuple(x.shape)}, {tuple(w.shape)}")
    if epilogue == "layernorm" and n > LN_MAX_N:
        raise ValueError(f"matmul_epilogue: layernorm over {n} columns; the "
                         f"kernel keeps whole rows of at most {LN_MAX_N}")
    if bias is not None and bias.stride(0) != 1:
        bias = bias.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    body = matmul_body(x, w, out_dtype, epilogue)
    lib, fn = _entry()
    dev = x.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    slab_tiles = splits = blocks = 0
    ws = counters = None
    if body == "small_m":
        slab_tiles, splits, blocks, ws, counters = _small_m_args(
            lib, dev, stream, m, n, k)
    # the launch goes to the current device: x's, switched to if need be
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        code = fn(x.data_ptr(), w.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), m, n, k, x.stride(0), x.stride(1),
                  w.stride(0), w.stride(1), _EPILOGUE_CODE[epilogue],
                  _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
                  _DTYPE_CODE[bias.dtype] if bias is not None else 0,
                  _BODY_CODE[body], slab_tiles, splits, blocks, ws, counters,
                  stream)
    _build.check(lib, code, "matmul_epilogue launch",
                 "repro_matmul_epilogue_error_string")
    matmul_epilogue.launches += 1
    matmul_epilogue.body_launches[body] += 1
    return out


_SQRT_2_OVER_PI = 0.7978845608028654


def _act_grad(z: torch.Tensor, epilogue: Optional[str]) -> torch.Tensor:
    """d epilogue(z) / dz of the elementwise epilogues, in fp32."""
    if epilogue == "silu":
        sig = torch.sigmoid(z)
        return sig * (1 + z * (1 - sig))
    # gelu, tanh form: 0.5 z (1 + tanh(u)), u = sqrt(2/pi) (z + 0.044715 z^3)
    t = torch.tanh(_SQRT_2_OVER_PI * (z + 0.044715 * z ** 3))
    return 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * _SQRT_2_OVER_PI * (
        1 + 3 * 0.044715 * z * z)


class MatmulEpilogueFn(torch.autograd.Function):
    """``epilogue(x @ w + bias)`` with its gradient: the forward is the
    kernel (CUDA) or the plain version (CPU); the backward recomputes z the
    same way, then takes plain products (see the module's docstring)."""

    @staticmethod
    def forward(ctx, x, w, bias, epilogue, out_dtype):
        out = (_launch(x, w, bias, epilogue, out_dtype) if x.is_cuda
               else matmul_epilogue_plain(x, w, bias, epilogue=epilogue,
                                          out_dtype=out_dtype))
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(x, w, bias)
            ctx.epilogue = epilogue
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        dz = g.to(torch.float32)
        if ctx.epilogue in ("silu", "gelu"):
            # z = x @ w again, by the forward's own route with an fp32 out
            # (these epilogues take no bias)
            z = (_launch(x, w, None, None, torch.float32) if x.is_cuda
                 else matmul_epilogue_plain(x, w, out_dtype=torch.float32))
            dz = dz * _act_grad(z, ctx.epilogue)
            del z
        dzx = dz.to(x.dtype)
        dx = torch.matmul(dzx, w.T) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.T, dzx) if ctx.needs_input_grad[1] else None
        dbias = (dz.sum(0).to(bias.dtype) if bias is not None
                 and ctx.needs_input_grad[2] else None)
        return dx, dw, dbias, None, None


def matmul_epilogue(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    epilogue: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [m, k], w: [k, n], bias: [n] (iff ``epilogue == "bias"``) ->
    ``epilogue(x @ w)`` as a contiguous [m, n] tensor in ``out_dtype``
    (default ``x.dtype``), through :class:`MatmulEpilogueFn`.

    CUDA tensors: x and w float32 or bfloat16 of one type, bias float32 or
    bfloat16, ``out_dtype`` float32 or bfloat16; any m, n and k; x and w are
    read in place through their strides (a transposed w too), never copied.
    The body is :func:`matmul_body`'s.  The layernorm epilogue normalises
    whole rows of at most ``LN_MAX_N = 3072`` columns and has no gradient.
    Anything else raises.  Counts every launch of the kernel, the backward's
    recompute of z for silu and gelu included.
    """
    _check_args(x, w, bias, epilogue)
    if epilogue == "layernorm" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        raise NotImplementedError("matmul_epilogue: the layernorm epilogue "
                                  "has no gradient")
    return MatmulEpilogueFn.apply(x, w, bias, epilogue, out_dtype)


matmul_epilogue.launches = 0
# launches of each body, beside the total
matmul_epilogue.body_launches = dict.fromkeys(_BODY_CODE, 0)
