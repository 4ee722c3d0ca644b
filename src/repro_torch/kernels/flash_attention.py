"""Flash attention (forward): the hand-written Hopper kernel, its wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py``: blockwise online-softmax attention
with GQA by index, causal and sliding-window bands, fp32 running state.  The
CUDA source is ``csrc/flash_attention.cu``; its header says how the design
differs from the TPU kernel (KV loop inside the block over the band's tiles;
tiles of 64 keys by 64 query rows, 128 rows in the bf16 body for D <= 64;
``mma.sync`` for bf16 and full-fp32 FMA for fp32; ragged edges masked in the
kernel).

On this card causal attention is bound by operations, not bytes: at
``B=8, H=16, S=2048, D=64`` it is about 69 GFLOP against 134 MB moved.

The wrapper decides by the tensor's device and by nothing else: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import attention_dense

SUPPORTED_HEAD_DIMS = (32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Direct softmax attention with the kernel's arithmetic: fp32 scores,
    ``-1e30`` masking, ``p = exp(s - m) * mask``, ``l`` clamped at 1e-30."""
    return attention_dense(q, k, v, causal=causal, window=window, scale=scale)


def _entry():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if not fn.argtypes:
        ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = ([vp] * 4 + [ci] * 6 + [ll] * 12
                       + [ctypes.c_float, ci, ci, ci, vp])
        fn.restype = ci
    return lib, fn


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride along D and every row on a 16-byte boundary."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,D], k/v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in ``q.dtype``.

    Key ``j`` is visible to query ``i`` when ``j <= i`` (causal) and
    ``j > i - window`` (window); both count from 0, there is no ``q_offset``.

    CUDA tensors: q, k and v are read through their strides (the model hands
    over ``transpose(1, 2)`` views of ``[B,S,H,D]`` projections); a tensor whose
    rows are not 16-byte aligned with unit stride along D is made contiguous
    first.  The output is allocated as ``[B,Sq,Hq,D]`` and returned as its
    ``transpose(1, 2)`` view, so the caller's merge of heads is free.
    ``Sq`` and ``Skv`` are arbitrary; ``D`` must be 32, 64, 80 or 128 and the
    type float32 or bfloat16, anything else raises.  Forward only.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
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
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  b, hq, hkv, sq, skv, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *o.stride()[:3], scale, int(causal),
                  int(window) if window is not None else 0,
                  _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, code, "flash_attention launch",
                 "repro_flash_attention_error_string")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
