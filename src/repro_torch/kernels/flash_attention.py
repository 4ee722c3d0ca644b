"""Flash attention (forward): the hand-written Hopper kernel, its wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py``: blockwise online-softmax attention
with GQA by index, causal and sliding-window bands, fp32 running state.  The
CUDA source is ``csrc/flash_attention.cu``; its header says how the design
differs from the TPU kernel (KV loop inside the block over the band's tiles,
longest query tiles first, ragged edges masked in the kernel).  Three bodies,
chosen by :func:`flash_body`: ``wgmma`` + TMA for bf16 at D = 64 and 80 (the
served shapes), ``mma.sync`` for bf16 at D = 32 and 128, full-fp32 FMA for
fp32.

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
_BODY_CODE = {"fma": 0, "mma_sync": 1, "wgmma": 2}


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
                       + [ctypes.c_float, ci, ci, ci, vp, vp])
        fn.restype = ci
    return lib, fn


def flash_body(dtype: torch.dtype, d: int) -> str:
    """The body a CUDA call runs, by type and head dim alone: ``"wgmma"``
    (wgmma + TMA) for bf16 at D = 64 and 80, ``"mma_sync"`` for bf16 at
    D = 32 and 128, ``"fma"`` for fp32.  Each body takes every window and
    every GQA ratio."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d in (64, 80) else "mma_sync"


def reads_in_place(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` through its strides (else the wrapper
    makes it contiguous first): unit stride along D, a 16-byte-aligned base
    and every other stride a multiple of 16 bytes below 2^40, which is what
    a TMA tensor map and a 16-byte ``cp.async`` both need."""
    esize = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * esize % 16 == 0 and 0 <= s * esize < 2 ** 40
                    for s in t.stride()[:-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Hq,Sq,D], k/v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in ``q.dtype``.

    Key ``j`` is visible to query ``i`` when ``j <= i`` (causal) and
    ``j > i - window`` (window); both count from 0, there is no ``q_offset``.

    CUDA tensors: q, k and v are read through their strides (the model hands
    over ``transpose(1, 2)`` views of ``[B,S,H,D]`` projections); a tensor
    that fails :func:`reads_in_place` is made contiguous first.  The body is
    :func:`flash_body`'s: bf16 at D = 64 or 80 runs the ``wgmma`` + TMA body,
    bf16 at D = 32 or 128 the ``mma.sync`` body, fp32 the FMA body.  The
    output is allocated as ``[B,Sq,Hq,D]`` and returned as its
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
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
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
    q, k, v = (t if reads_in_place(t) else t.contiguous() for t in (q, k, v))
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    body = flash_body(q.dtype, d)
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
                  stream)
    _build.check(lib, code, "flash_attention launch",
                 "repro_flash_attention_error_string")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
