"""Mamba2 SSD chunked scan: the hand-written Hopper kernel, its wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``ssd_scan_kernel`` / ``_ssd_kernel`` of
``src/repro/kernels/ssd_scan.py``: the chunked scan on pre-scaled inputs
(``xbar = x * dt``, ``log_a = dt * A``), the fp32 ``[P, N]`` state carried
across chunks and returned.  The CUDA source is ``csrc/ssd_scan.cu``; its
header says how the design differs from the TPU kernel (one block per
``(b, h)`` with the loop over chunks inside it and the state in shared
memory; 64-row query and key tiles within a chunk, key tiles above the
diagonal skipped; a warp-shuffle prefix sum instead of the triangular-ones
matmul; B and C read by group index, never repeated to heads in device
memory; ragged S masked in the kernel; fp32 FMA throughout).

What bounds it on this card: at the serve shape (B=8, S=2048, H=64, P=64,
N=128, chunk 256) the scan moves about 0.30 GB for about 8.6e10 flop, so its
roofline bound is set by bytes; this first body multiplies on the CUDA cores
in fp32, and the FMA rate is what holds it back.

The wrapper decides by the tensor's device and by nothing else: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.mamba import ssd_scan_prescaled

SUPPORTED_HEAD_DIMS = (16, 32, 64)
SUPPORTED_STATE_SIZES = (16, 32, 64, 128)
MAX_CHUNK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(xbar: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's function in plain PyTorch, in fp32, for any S (the
    last chunk's tail is padded with zero rows after pre-scaling)."""
    return ssd_scan_prescaled(xbar, log_a, B, C, chunk=chunk,
                              init_state=init_state)


def _entry():
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if not fn.argtypes:
        ll, ci, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [vp] * 7 + [ci] * 7 + [ll] * 4 + [ci, vp]
        fn.restype = ci
    return lib, fn


def _groups_dense(t: torch.Tensor) -> bool:
    """Unit stride along N and stride N between groups: batch and row
    strides may be anything (the model hands over views of its projection)."""
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def ssd_scan(xbar: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xbar [B,S,H,P], log_a [B,S,H] fp32, B/C [B,S,G,N], init_state
    [B,H,P,N] fp32 or None -> (y [B,S,H,P] in ``xbar.dtype``, final_state
    [B,H,P,N] fp32).

    CUDA tensors: xbar, B and C float32 or bfloat16 of one type; P in
    (16, 32, 64), N in (16, 32, 64, 128), H a multiple of G,
    1 <= chunk <= 1024, any S >= 1.  B and C are read through their batch and
    row strides; a tensor the kernel cannot read in place is made contiguous
    first.  Anything else raises.  Forward only.
    """
    if not xbar.is_cuda:
        return ssd_scan_plain(xbar, log_a, B, C, chunk=chunk,
                              init_state=init_state)
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
    xbar, log_a = xbar.contiguous(), log_a.contiguous()
    B, C = (t if _groups_dense(t) else t.contiguous() for t in (B, C))
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty_like(xbar, memory_format=torch.contiguous_format)
    state = torch.empty((b, h, p, n), dtype=torch.float32,
                        device=xbar.device)
    lib, fn = _entry()
    with torch.cuda.device(xbar.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(xbar.data_ptr(), log_a.data_ptr(), B.data_ptr(),
                  C.data_ptr(),
                  init_state.data_ptr() if init_state is not None else None,
                  y.data_ptr(), state.data_ptr(), b, s, h, g, p, n, chunk,
                  B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                  _DTYPE_CODE[xbar.dtype], stream)
    _build.check(lib, code, "ssd_scan launch", "repro_ssd_scan_error_string")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
