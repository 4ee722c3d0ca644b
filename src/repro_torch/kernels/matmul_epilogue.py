"""Matrix product with a fused epilogue: the hand-written Hopper kernel, its
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``matmul_epilogue`` / ``_mm_epi_kernel`` (epilogue
``_epilogue_f32``) of ``src/repro/kernels/matmul_epilogue.py``:
``epilogue(x @ w)`` with the product accumulated in fp32, the epilogue (bias,
silu, gelu in its tanh form, or an affine-free layernorm over the full row)
applied in fp32 before the single write, and the result cast to
``out_dtype`` on that write (cast sinking: bf16 operands, fp32 logits).  The
CUDA source is ``csrc/matmul_epilogue.cu``; its header says how the design
differs from the TPU kernel (the K loop inside the block with the
accumulator in registers; ``mma.sync`` for bf16 and full-fp32 FMA for fp32;
ragged M, N and K masked in the kernel; x and w read through their strides;
layernorm rows kept whole in shared memory).

What bounds it on this card: the MLP gate at a prefill shape (M = 16384,
K = 2560, N = 10240, bf16) is bound by operations; the serving head and every
decode-step product (M = 8) by the bytes of w.

The wrapper decides by the tensor's device and by nothing else: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

EPILOGUES = (None, "bias", "silu", "gelu", "layernorm")
LN_EPS = 1e-6
# Layernorm keeps 16 fp32 rows of the full width in one block's shared memory.
LN_MAX_N = 3072
_EPILOGUE_CODE = {None: 0, "bias": 1, "silu": 2, "gelu": 3, "layernorm": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
        fn.argtypes = [vp] * 4 + [ci] * 3 + [ll] * 4 + [ci] * 4 + [vp]
        fn.restype = ci
    return lib, fn


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


def matmul_epilogue(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    epilogue: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [m, k], w: [k, n], bias: [n] (iff ``epilogue == "bias"``) ->
    ``epilogue(x @ w)`` as a contiguous [m, n] tensor in ``out_dtype``
    (default ``x.dtype``).

    CUDA tensors: x and w float32 or bfloat16 of one type, bias float32 or
    bfloat16, ``out_dtype`` float32 or bfloat16; any m, n and k; x and w are
    read in place through their strides (a transposed w too), never copied.
    The layernorm epilogue normalises whole rows of at most
    ``LN_MAX_N = 3072`` columns.  Anything else raises.  Forward only.
    """
    _check_args(x, w, bias, epilogue)
    if not x.is_cuda:
        return matmul_epilogue_plain(x, w, bias, epilogue=epilogue,
                                     out_dtype=out_dtype)
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
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), m, n, k, x.stride(0), x.stride(1),
                  w.stride(0), w.stride(1), _EPILOGUE_CODE[epilogue],
                  _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
                  _DTYPE_CODE[bias.dtype] if bias is not None else 0, stream)
    _build.check(lib, code, "matmul_epilogue launch",
                 "repro_matmul_epilogue_error_string")
    matmul_epilogue.launches += 1
    return out


matmul_epilogue.launches = 0
