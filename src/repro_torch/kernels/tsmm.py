"""tsmm (transpose-self matmul): the hand-written Hopper kernel, its wrapper
and its plain PyTorch version.

Replaces the TPU kernel ``tsmm_upper`` / ``_tsmm_kernel`` of
``src/repro/kernels/tsmm.py``: the upper-triangular tiles of
``G = X^T X + reg * I``, accumulated over ``m`` in fp32, ``reg`` added on the
diagonal before the single write, lower-left tiles left zero.  The CUDA source
is ``csrc/tsmm.cu``; its header says how the design differs from the TPU
kernel (1-D grid over the upper tiles with the loop over ``m`` inside the
block, 128 x 128 tiles, TMA and ``wgmma`` in tf32 with fp32 inputs split in
two (3xTF32: ``PRODUCTS`` products a pair of values, one for bf16), and a
split of ``m`` with a fixed-order second pass because a tall and skinny X
gives far fewer tiles than the card has SMs).

The half product is bound by operations: ``m n (n + 1)`` flop against
``m n`` elements read.

The wrapper decides by the tensor's device and by nothing else: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction

import torch

from repro_torch.kernels import _build

TILE = 128            # output tile edge of the kernel
_MIN_ROWS_PER_SPLIT = 1024
_SMS = 132            # an H100's SMs; the kernel holds one block on each
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# tf32 products the kernel sums for each pair of values: fp32 is split as
# hi + lo and takes lo.hi + hi.lo + hi.hi; bf16 is exact in tf32
PRODUCTS = {torch.float32: 3, torch.bfloat16: 1}


def tsmm_upper_plain(x: torch.Tensor, *, reg: float = 0.0,
                     tile: int = TILE) -> torch.Tensor:
    """Upper-triangular ``tile`` x ``tile`` blocks of ``X^T X + reg * I`` with
    fp32 accumulation; blocks below the diagonal are zero, diagonal blocks are
    whole (they are symmetric in themselves)."""
    n = x.shape[1]
    x32 = x.to(torch.float32)
    g = x32.T @ x32
    if reg != 0.0:
        g = g + reg * torch.eye(n, dtype=torch.float32, device=x.device)
    blk = torch.arange(n, device=x.device) // tile
    keep = blk[:, None] <= blk[None, :]
    return torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device)).to(x.dtype)


def _splits(m: int, n: int) -> int:
    """Slices of ``m`` (at least 1024 rows each): the count whose grid of
    ``tiles x splits`` blocks, one an SM, takes the fewest waves for the rows
    it covers, ``ceil(tiles * s / 132) / s``; the fewest slices on a tie.  A
    count past 132 never does better: ``132 / gcd(tiles, 132)`` already
    fills every wave."""
    nb = -(-n // TILE)
    tiles = nb * (nb + 1) // 2
    by_rows = min(_SMS, max(1, m // _MIN_ROWS_PER_SPLIT))
    return min(range(1, by_rows + 1),
               key=lambda s: (Fraction(-(-tiles * s // _SMS), s), s))


def _entry():
    lib = _build.load("tsmm")
    fn = lib.repro_tsmm_upper
    if not fn.argtypes:
        ci, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ci, ci, ctypes.c_longlong, ctypes.c_float,
                       ci, ci, ci, vp]
        fn.restype = ci
    return lib, fn


def tsmm_upper(x: torch.Tensor, *, reg: float = 0.0) -> torch.Tensor:
    """x: [m, n] -> [n, n] in ``x.dtype``: upper-triangular 128 x 128 tiles of
    ``X^T X + reg * I``, zeros below them.

    CUDA tensors: float32 or bfloat16, ``n % 4 == 0``, any ``m``; ``x`` is
    read through its row stride where TMA can describe it (unit column
    stride, rows 16-byte aligned), else from a copy with rows padded to 16
    bytes.  Anything else raises.
    """
    if x.dim() != 2:
        raise ValueError(f"tsmm_upper: x must be [m, n], got {tuple(x.shape)}")
    if not x.is_cuda:
        return tsmm_upper_plain(x, reg=reg)
    m, n = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"tsmm_upper: float32 or bfloat16, got {x.dtype}")
    if m < 1 or n < 1 or n % 4 != 0:
        raise ValueError(f"tsmm_upper: needs m >= 1 and n % 4 == 0, got "
                         f"{tuple(x.shape)}")
    per16 = 16 // x.element_size()
    if x.stride(1) != 1 or x.stride(0) % per16 or x.data_ptr() % 16:
        padded = torch.empty((m, -(-n // per16) * per16), dtype=x.dtype,
                             device=x.device)
        x = padded[:, :n].copy_(x)
    out = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    splits = _splits(m, n)
    nb = -(-n // TILE)
    workspace = None
    if splits > 1:
        workspace = torch.empty((splits, nb * (nb + 1) // 2, TILE, TILE),
                                dtype=torch.float32, device=x.device)
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), out.data_ptr(),
                  workspace.data_ptr() if workspace is not None else None,
                  m, n, x.stride(0), float(reg), splits,
                  _DTYPE_CODE[x.dtype], PRODUCTS[x.dtype], stream)
    _build.check(lib, code, "tsmm_upper launch", "repro_tsmm_error_string")
    tsmm_upper.launches += 1
    return out


tsmm_upper.launches = 0
