"""Public wrappers around the hand-written kernels (the counterpart of
``repro.kernels.ops``).

Each wrapper dispatches on the device of the tensor it is given: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the kernel's plain
PyTorch version.  Each kernel's wrapper counts its launches.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import tsmm as _tsmm

_WRAPPERS = {"flash_attention": _fa.flash_attention,
             "tsmm_upper": _tsmm.tsmm_upper}


def tsmm(x: torch.Tensor, *, reg: float = 0.0) -> torch.Tensor:
    """Symmetric Gram matrix ``X^T X + reg * I`` via the half-compute kernel.

    The kernel writes only upper-triangular tiles; the strict lower triangle
    is mirrored here (diagonal tiles are symmetric in themselves).  ``reg`` is
    the ridge shift of the LinReg DS solve, added inside the kernel.
    """
    up = _tsmm.tsmm_upper(x, reg=reg)
    return torch.triu(up) + torch.triu(up, 1).T


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
