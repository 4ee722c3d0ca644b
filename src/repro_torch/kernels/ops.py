"""Public wrappers around the hand-written kernels (the counterpart of
``repro.kernels.ops``).

Each wrapper dispatches on the device of the tensor it is given: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the kernel's plain
PyTorch version.  Each kernel's wrapper counts its launches; the backward
kernels of flash attention and of the SSD scan count theirs apart
(``flash_attention_bwd``, ``ssd_scan_bwd``), as do the causal conv's
(``causal_conv_bwd``).  Flash attention, the SSD scan, the causal conv and
the matmul epilogue are differentiable through their autograd Functions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import causal_conv as _cc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul_epilogue as _mme
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import tsmm as _tsmm

_WRAPPERS = {"flash_attention": _fa.flash_attention,
             "flash_attention_bwd": _fa.flash_attention_bwd,
             "tsmm_upper": _tsmm.tsmm_upper,
             "ssd_scan": _ssd.ssd_scan,
             "ssd_scan_bwd": _ssd.ssd_scan_bwd,
             "matmul_epilogue": _mme.matmul_epilogue,
             "causal_conv": _cc.causal_conv,
             "causal_conv_bwd": _cc.causal_conv_bwd}


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256, init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan through the hand-written kernel (the models' API).

    x: [B,S,H,P]; dt: [B,S,H]; A_log: [H]; B/C: [B,S,G,N]; D: [H];
    init_state: [B,H,P,N] fp32 or None.  Returns (y [B,S,H,P] in
    ``x.dtype``, final_state [B,H,P,N] fp32).  As the reference's wrapper:
    dt clamped at 1e-6, ``A = -exp(A_log)`` and ``log_a = dt * A`` in fp32,
    ``xbar = x * dt`` and the ``D * x`` residual in ``x.dtype``.  Unlike it,
    the groups of B and C are not repeated to heads (the kernel reads them
    by index) and ``init_state`` is passed on.
    """
    dt32 = dt.to(torch.float32).clamp_min(1e-6)
    log_a = dt32 * -torch.exp(A_log.to(torch.float32))
    xbar = x * dt32[..., None].to(x.dtype)
    y, state = _ssd.ssd_scan(xbar, log_a, B, C, chunk=chunk,
                             init_state=init_state)
    return y + x * D.to(x.dtype)[None, None, :, None], state


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 block's depthwise causal conv, bias and SiLU through the
    hand-written kernel (the models' API), differentiable on both devices.

    x: [B,S,C] (any batch and row strides); w: [W,C], 2 <= W <= 4; b: [C];
    state: [B,W-1,C] or None (zeros); x, w, b and state float32 or bfloat16
    of one type.  Returns (silu(conv + b) [B,S,C], new_state [B,W-1,C]), as
    ``mamba._causal_conv``, with the sum and the SiLU in fp32 and one
    rounding to ``x.dtype``.  Anything else raises, on either device.
    """
    _cc.check(x, w, b, state)
    want = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, b, state))
    return _cc.CausalConvFn.apply(x, w, b, state, want)


# The reference's signature without its block sizes; any m, n and k.
matmul_epilogue = _mme.matmul_epilogue


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def matmul_body_launches() -> Dict[str, int]:
    """Launches of each body of the matmul-epilogue kernel since the last
    reset (they sum to its count in :func:`launch_counts`)."""
    return dict(_mme.matmul_epilogue.body_launches)


def flash_mask_launches() -> Dict[str, Dict[str, int]]:
    """Launches of the flash forward and backward kernels since the last
    reset, by mask: ``causal`` (a causal band, with or without a window) or
    ``not_causal`` (they sum to their counts in :func:`launch_counts`)."""
    return {name: dict(_WRAPPERS[name].mask_launches)
            for name in ("flash_attention", "flash_attention_bwd")}


def flash_window_launches() -> Dict[str, Dict[str, int]]:
    """Launches of the flash forward and backward kernels since the last
    reset, by window: ``"global"`` (no window) or ``"w<window>"`` (they sum
    to their counts in :func:`launch_counts`)."""
    return {name: dict(_WRAPPERS[name].window_launches)
            for name in ("flash_attention", "flash_attention_bwd")}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
        for key in getattr(fn, "mask_launches", {}):
            fn.mask_launches[key] = 0
        getattr(fn, "window_launches", {}).clear()
    for body in _mme.matmul_epilogue.body_launches:
        _mme.matmul_epilogue.body_launches[body] = 0
