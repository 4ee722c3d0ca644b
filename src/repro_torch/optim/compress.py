"""Gradient compression with error feedback (counterpart of
``repro.optim.compress``).

Two schemes besides ``"none"``: a bf16 round trip (halves the reduction's
payload, no state), and int8 per-tensor affine quantization with **error
feedback** (quarters it; the residual re-injects the quantization error at
the next step).  The collective itself is the sharding plan's; these helpers
transform the payload around it.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_pick


class EFState(NamedTuple):
    residual: Any           # same tree as the gradients, fp32


def init_error_feedback(grads_like: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads: Any, ef: EFState, scheme: str = "int8_ef"
                   ) -> Tuple[Any, EFState]:
    """Returns (compressed-then-decompressed gradients, new EF state).
    scheme: ``"none"`` | ``"bf16"`` | ``"int8_ef"``."""
    if scheme == "none":
        return grads, ef
    if scheme == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype),
                        grads), ef
    if scheme != "int8_ef":
        raise ValueError(f"unknown compression scheme {scheme!r}")

    def one(g, r):
        g32 = g.to(torch.float32) + r
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(one, grads, ef.residual)
    return tree_pick(pairs, 0), EFState(tree_pick(pairs, 1))


def payload_bytes(grads: Any, scheme: str) -> float:
    """What the wire sees: the cost model's collective term."""
    total = sum(g.numel() for g in tree_leaves(grads))
    per = {"none": 4.0, "bf16": 2.0, "int8_ef": 1.0}[scheme]
    return total * per
