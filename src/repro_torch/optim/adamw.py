"""AdamW on the port's parameter trees, with schedules and global-norm
clipping (counterpart of ``repro.optim.adamw``).

Parameters, gradients and moments are nested dicts (and lists) of tensors,
as the model's parameter tree is.  The update is the reference's ``upd``:
fp32 arithmetic on each leaf, the new parameter cast back to the leaf's type
(bf16 parameters stay bf16, with no fp32 master copy, as in the reference),
moments kept in ``moment_dtype``.  Plain elementwise tensor ops: the
reference's update is plain ``jnp``, not a kernel.  Functional, like the
reference: ``apply`` returns new trees and writes none of its inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.sharded import is_dtensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a tree of nested dicts and lists, in a fixed order
    (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay, in the reference's arithmetic (the
    reference computes it in fp32; this is fp64 on the host)."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return _DTYPES[cfg.moment_dtype]


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    mdt = moment_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def apply(cfg: AdamWConfig, state: AdamWState, grads: Any, params: Any,
          *, donate: bool = False) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """Returns (new_params, new_state, metrics): ``grad_norm`` (a 0-d fp32
    tensor, before clipping) and ``lr`` (a float).  With ``donate`` the new
    values are written into the given leaves of ``params``, ``state.m`` and
    ``state.v`` (the same numbers), and those trees come back: the
    reference's trainer donates both to its jitted step (``TrainerConfig.
    donate``), so that the old and new parameters and moments are never
    held at once."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    mdt = _DTYPES[cfg.moment_dtype]

    def upd(p, g, m, v):
        g32 = g.to(torch.float32) * clip
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g32)
        upd32 = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (upd32 + cfg.weight_decay * p32)
        new = tuple(placed_like(value, old) for value, old in
                    zip((p32.to(p.dtype), m32.to(mdt), v32.to(mdt)),
                        (p, m, v)))
        if not donate:
            return new
        for old, value in zip((p, m, v), new):
            old.copy_(value)
        return p, m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_pick(out, i) for i in range(3))
    return (new_p, AdamWState(step, new_m, new_v),
            {"grad_norm": gnorm, "lr": lr})


def placed_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``value`` (or ``None``) in ``like``'s placements when both are
    ``DTensor``s (else ``value``): the new parameter of a ZeRO-1 update
    comes out in the moments' placements, and DTensor refuses an in-place
    copy that would change ``like``'s."""
    if (value is None or not is_dtensor(like)
            or tuple(value.placements) == tuple(like.placements)):
        return value
    return value.redistribute(like.device_mesh, like.placements)


def tree_pick(tree: Any, i: int) -> Any:
    """Element ``i`` of every tuple at the leaves of ``tree`` (a tree that
    :func:`tree_map` made with a function returning tuples)."""
    if isinstance(tree, dict):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_pick(v, i) for v in tree]
    return tree[i]
