"""Training runtime: the train step factory (counterpart of
``repro.runtime.train_loop.make_train_step``).

``make_train_step`` assembles the step that the plan's decision vector
describes: the remat policy, microbatch accumulation, gradient compression
and AdamW.  PyTorch runs it eagerly, one kernel after another, where the
reference compiles it into one program; the arithmetic is the reference's.
On one card only the plan's ``remat`` and ``microbatches`` are read.
``Trainer`` and ``OnlineRecalibrator`` are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.planner import ShardingPlan
from repro_torch.models.model import Model
from repro_torch.optim import adamw, compress
from repro_torch.optim.adamw import tree_leaves, tree_map


def value_and_grad(model: Model, params: Any, batch: Dict[str, torch.Tensor],
                   *, remat: str = "none", use_kernel: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the gradient
    of every leaf of the tree, by ``torch.autograd.grad`` over the leaves
    (detached aliases that require a gradient, so no ``.grad`` field is
    written and ``params`` is left as it is).  A leaf the loss does not
    reach gets ``None``."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch, remat=remat,
                                   use_kernel=use_kernel)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                         allow_unused=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), live))


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    plan: ShardingPlan, *, compress_scheme: str = "none",
                    use_kernel: bool = False,
                    donate: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics)``, a function of its arguments: new trees
    come back, the given ones are not written.  With ``donate`` the given
    params and opt_state are updated in place and come back as the new ones
    (the same numbers; the reference's trainer donates them to its jitted
    step): the step then never holds two copies of the weights and the fp32
    moments.

    With ``plan.microbatches`` > 1 the batch is split along its first axis
    and the gradients are summed in fp32, each divided by the count, as the
    reference's ``lax.scan`` does; no per-microbatch metrics come back.  A
    leaf the loss does not reach gets a zero gradient, as under
    ``jax.grad``.  metrics: ``loss``, ``grad_norm``, ``lr`` and, with one
    microbatch, ``ce`` and ``aux``."""
    micro = max(plan.microbatches, 1)

    def grads_of(params, batch):
        loss, metrics, grads = value_and_grad(
            model, params, batch, remat=plan.remat, use_kernel=use_kernel)
        grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                         grads, params)
        return loss, metrics, grads

    def train_step(params, opt_state, ef_state, batch):
        if micro > 1:
            parts = {k: v.chunk(micro, dim=0) for k, v in batch.items()}
            if any(len(v) != micro or v[0].shape[0] * micro != t.shape[0]
                   for v, t in zip(parts.values(), batch.values())):
                raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} "
                                 f"does not split into {micro} microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(micro):
                l_i, _, g_i = grads_of(params, {k: v[i]
                                                for k, v in parts.items()})
                grads = tree_map(
                    lambda a, g: a.add_(g.to(torch.float32) / micro),
                    grads, g_i)
                loss = loss + l_i / micro
            metrics: Dict[str, Any] = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        grads, ef_state = compress.compress_grads(grads, ef_state,
                                                  compress_scheme)
        new_params, new_opt, opt_metrics = adamw.apply(opt_cfg, opt_state,
                                                       grads, params,
                                                       donate=donate)
        return new_params, new_opt, ef_state, {"loss": loss, **opt_metrics,
                                               **metrics}

    return train_step
