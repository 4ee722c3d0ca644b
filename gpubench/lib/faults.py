"""Faults planted under the timed path, to show that the comparison catches
them: the benchmark's own runs never plant one.

* ``unchanged``: the train step computes its loss and returns the weights
  and the optimizer state as they were;
* ``half_batch``: the train step drops the second half of each batch's
  rows (its loss and gradients are the mean over the rest);
* ``token``: the engine's sampler returns the next token id (mod the
  vocabulary) in place of the one it picked.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "token")


@contextlib.contextmanager
def planted(name):
    """Plant fault ``name`` (None: none) while the block runs."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; faults: {FAULTS}")
    if name == "token":
        from repro_torch.runtime import serve_engine as se
        real = se.ServeEngine._sample

        def altered(self, logits):
            return (real(self, logits) + 1) % logits.shape[-1]
        se.ServeEngine._sample = altered
        try:
            yield
        finally:
            se.ServeEngine._sample = real
        return
    from repro_torch.runtime import train_loop as tl
    real_make = tl.make_train_step

    def make(model, opt_cfg, plan, **kw):
        step = real_make(model, opt_cfg, plan, **kw)

        def faulty(params, opt_state, ef_state, batch):
            if name == "half_batch":
                half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
                return step(params, opt_state, ef_state, half)
            with torch.no_grad():
                loss, metrics = model.loss(params, batch, remat=plan.remat,
                                           use_kernel=kw.get("use_kernel",
                                                             False))
            return params, opt_state, ef_state, {"loss": loss.detach(),
                                                 **metrics}
        return faulty
    tl.make_train_step = make
    try:
        yield
    finally:
        tl.make_train_step = real_make
