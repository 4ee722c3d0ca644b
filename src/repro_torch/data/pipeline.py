"""Synthetic-corpus data pipeline with a prefetch thread (PyTorch
counterpart of ``repro.data.pipeline``).

``SyntheticLM`` is numpy only and gives the reference's arrays for the same
seed and step.  ``PrefetchIterator`` builds batches in a worker thread and,
given a ``device``, moves each one there (through pinned host memory, with
``non_blocking`` copies on the current stream, so that a batch is ready in
stream order before any later work reads it) in place of the reference's
``sharding``.  ``make_pipeline`` keeps the reference's host split: each
process owns ``global_batch / num_hosts`` rows, seeded by ``seed +
host_index``.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch


class SyntheticLM:
    """Zipf-ish synthetic token stream with a learnable bigram structure:
    ``x_{t+1} = (31 x_0 + drift t) % v`` with 10 % of the tokens noise, so a
    model can lower its loss on it.  ``batch_at(step)`` is a function of the
    seed and the step alone."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0,
                 frontend_shape: Optional[Tuple[int, ...]] = None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.frontend_shape = frontend_shape

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens": [B,S] int32}`` (plus ``"frontend"`` ``[B, ...]``
        float32 when a frontend shape is given)."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        b, s, v = self.batch, self.seq_len, self.vocab_size
        x0 = rng.integers(0, v, size=(b, 1))
        a = 31
        drift = rng.integers(0, 7, size=(b, 1))
        t = np.arange(s)[None, :]
        base = (x0 * pow(a, 1, v) + drift * t) % v
        noise = rng.integers(0, v, size=(b, s))
        use_noise = rng.random((b, s)) < 0.1
        out = {"tokens": np.where(use_noise, noise, base).astype(np.int32)}
        if self.frontend_shape is not None:
            out["frontend"] = rng.standard_normal(
                (b,) + tuple(self.frontend_shape[1:]), dtype=np.float32)
        return out


def _to_device(batch: Dict[str, np.ndarray],
              device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: for a CUDA device each array
    is pinned and copied with ``non_blocking`` on the current stream."""
    device = torch.device(device)
    out = {}
    for key, arr in batch.items():
        t = torch.from_numpy(arr)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out


class PrefetchIterator:
    """Background-thread prefetch of batches, in step order: yields
    ``(step, batch)``, the batch numpy arrays or, given ``device``, tensors
    there."""

    def __init__(self, source: SyntheticLM, *, start_step: int = 0,
                 prefetch: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self.source = source
        self.device = device
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self.source.batch_at(step)
                if self.device is not None:
                    batch = _to_device(batch, self.device)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
                batch = None
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def make_pipeline(vocab_size: int, seq_len: int, global_batch: int, *,
                  host_index: int = 0, num_hosts: int = 1, seed: int = 0,
                  frontend_shape=None, prefetch: int = 2,
                  device: Optional[Union[str, torch.device]] = None,
                  start_step: int = 0) -> PrefetchIterator:
    """This host's share of the stream: ``global_batch / num_hosts`` rows
    (at least one), seeded by ``seed + host_index``."""
    local_batch = max(global_batch // num_hosts, 1)
    src = SyntheticLM(vocab_size, seq_len, local_batch,
                      seed=seed + host_index, frontend_shape=frontend_shape)
    return PrefetchIterator(src, prefetch=prefetch, device=device,
                            start_step=start_step)
