"""Batched serving engine: continuous batching around a submit()/step() core.

PyTorch counterpart of ``repro.runtime.serve_engine``, same schedule and same
bookkeeping: a pool of decode *slots* advances in lockstep one token per
:meth:`ServeEngine.step`, and an *admission round* refills free slots from
the submission queue by prefilling the newcomers.  Static batching is the
degenerate schedule: every request admitted in one round, zero refills.

Bookkeeping is per-request: a finished slot still occupies its batch lane
until the next admission compacts it away, but its sampled tokens are masked
out of the accounting (``stats["wasted_slot_steps"]`` counts the padding
decodes) and each completion reports *its own* decode seconds.

Admission re-prefills the full token history of every surviving slot
alongside the newcomers (prefill/decode equivalence makes the greedy
continuation exact).  Histories are left-padded with token 0 to the longest
one and there is no padding mask, exactly as in the reference: the token
streams of the two engines are compared.  A vision stub's patches are
prepended before the padding, so the padding sits between them and the
text, as in the reference.

Frontend features (patch or frame embeddings ``[B,F,d]``, one row a
request in admission order) are single-admission only, as in the
reference: they go to the first admission round's prefill, and a later
round that is given them raises ``NotImplementedError``.

On a CUDA model the prefill takes the hand-written kernels
(``use_kernel=True``: flash attention for the self-attention layers, an
encoder's among them, the SSD scan for the Mamba2 layers, the
matmul-epilogue kernel for the gated MLPs and the head); on a CPU model it
takes the plain path.  ``prefill_time_s`` and ``decode_time_s`` are
execution times, not launch times: on the card a pair of CUDA events around
the work, read once the sampled tokens' copy to the host has waited for the
device (no synchronise of its own); on the CPU the host clock.

While a torch profiler records, the engine adds spans and counters to
:mod:`repro_torch.tracing`: ``serve.admit`` (with ``serve.init_cache``,
``serve.prefill`` and ``serve.sample`` in it) and ``serve.decode``; per
request ``serve.queued`` (``submit()`` to the start of the round that admits
it) and ``serve.request`` (``submit()`` to the end of the ``step()`` that
commits its first token), host times with the rid; the counters
``serve.prefill_positions`` (rows x padded length) and
``serve.prompt_positions`` (the real history tokens).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    prompt: List[int]
    tokens: List[int]
    prefill_time_s: float     # this request's admission-round prefill
    decode_time_s: float      # decode seconds while THIS request was live
    rid: int = -1             # submit() ticket this completion answers


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine policy knobs, separated from the model/params payload.

    ``batching="static"`` admits every queued request in a single round
    (the degenerate continuous-batching schedule); ``"continuous"`` caps
    concurrency at ``slots`` and refills free slots between decode steps.
    ``slots=None`` sizes the pool to whatever is queued at first step."""

    max_len: int = 256
    temperature: float = 0.0
    seed: int = 0
    capacity_factor: Optional[float] = None
    batching: str = "static"          # "static" | "continuous"
    slots: Optional[int] = None

    def __post_init__(self):
        if self.batching not in ("static", "continuous"):
            raise ValueError(f"unknown batching policy {self.batching!r}")
        if self.slots is not None and self.slots < 1:
            raise ValueError("slots must be >= 1")


@dataclasses.dataclass
class _Slot:
    """One live request's lane: emitted tokens plus its pending next token
    (sampled but not yet committed — prefill logits seed the first one)."""

    request: Request
    rid: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    pending: int = 0
    done: bool = False
    prefill_s: float = 0.0
    decode_s: float = 0.0
    t_submit: int = 0         # perf_counter_ns at submit()
    t_admit: int = 0          # perf_counter_ns at its admission round


class ServeEngine:
    def __init__(self, model: Model, params: Any,
                 config: Optional[EngineConfig] = None, *,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, capacity_factor: Optional[float] = None,
                 use_kernel: Optional[bool] = None):
        if config is None:
            config = EngineConfig(max_len=max_len, temperature=temperature,
                                  seed=seed, capacity_factor=capacity_factor)
        self.model = model
        self.params = params
        self.config = config
        self.device = model.device
        # The kernel path whenever the tensors are on the card; a caller may
        # switch it off to hold the two paths against each other.
        self.use_kernel = (self.device.type == "cuda"
                           if use_kernel is None else use_kernel)
        # Legacy attribute surface (pre-EngineConfig callers read these).
        self.max_len = config.max_len
        self.temperature = config.temperature
        self.capacity_factor = config.capacity_factor
        self._rng = self._new_rng()
        self._queue: List[_Slot] = []
        self._active: List[_Slot] = []
        self._cache: Any = None
        self._next_rid = 0
        self.stats: Dict[str, int] = {"decode_steps": 0,
                                      "admission_rounds": 0,
                                      "wasted_slot_steps": 0}

    # -- submission ------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue one request; it joins the pool at the next admission
        round.  Returns the request id completions are matched by."""
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Slot(request, rid,
                                 t_submit=time.perf_counter_ns()))
        return rid

    @property
    def pending_requests(self) -> int:
        return len(self._queue) + sum(1 for s in self._active if not s.done)

    # -- internals -------------------------------------------------------
    def _new_rng(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.config.seed)

    def _mark(self):
        """A point in the device's queue: a recorded CUDA event on the card,
        the host clock elsewhere."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    @staticmethod
    def _seconds(t0, t1) -> float:
        """Seconds between two :meth:`_mark` s; CUDA events only once the
        host has waited for the later one (a copy to the host after it)."""
        if isinstance(t0, float):
            return t1 - t0
        return t0.elapsed_time(t1) * 1e-3

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy at temperature 0; else a draw from the engine's seeded
        generator (same tokens for the same seed, not the reference's).
        The tokens stay on the device."""
        if self.config.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.config.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._rng)[:, 0]

    @staticmethod
    def _to_host(tok: torch.Tensor) -> np.ndarray:
        return tok.to("cpu", torch.int32).numpy()

    def _slot_budget(self) -> int:
        if self.config.batching == "static" or self.config.slots is None:
            return len(self._active) + len(self._queue)
        return self.config.slots

    @torch.no_grad()
    def _admit(self, frontend: Optional[torch.Tensor] = None) -> None:
        """Admission round: compact finished slots out of the pool, admit
        queued requests into the freed lanes, and prefill the new batch's
        full histories (survivors continue exactly — prefill/decode
        equivalence)."""
        t_round = time.perf_counter_ns()
        survivors = [s for s in self._active if not s.done]
        free = self._slot_budget() - len(survivors)
        admitted = self._queue[:max(free, 0)]
        self._queue = self._queue[len(admitted):]
        batch = survivors + admitted
        self._active = batch
        if not batch:
            self._cache = None
            return
        self.stats["admission_rounds"] += 1
        for s in admitted:
            s.t_admit = t_round
        hists = [list(s.request.prompt) + s.tokens for s in batch]
        plen = max(len(h) for h in hists)
        tracing.count("serve.prefill_positions", len(batch) * plen)
        tracing.count("serve.prompt_positions", sum(len(h) for h in hists))
        prompts = np.zeros((len(batch), plen), np.int64)
        for i, h in enumerate(hists):               # left-pad
            prompts[i, plen - len(h):] = h
        with tracing.span("serve.init_cache"):
            cache = self.model.init_cache(len(batch), self.config.max_len)
        tokens = torch.from_numpy(prompts).to(self.device)
        with tracing.span("serve.prefill"):
            t0 = self._mark()
            logits, self._cache = self.model.prefill(
                self.params, tokens, cache, frontend,
                use_kernel=self.use_kernel)
            t1 = self._mark()
        with tracing.span("serve.sample"):
            tok = self._to_host(self._sample(logits))
        dt = self._seconds(t0, t1)
        new_rids = {s.rid for s in admitted}
        for i, s in enumerate(batch):
            s.pending = int(tok[i])
            if s.rid in new_rids:
                s.prefill_s += dt

    def _commit(self, slot: _Slot) -> None:
        """Move the pending token into the transcript and update the stop
        conditions (eos is included in the output)."""
        r = slot.request
        slot.tokens.append(slot.pending)
        if len(slot.tokens) >= r.max_new_tokens:
            slot.done = True
        if r.eos_id is not None and slot.tokens[-1] == r.eos_id:
            slot.done = True

    def _completion(self, slot: _Slot) -> Completion:
        return Completion(slot.request.prompt, list(slot.tokens),
                          slot.prefill_s, slot.decode_s, rid=slot.rid)

    # -- the continuous-batching core ------------------------------------
    def step(self, frontend: Optional[torch.Tensor] = None
             ) -> List[Completion]:
        """Advance the pool one schedule tick: admit if lanes free up,
        commit each live slot's pending token, decode one token for the
        still-running slots.  Returns the requests that finished."""
        firsts: List[_Slot] = []
        finished = self._step(frontend, firsts)
        if firsts and tracing.recording():
            t = time.perf_counter_ns()
            for s in firsts:
                tracing.record("serve.queued", s.t_submit, s.t_admit, s.rid)
                tracing.record("serve.request", s.t_submit, t, s.rid)
        return finished

    @torch.no_grad()
    def _step(self, frontend: Optional[torch.Tensor],
              firsts: List[_Slot]) -> List[Completion]:
        """:meth:`step`; the slots whose first token it commits go into
        ``firsts``."""
        if self._queue and (self._cache is None
                            or any(s.done for s in self._active)
                            or len(self._active) < self._slot_budget()):
            if frontend is not None and self._active:
                raise NotImplementedError(
                    "frontend features are single-admission only: submit "
                    "all requests before the first step")
            with tracing.span("serve.admit"):
                self._admit(frontend)
        finished: List[Completion] = []
        if not self._active:
            return finished
        for s in self._active:
            if not s.done:
                self._commit(s)
                if len(s.tokens) == 1:
                    firsts.append(s)
                if s.done:
                    finished.append(self._completion(s))
        live = [s for s in self._active if not s.done]
        if not live:
            self._active = []
            self._cache = None
            return finished
        # One lockstep decode over the whole batch; finished lanes ride
        # along as padding until the next admission compacts them, and
        # their samples are masked out of the accounting below.
        with tracing.span("serve.decode"):
            tok = torch.tensor([s.pending for s in self._active],
                               dtype=torch.int64, device=self.device)
            t0 = self._mark()
            logits, self._cache = self.model.decode_step(
                self.params, tok, self._cache, use_kernel=self.use_kernel)
            nxt = self._sample(logits)
            t1 = self._mark()
            nxt = self._to_host(nxt)
        dt = self._seconds(t0, t1)
        self.stats["decode_steps"] += 1
        self.stats["wasted_slot_steps"] += len(self._active) - len(live)
        for i, s in enumerate(self._active):
            if not s.done:
                s.pending = int(nxt[i])
                s.decode_s += dt
        return finished

    def run(self, frontend: Optional[torch.Tensor] = None
            ) -> List[Completion]:
        """Drain the queue and pool to completion (submission order)."""
        done: List[Completion] = []
        first = True
        while self.pending_requests:
            done.extend(self.step(frontend if first else None))
            first = False
        return sorted(done, key=lambda c: c.rid)

    # -- batch convenience (the original surface) ------------------------
    def generate(self, requests: Sequence[Request],
                 frontend: Optional[torch.Tensor] = None
                 ) -> List[Completion]:
        """Serve one batch of requests to completion.

        A fresh start: live state and the sampling stream reset to the
        seed, so identical request lists reproduce identical outputs."""
        self._queue, self._active, self._cache = [], [], None
        self._rng = self._new_rng()
        rids = [self.submit(r) for r in requests]
        by_rid = {c.rid: c for c in self.run(frontend)}
        return [by_rid[rid] for rid in rids]
