"""Spans and counters inside the port, recorded only while a torch profiler
records.

The switch is the profiler itself (``torch.profiler.profile`` or the
autograd profiler): there is no flag and no environment variable.  With no
profiler running, :func:`span` is one boolean test and a shared null
context, :func:`count` and :func:`record` one test and a return: no
``record_function`` dispatch, no CUDA event, no allocation.

While a profiler records, a span is three things at once:

* a ``record_function`` range, which lands in the profiler's trace on the
  clock of the device's kernels (so a trace's idle gaps can be named by the
  program's spans);
* a pair of CUDA events on the current stream for its device seconds, once
  CUDA is initialised; they are resolved when read, never by a synchronise
  on the hot path;
* the host's ``perf_counter_ns`` at its two ends.

Its parent is the innermost span open on the same thread.  A thread with no
span open (autograd's engine thread on the card) takes the innermost open
span entered with ``adopt=True`` (the train step's ``train.backward``).
Parents are paths (``train.backward/mamba.ssd``), so a recompute under remat
is told apart from the forward.  Per-request spans carry a request id;
:func:`record` adds one whose host times were taken elsewhere (the serve
engine's queue wait, which starts at ``submit()``).

Closed spans are folded into totals by ``(name, parent)`` as soon as their
events have completed, so memory stays bounded over a long run; the last
:data:`RECENT` closed spans are kept whole (:func:`spans`).  Totals are
those since :func:`reset`: a benchmark that runs the profiler only around
its window reads the window's.

    with torch.profiler.profile(activities=[...]):
        ...                                   # the program's work
    print(tracing.report())                   # device and self time by span
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

RECENT = 4096          # closed spans kept whole, newest last
# Closed spans waiting on their events: past this many, each span closed
# folds up to _FOLD_STEP of the oldest (host time a span costs only in a
# run longer than this; a benchmark's window reads its events at the end).
_FOLD_AT = 32768
_FOLD_STEP = 4
_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler records now (the recorder's only switch)."""
    return _profiler._is_profiler_enabled


@dataclasses.dataclass
class Total:
    """What one ``(name, parent)`` summed to: spans' calls and seconds, or
    a counter's calls and sum (``value``)."""
    calls: int = 0
    host_s: float = 0.0
    device_s: Optional[float] = None     # None: no span had device events
    value: int = 0


@dataclasses.dataclass(frozen=True)
class Span:
    """A closed span as :func:`spans` gives it (host ns)."""
    name: str
    parent: Optional[str]
    rid: Optional[int]
    start_ns: int
    end_ns: int


class _Open:
    """A span: its own context manager, opened and closed by the recorder."""
    __slots__ = ("name", "rid", "adopt", "parent", "path", "prev", "rf",
                 "stream", "ev0", "t0")

    def __init__(self, name: str, rid: Optional[int], adopt: bool):
        self.name, self.rid, self.adopt = name, rid, adopt

    def __enter__(self):
        _REC.begin(self)
        return self

    def __exit__(self, *exc):
        _REC.end(self)
        return False


class Recorder:
    """Open spans by thread, closed spans waiting on their events, and the
    totals folded from them.  Closing a span appends to lists (atomic under
    the interpreter's lock); folding, counting and reading take ``_lock``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._adopt: Optional[str] = None
        # (name, parent, host_s, start event or None, end event or None)
        self._pending: List[Tuple] = []
        self._totals: Dict[Tuple[str, Optional[str]], Total] = {}
        self._counters: Dict[Tuple[str, Optional[str]], Total] = {}
        # (name, parent, rid, start_ns, end_ns)
        self._recent: collections.deque = collections.deque(maxlen=RECENT)
        self._pool: List = []               # idle CUDA events
        self._streams: Dict[Tuple, torch.cuda.Stream] = {}

    # -- spans ----------------------------------------------------------
    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _parent(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1].path if stack else self._adopt

    def _stream(self) -> torch.cuda.Stream:
        """The current CUDA stream, without ``torch.cuda.current_stream``'s
        cost (a new ``Stream`` object a call)."""
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return stream

    def _event(self, stream: torch.cuda.Stream) -> torch.cuda.Event:
        try:
            ev = self._pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def begin(self, s: _Open) -> None:
        s.parent = self._parent()
        s.path = s.name if s.parent is None else f"{s.parent}/{s.name}"
        s.rf = _profiler.record_function(s.name)
        s.rf.__enter__()
        s.stream = s.ev0 = None
        if torch.cuda.is_initialized():
            s.stream = self._stream()
            s.ev0 = self._event(s.stream)
        if s.adopt:
            s.prev, self._adopt = self._adopt, s.path
        self._stack().append(s)
        s.t0 = time.perf_counter_ns()

    def end(self, s: _Open) -> None:
        t1 = time.perf_counter_ns()
        ev1 = self._event(s.stream) if s.stream is not None else None
        s.rf.__exit__(None, None, None)
        stack = self._stack()
        if stack[-1] is s:
            stack.pop()
        else:
            stack.remove(s)
        if s.adopt:
            self._adopt = s.prev
        self._pending.append((s.name, s.parent, (t1 - s.t0) * 1e-9, s.ev0,
                              ev1))
        self._recent.append((s.name, s.parent, s.rid, s.t0, t1))
        if len(self._pending) >= _FOLD_AT:
            with self._lock:
                self._fold(limit=_FOLD_STEP)

    def record(self, name: str, start_ns: int, end_ns: int,
               rid: Optional[int] = None) -> None:
        """A host-only span timed elsewhere, with no parent."""
        self._pending.append((name, None, (end_ns - start_ns) * 1e-9, None,
                              None))
        self._recent.append((name, None, rid, start_ns, end_ns))

    def _fold(self, limit: Optional[int] = None) -> None:
        """Fold the closed spans into the totals, oldest first: all of them,
        waiting for their events, or at most ``limit`` whose events have
        completed.  Called with the lock held."""
        done = 0
        for name, parent, host_s, ev0, ev1 in self._pending[:limit]:
            device_s = None
            if ev0 is not None:
                if limit is None:
                    ev1.synchronize()
                elif not ev1.query():
                    break
                device_s = ev0.elapsed_time(ev1) * 1e-3
                if len(self._pool) < RECENT:
                    self._pool += (ev0, ev1)
            t = self._totals.setdefault((name, parent), Total())
            t.calls += 1
            t.host_s += host_s
            if device_s is not None:
                t.device_s = (t.device_s or 0.0) + device_s
            done += 1
        del self._pending[:done]

    # -- counters -------------------------------------------------------
    def count(self, name: str, n: int) -> None:
        key = (name, self._parent())
        with self._lock:
            t = self._counters.setdefault(key, Total())
            t.calls += 1
            t.value += int(n)

    # -- reading --------------------------------------------------------
    def read(self) -> Tuple[Dict, Dict]:
        """Copies of the spans' totals and the counters' (by ``(name,
        parent)``), once every closed span's events have completed."""
        with self._lock:
            self._fold()
            return ({k: dataclasses.replace(v)
                     for k, v in self._totals.items()},
                    {k: dataclasses.replace(v)
                     for k, v in self._counters.items()})

    def spans(self) -> List[Span]:
        return [Span(*t) for t in list(self._recent)]

    def reset(self) -> None:
        with self._lock:
            self._fold()
            self._totals.clear()
            self._counters.clear()
            self._recent.clear()


_REC = Recorder()


def span(name: str, rid: Optional[int] = None, adopt: bool = False):
    """A context manager: the span ``name`` (with request id ``rid``) over
    the block while a profiler records, else nothing.  ``adopt``: spans
    that open on a thread with no span open take this one as parent."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, rid, adopt)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Open(name, None, False):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` under the innermost open span,
    while a profiler records."""
    if _profiler._is_profiler_enabled:
        _REC.count(name, n)


def record(name: str, start_ns: int, end_ns: int,
           rid: Optional[int] = None) -> None:
    """A host-only span from ``start_ns`` to ``end_ns`` (``perf_counter_ns``
    read elsewhere), with no parent, while a profiler records."""
    if _profiler._is_profiler_enabled:
        _REC.record(name, start_ns, end_ns, rid)


def grad_span(name: str, starts: Sequence[torch.Tensor],
              end: torch.Tensor) -> None:
    """In the coming backward, the span ``name`` from the first of
    ``starts``' gradient nodes to run to the start of ``end``'s node, by
    pre-hooks registered now, while a profiler records.  Nothing when
    ``end`` or every start has no gradient node (its closing could not be
    seen)."""
    if not _profiler._is_profiler_enabled:
        return
    nodes = [t.grad_fn for t in starts if t.grad_fn is not None]
    if end.grad_fn is None or not nodes:
        return
    opened: List[_Open] = []

    def first(_grads):
        if not opened and _profiler._is_profiler_enabled:
            opened.append(_Open(name, None, False).__enter__())

    def close(_grads):
        if opened:
            opened.pop().__exit__(None, None, None)

    for node in nodes:
        node.register_prehook(first)
    end.grad_fn.register_prehook(close)


def totals() -> Dict[Tuple[str, Optional[str]], Total]:
    """For each ``(name, parent)``: calls, host seconds, device seconds
    (None without CUDA) and a counter's sum, since :func:`reset`.  Waits
    for the spans' device events."""
    spans_, counters = _REC.read()
    return {**spans_, **counters}


def total(name: str) -> Optional[Total]:
    """The totals of ``name`` summed over its parents (None when it was
    never recorded); ``device_s`` is None when none of them has device
    seconds."""
    hits = [t for (n, _), t in totals().items() if n == name]
    if not hits:
        return None
    device = [t.device_s for t in hits if t.device_s is not None]
    return Total(calls=sum(t.calls for t in hits),
                 host_s=sum(t.host_s for t in hits),
                 device_s=sum(device) if device else None,
                 value=sum(t.value for t in hits))


def spans() -> List[Span]:
    """The last :data:`RECENT` closed spans, oldest first."""
    return _REC.spans()


def reset() -> None:
    """Forget every total, counter and kept span (open spans stay open)."""
    _REC.reset()


def report() -> str:
    """A table of the spans by path: calls, host seconds, device seconds
    and device self seconds (its device seconds less those of its
    children), then the counters."""
    def path(key: Tuple[str, Optional[str]]) -> str:
        return key[0] if key[1] is None else f"{key[1]}/{key[0]}"

    by_key, counted = _REC.read()
    spans_ = {path(k): t for k, t in by_key.items()}
    counters = sorted((path(k), t) for k, t in counted.items())
    child = collections.defaultdict(float)
    for p, t in spans_.items():
        if "/" in p and t.device_s is not None:
            child[p.rsplit("/", 1)[0]] += t.device_s

    def fmt(x: Optional[float]) -> str:
        return "-" if x is None else f"{x:.6f}"

    rows = [f"{'span':<48} {'calls':>8} {'host_s':>12} {'device_s':>12} "
            f"{'self_s':>12}"]
    for p in sorted(spans_):
        t = spans_[p]
        self_s = None if t.device_s is None else t.device_s - child[p]
        rows.append(f"{p:<48} {t.calls:>8} {t.host_s:>12.6f} "
                    f"{fmt(t.device_s):>12} {fmt(self_s):>12}")
    for p, t in counters:
        rows.append(f"{p:<48} {t.calls:>8} {'count':>12} {t.value:>12}")
    return "\n".join(rows)
