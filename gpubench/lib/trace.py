"""The traced window: ``torch.profiler`` over the whole measured window, and
its reduction to device busy time, time by kernel, kernel classes and the
longest idle gaps, each gap labelled by what the host was doing.

The method is the repo's profiling tools' (CPU and CUDA activities, device
time by kernel name), read from the raw kineto events so that each
kernel's interval is known: the busy time is the union of the device's
intervals (kernels, copies, sets), not their sum.

Kernel classes are rules on the kernel's name, written here:

* the SSD scan's kernels: a name holding ``ssd_``, or the backward's two
  fixed-order sums ``sum_cast_bf16`` and ``sum_slices_f32``;
* flash attention's: a name holding ``flash_``, or the backward's
  ``sum_dq_tiles`` and ``cast_dq_bf16``;
* the matmul epilogue's and tsmm's: ``mm_epi``, ``mm_ln``, ``mm_small_m``,
  ``tsmm``;
* library products (cuBLAS, CUTLASS): ``gemm``, ``nvjet``, ``xmma``,
  ``cutlass``, ``cublas``, ``splitKreduce``;
* everything else is elementwise work (casts, norms, activations,
  reductions, copies done by kernels, the optimizer).

A rule that matches no kernel leaves its metric out (``None``): a renamed
kernel is a missing reading, never a share of 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

SSD_RE = re.compile(r"ssd_|sum_cast_bf16|sum_slices_f32")
FLASH_RE = re.compile(r"flash_|sum_dq_tiles|cast_dq_bf16")
HAND_RE = re.compile(r"ssd_|sum_cast_bf16|sum_slices_f32|flash_|sum_dq_tiles"
                     r"|cast_dq_bf16|mm_epi|mm_ln|mm_small_m|tsmm")
GEMM_RE = re.compile(r"gemm|nvjet|xmma|cutlass|cublas|splitKreduce",
                     re.IGNORECASE)
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float                       # the traced window's length
    busy_s: float                         # union of device intervals
    kernels: Dict[str, Tuple[float, int]]  # name -> (seconds, launches)
    gaps: List[Tuple[str, float]]         # longest idle gaps, labelled

    def seconds(self, pattern: "re.Pattern") -> Optional[float]:
        """Device seconds of the kernels whose name matches (None when no
        kernel matches)."""
        hits = [s for name, (s, _) in self.kernels.items()
                if pattern.search(name)]
        return sum(hits) if hits else None

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [(short(name), s) for name, (s, _) in rows[:k]]


@contextlib.contextmanager
def traced(enabled: bool):
    """A profiler over the block when ``enabled`` (else nothing); yields the
    profiler or None.  The block must run its window inside
    :func:`window_span`."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def window_span():
    from torch.profiler import record_function
    return record_function(WINDOW_SPAN)


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its return type, cut to ``width``."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _label(t0: int, t1: int, spans: List[Tuple[int, int, str, bool]]) -> str:
    """What the host ran over the gap [t0, t1]: the innermost benchmark span
    and the innermost op that covers the gap's middle."""
    mid = (t0 + t1) // 2
    best_ann, best_op = None, None
    for s, e, name, ann in spans:
        if s <= mid <= e:
            if ann and name != WINDOW_SPAN:
                if best_ann is None or e - s < best_ann[0]:
                    best_ann = (e - s, name)
            elif not ann:
                if best_op is None or e - s < best_op[0]:
                    best_op = (e - s, name)
    parts = [x[1] for x in (best_ann, best_op) if x is not None]
    return " > ".join(parts) if parts else "host idle or outside any op"


def _ns(e, name: str) -> int:
    """An event's start or duration in ns (older kineto bindings give µs)."""
    fn = getattr(e, f"{name}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{name}_us")()
                                                * 1000)


def _is_annotation(e) -> bool:
    fn = getattr(e, "is_user_annotation", None)
    return bool(fn()) if fn is not None else e.name().startswith("bench.")


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce(prof, n_gaps: int = 10) -> TraceSummary:
    """Reduce a profile whose window ran inside :func:`window_span`.  Device
    events are the CUDA activities but the annotations' device-side
    copies; host events are the CPU ops and annotations."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    win = None
    device: List[Tuple[int, int, str, str]] = []
    host: List[Tuple[int, int, str, bool]] = []
    for e in events:
        name = e.name()
        start, dur = _ns(e, "start"), _ns(e, "duration")
        ann = _is_annotation(e) or name.startswith("bench.")
        if e.device_type() == DeviceType.CUDA:
            if not ann:
                device.append((start, start + dur, name, _device_kind(name)))
            continue
        if name == WINDOW_SPAN:
            win = (start, start + dur)
        host.append((start, start + dur, name, ann))
    if win is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1 = win
    # the device's work inside the window
    clipped = [(max(s, w0), min(e, w1), name, kind)
               for s, e, name, kind in device if e > w0 and s < w1]
    merged = _merge([(s, e) for s, e, _, _ in clipped])
    busy = sum(e - s for s, e in merged)
    kernels: Dict[str, List] = {}
    for s, e, name, kind in clipped:
        if kind != "kernel":
            name = f"[{kind}]"
        acc = kernels.setdefault(name, [0, 0])
        acc[0] += e - s
        acc[1] += 1
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:n_gaps]
    host_in = [h for h in host if h[1] > w0 and h[0] < w1]
    labelled = [(_label(s, e, host_in), (e - s) * 1e-9) for s, e in gaps]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
        kernels={k: (v[0] * 1e-9, v[1]) for k, v in kernels.items()},
        gaps=labelled)


def kernel_class_seconds(summary: TraceSummary) -> Dict[str, float]:
    """Device seconds by class: ``hand`` (the port's kernels), ``gemm``
    (library products), ``other`` (elementwise and the rest)."""
    out = {"hand": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (s, _) in summary.kernels.items():
        if name.startswith("["):
            continue
        key = ("hand" if HAND_RE.search(name) else
               "gemm" if GEMM_RE.search(name) else "other")
        out[key] += s
    return out
