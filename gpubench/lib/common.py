"""What a traffic driver is given and what it hands back."""
from __future__ import annotations

import dataclasses
import time
from types import ModuleType
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class Ctx:
    cell: dict                   # the BENCHMARK.json workload entry
    cfg: dict                    # the configuration file
    mix: dict                    # the traffic file
    checks: dict                 # the cell's checks file (limits)
    reference: ModuleType        # gpubench/reference/<config>.py
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float               # perf_counter at process start
    control: Optional[str] = None   # reference readings in this precision too


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]          # name -> value (incl. setup_s)
    readout: Dict[str, Any]               # what the per-layer readers read
    attempted: int
    failed: int
    correct: bool
    checks: Dict[str, dict]               # name -> {"value", "limit", ...}
    memory_peak_bytes: int
    summary: Any = None                   # trace.TraceSummary with --trace 1
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock(device: torch.device) -> float:
    """Host seconds once the device has finished its queue."""
    sync(device)
    return time.perf_counter()


def peak_bytes(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device: torch.device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
