"""Straggler detection + cost-based mitigation decision (counterpart of
``repro.runtime.straggler``; numpy only, the reference's arithmetic).

SPMD steps are lockstep, so a slow host drags the whole pod; the TPU-world
mitigation is *exclude and re-mesh* (checkpoint -> rebuild without the slow
pod), not MR-style backup tasks.  The novelty here, in the paper's spirit:
the decision is **cost-based** — we compare the estimated cost of the two
plans (keep limping vs. pay the re-mesh) with the same linearized
time-cost machinery used everywhere else.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.cluster import ClusterConfig


@dataclasses.dataclass
class StragglerVerdict:
    is_straggler: bool
    slow_entities: List[int]
    slowdown: float                # measured step-time inflation factor
    action: str                    # "none" | "tolerate" | "remesh"
    detail: str = ""


class StepTimeMonitor:
    """Robust (median/MAD) outlier detection over per-entity step times.

    Entities are whatever granularity the runtime reports: hosts, pods, or
    data-parallel groups.  ``record`` takes a dict entity->seconds.
    """

    def __init__(self, window: int = 32, z_threshold: float = 4.0,
                 min_samples: int = 8):
        self.window = window
        self.z = z_threshold
        self.min_samples = min_samples
        self._hist: Dict[int, Deque[float]] = {}

    def record(self, times: Dict[int, float]) -> None:
        for ent, t in times.items():
            self._hist.setdefault(ent, deque(maxlen=self.window)).append(float(t))

    def detect(self) -> StragglerVerdict:
        if not self._hist or any(len(v) < self.min_samples
                                 for v in self._hist.values()):
            return StragglerVerdict(False, [], 1.0, "none", "warming up")
        med_per_ent = {e: float(np.median(v)) for e, v in self._hist.items()}
        meds = np.asarray(list(med_per_ent.values()))
        overall = float(np.median(meds))
        mad = float(np.median(np.abs(meds - overall))) + 1e-9
        slow = [e for e, m in med_per_ent.items()
                if (m - overall) / (1.4826 * mad) > self.z
                and m > 1.05 * overall]
        if not slow:
            return StragglerVerdict(False, [], 1.0, "none")
        worst = max(med_per_ent[e] for e in slow)
        return StragglerVerdict(True, sorted(slow), worst / overall,
                                "detected")


def decide_remesh(verdict: StragglerVerdict, *, cc: ClusterConfig,
                  healthy_step_time: float, remaining_steps: int,
                  checkpoint_bytes_per_device: float,
                  excluded_fraction: float) -> StragglerVerdict:
    """Cost-based mitigation: C(tolerate) vs C(remesh).

    tolerate: remaining_steps * healthy_step_time * slowdown
    remesh:   restore IO + recompile + remaining_steps * healthy_step_time
              / (1 - excluded_fraction)   [fewer chips -> slower steps]
    """
    if not verdict.is_straggler:
        return verdict
    c_tolerate = remaining_steps * healthy_step_time * verdict.slowdown
    restore_t = (checkpoint_bytes_per_device / cc.chip.disk_bw
                 + checkpoint_bytes_per_device / cc.chip.pcie_bw)
    # the reference's constant for a recompile of its jitted step, kept so
    # that both packages decide alike; the port compiles no step, and a
    # restart on the GPU costs the checkpoint's restore instead
    recompile_t = 120.0
    c_remesh = (restore_t + recompile_t
                + remaining_steps * healthy_step_time
                / max(1.0 - excluded_fraction, 1e-6))
    action = "remesh" if c_remesh < c_tolerate else "tolerate"
    return dataclasses.replace(
        verdict, action=action,
        detail=(f"C(tolerate)={c_tolerate:.1f}s vs C(remesh)={c_remesh:.1f}s "
                f"(restore={restore_t:.1f}s)"))
