"""Typed workload and objective descriptions for the resource optimizer.

The paper's resource optimizer consumes a *program* and a *cluster grid*;
what it historically lacked is a declarative description of the thing the
program is run **for** — a training job of so-many steps, or a serving
fleet under so-much traffic.  PAPERS.md's workload-aware-costing line of
work ("Cost Models for Big Data Query Processing", "A Cost-based Optimizer
for Gradient Descent Optimization") argues the optimizer should take that
description as a first-class input, not a bag of kwargs.  This module is
that input surface:

  * :class:`TrainWorkload`  — a step shape plus the job length that the
    ``job_cost`` objective amortizes overheads over,
  * :class:`ServeWorkload`  — a request-arrival model: Poisson arrival
    rate plus prompt/output length distributions (mean + p99), the
    traffic that :mod:`repro_torch.core.serving` turns into costed schedules,
  * :class:`Objective`      — a typed (kind, slo, steps_per_job) triple
    accepted anywhere a string objective is (the strings remain thin
    aliases; every pre-existing call site works unchanged).

Everything here is a frozen dataclass: hashable (the floor caches key on
workloads) and inert (no jax, no model state).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from repro_torch.configs.base import ShapeConfig

# Default job length for the job-level objective: long enough that compute
# dominates startup on healthy configs, short enough that preemption-heavy
# giant slices pay visibly for their restarts.  (Lives here so both the
# resource optimizer and the typed API share one constant; re-exported by
# :mod:`repro_torch.core.resource` for compatibility.)
DEFAULT_STEPS_PER_JOB = 10_000

# Canonical objective kinds.  The first four rank training-style step
# workloads (see resource.py); the last two only make sense for a
# ServeWorkload (see serving.py) — traffic, not steps, sets their scale.
TRAIN_OBJECTIVES = ("step_time", "cost", "job_cost", "slo")
SERVING_OBJECTIVES = ("ttft_p99", "tokens_per_dollar")

# Every accepted spelling -> canonical kind.  String objectives stay
# supported forever; `Objective` is the typed spelling of the same thing.
OBJECTIVE_ALIASES: Dict[str, str] = {
    "step_time": "step_time", "time": "step_time",
    "cost": "cost", "device_seconds": "cost", "cost_per_step": "cost",
    "job_cost": "job_cost", "cost_per_job": "job_cost", "job": "job_cost",
    "slo": "slo", "slo_cheapest": "slo",
    "ttft_p99": "ttft_p99", "ttft": "ttft_p99",
    "tokens_per_dollar": "tokens_per_dollar",
    "tokens_per_sec_per_dollar": "tokens_per_dollar",
    "throughput_per_dollar": "tokens_per_dollar",
}


@dataclasses.dataclass(frozen=True)
class Objective:
    """What "best" means for one optimize call.

    ``kind`` is a canonical objective name (any :data:`OBJECTIVE_ALIASES`
    spelling is accepted and canonicalized).  ``slo`` is the target the
    SLO-style kinds rank against — a step-time bound for ``slo``, a p99
    time-to-first-token bound (seconds) for ``ttft_p99``.  ``steps_per_job``
    sizes the job priced by ``job_cost`` (``None`` defers to the workload
    or the caller's default)."""

    kind: str
    slo: Optional[float] = None
    steps_per_job: Optional[int] = None

    def __post_init__(self):
        canon = OBJECTIVE_ALIASES.get(self.kind)
        if canon is None:
            raise ValueError(
                f"unknown objective kind {self.kind!r}; "
                f"one of {sorted(set(OBJECTIVE_ALIASES))}")
        object.__setattr__(self, "kind", canon)
        if self.slo is not None and self.slo <= 0:
            raise ValueError(f"slo must be positive, got {self.slo}")

    # -- typed constructors (the readable spellings) ----------------------
    @classmethod
    def step_time(cls) -> "Objective":
        return cls("step_time")

    @classmethod
    def cost_per_step(cls) -> "Objective":
        return cls("cost")

    @classmethod
    def job_cost(cls, steps_per_job: Optional[int] = None) -> "Objective":
        return cls("job_cost", steps_per_job=steps_per_job)

    @classmethod
    def step_slo(cls, slo: float) -> "Objective":
        """Cheapest config whose *step time* meets ``slo`` seconds."""
        return cls("slo", slo=slo)

    @classmethod
    def ttft_p99(cls, slo: Optional[float] = None) -> "Objective":
        """Cheapest serving config whose p99 TTFT meets ``slo`` seconds
        (``None`` defers to :attr:`ServeWorkload.ttft_slo`)."""
        return cls("ttft_p99", slo=slo)

    @classmethod
    def tokens_per_dollar(cls) -> "Objective":
        return cls("tokens_per_dollar")


def as_objective(objective: Union[str, Objective],
                 slo: Optional[float] = None,
                 steps_per_job: Optional[int] = None) -> Objective:
    """Canonicalize a string-or-typed objective plus the legacy loose
    kwargs into one :class:`Objective`.  Fields set on a typed objective
    win over the loose kwargs (the typed spelling is the explicit one)."""
    if isinstance(objective, Objective):
        return Objective(
            objective.kind,
            slo=objective.slo if objective.slo is not None else slo,
            steps_per_job=(objective.steps_per_job
                           if objective.steps_per_job is not None
                           else steps_per_job))
    return Objective(objective, slo=slo, steps_per_job=steps_per_job)


@dataclasses.dataclass(frozen=True)
class TrainWorkload:
    """A step-shaped workload: exactly what the optimizer always took,
    now with the job length attached to the thing being optimized instead
    of passed alongside it."""

    shape: ShapeConfig
    steps_per_job: int = DEFAULT_STEPS_PER_JOB

    def __post_init__(self):
        if self.steps_per_job < 1:
            raise ValueError("steps_per_job must be >= 1")

    @property
    def name(self) -> str:
        return self.shape.name


@dataclasses.dataclass(frozen=True)
class LengthDistribution:
    """Token-length distribution summarized by its mean and p99 — the two
    moments the analytical serving model consumes (mean sizes steady-state
    work; p99 sizes tail residency and tail latency)."""

    mean: float
    p99: Optional[float] = None

    def __post_init__(self):
        if self.mean <= 0:
            raise ValueError(f"mean length must be positive, got {self.mean}")
        if self.p99 is None:
            object.__setattr__(self, "p99", float(self.mean))
        if self.p99 < self.mean:
            raise ValueError(f"p99 ({self.p99}) below mean ({self.mean})")


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """A request-arrival model: the serving analogue of a ShapeConfig.

    ``arrival_rate`` is the Poisson mean in requests/second; the length
    distributions are in tokens.  ``ttft_slo`` is the default p99
    time-to-first-token target (seconds) for the ``ttft_p99`` objective.
    ``kv_page_tokens`` is the paged-KV allocator's page size — it feeds
    the KV-paging HBM-residency term (slots reserve whole pages up to the
    p99 context, not the mean)."""

    name: str
    arrival_rate: float
    prompt_len: LengthDistribution
    output_len: LengthDistribution
    ttft_slo: Optional[float] = None
    kv_page_tokens: int = 128

    def __post_init__(self):
        if self.arrival_rate < 0:
            raise ValueError("arrival_rate must be >= 0")
        if self.kv_page_tokens < 0:
            raise ValueError("kv_page_tokens must be >= 0")

    @property
    def tokens_per_second(self) -> float:
        """Offered decode-token demand: arrival rate x mean output length."""
        return self.arrival_rate * self.output_len.mean


# Named serving workloads, analogous to configs.SHAPES: accepted anywhere
# a shape id is (sweep grids, examples, benchmarks).
SERVE_WORKLOADS: Dict[str, ServeWorkload] = {
    # Interactive chat: short-ish prompts, heavy aggregate decode demand.
    "chat_2k": ServeWorkload(
        "chat_2k", arrival_rate=8.0,
        prompt_len=LengthDistribution(2048, 6144),
        output_len=LengthDistribution(256, 1024),
        ttft_slo=0.5),
    # Retrieval-augmented serving: long prompts make prefill the
    # contended resource — the disaggregation scenario.
    "rag_32k": ServeWorkload(
        "rag_32k", arrival_rate=2.0,
        prompt_len=LengthDistribution(32768, 65536),
        output_len=LengthDistribution(512, 1024),
        ttft_slo=2.0),
}
