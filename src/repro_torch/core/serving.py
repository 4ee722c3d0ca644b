"""Costed serving schedules: traffic-aware continuous batching over C(P, cc).

The paper costs *generated runtime plans* so optimizers can size resources
for whole programs, control flow included.  This module applies that to
inference at fleet scale: a :class:`repro_torch.core.workload.ServeWorkload`
(Poisson arrival rate + prompt/output length distributions) is compiled
into **costed serving schedules** built from the same plan IR and
estimator the training stack uses:

  * **Continuous batching** is a steady-state slot-refill loop.  The
    *capacity window* — the schedule interval in which every one of the
    ``B`` decode slots turns over once — is a real :class:`~repro_torch.core.
    plan.Program`: a ``ForBlock`` of ``B`` prefill admissions on the
    prefill pool and a ``ForBlock`` of ``K = E[output len]`` decode steps
    on the decode pool, both priced by :func:`repro_torch.core.costmodel.
    estimate` (first-iteration IO vs warm iterations, collectives,
    residents — the whole Eq-(1) machinery).

  * **Disaggregated prefill/decode pools** split a multi-slice cluster
    into a prefill pool and a decode pool; the per-request KV-cache
    handoff between them is priced as a :class:`~repro_torch.core.plan.P2P`
    instruction on the joining axis — the PR-5 one-link path (never the
    torus-doubled collective rate).  The pool windows compose with the
    ``PipelinedLoopBlock`` schedule algebra: a colocated pool serializes
    (the S=1 fill-sum degeneracy), disjoint pools overlap in steady state
    (the M→∞ ``max`` of per-stage warm times).  At zero arrival rate and
    zero handoff bytes the disaggregated schedule's latency metrics are
    bit-exact equal to the colocated ones — the degeneracy
    tests/test_serving_cost.py pins.

  * **Traffic math** is analytical and monotone in every costed time, so
    the floor pruning of :func:`optimize_serving` stays sound (see
    docs/COST_MODEL.md).  With arrival rate λ and window time T over B
    slots, pool utilization is ρ = λ·T/B; queueing waits use the M/M/1
    mean-wait shape ρ/(1−ρ)·service with the exponential-tail p99
    multiplier ln(100); TTFT stacks queue wait + p99 prefill + handoff +
    one decode step.  ρ ≥ 1 means the schedule is unstable (infeasible).

  * **KV-paging pressure** rides in :func:`repro_torch.core.planner.
    resident_components`: serving decode shapes carry ``kv_page_tokens``
    and a p99 ``max_context``, so slots reserve whole pages up to the
    tail context — an additive HBM-residency term plain decode shapes
    never see.

:func:`optimize_serving` runs the (cluster × plan × schedule) co-search:
candidates are (pool layout × slot count) pairs, pruned by sound
arrival-rate-scaled floors built from :func:`repro_torch.core.resource.
cluster_floor_time`, with per-pool plans chosen by the staged beam.
``optimize_resources`` dispatches here whenever it is handed a
``ServeWorkload``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.cluster import ClusterConfig, single_chip_config
from repro_torch.core.costmodel import PlanCostCache, estimate
from repro_torch.core.dominance import DominancePool
from repro_torch.core.plan import CreateVar, ForBlock, GenericBlock, P2P, Program
from repro_torch.core.planner import (OVERLAP_FRACTION, PlanDecision, SearchStats,
                                      ShardingPlan, build_step_program, choose_plan,
                                      resident_components)
from repro_torch.core.resource import (ClusterCandidate, ResourceSearchStats,
                                       _as_candidate, _plan_space_size,
                                       cluster_floor_time, enumerate_clusters,
                                       torus_links_for)
from repro_torch.core.symbols import MemState, TensorStat
from repro_torch.core.workload import (Objective, ServeWorkload, as_objective)

# p99 multiplier for an exponential queue-wait tail: P(W > t·E[W]) = e^-t.
LN100 = math.log(100.0)

# Slot-count grid for the schedule axis of the co-search: how many decode
# slots the continuous-batching loop keeps in flight.  Small enough to
# enumerate exhaustively per candidate; the HBM pre-filter and stability
# check sink the options a pool cannot carry.
SLOT_OPTS = (8, 32, 128)

# How "step_time" / "cost" / "slo" map onto serving semantics — the string
# objectives stay usable on a ServeWorkload and mean the obvious thing.
_SERVING_KIND = {
    "step_time": "step_time",            # fastest decode step (TPOT)
    "cost": "tokens_per_dollar",
    "job_cost": "tokens_per_dollar",
    "tokens_per_dollar": "tokens_per_dollar",
    "slo": "ttft_p99",
    "ttft_p99": "ttft_p99",
}


# ---------------------------------------------------------------------------
# Serving shapes (decode shapes that know about paging; prefill shapes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingShape(ShapeConfig):
    """A decode ShapeConfig with the paged-KV fields the residency model
    consults: slots reserve whole ``kv_page_tokens`` pages up to the p99
    ``max_context`` (``resident_components``'s ``kv_paging`` term).  Plain
    decode shapes carry neither field and price exactly as before."""

    kv_page_tokens: int = 0
    max_context: int = 0


def decode_steps(wl: ServeWorkload) -> int:
    """Decode steps per capacity window: one full slot turnover emits the
    mean output length."""
    return max(int(round(wl.output_len.mean)), 1)


def decode_shape(wl: ServeWorkload, slots: int) -> ServingShape:
    """The steady-state decode step shape: ``slots`` sequences at the mean
    context (prompt + half-emitted output averages to mean context for a
    full turnover; we use the mean totals, matching the window's K steps),
    with tail-residency fields for the paging term."""
    ctx = max(int(round(wl.prompt_len.mean + wl.output_len.mean)), 1)
    tail = max(int(round(wl.prompt_len.p99 + wl.output_len.p99)), ctx)
    return ServingShape(f"{wl.name}:decode", ctx, max(int(slots), 1),
                        "decode", kv_page_tokens=wl.kv_page_tokens,
                        max_context=tail)


def prefill_shape(wl: ServeWorkload, p99: bool = False) -> ShapeConfig:
    """One request's prefill (admissions are per-request: batch 1)."""
    length = wl.prompt_len.p99 if p99 else wl.prompt_len.mean
    tag = ":prefill99" if p99 else ":prefill"
    return ShapeConfig(f"{wl.name}{tag}", max(int(round(length)), 1), 1,
                       "prefill")


# ---------------------------------------------------------------------------
# Serving candidates: colocated pools or disaggregated pool pairs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingCandidate:
    """One serving hardware layout: a prefill pool and a decode pool.

    Colocated candidates (``handoff_cc is None``) use one pool for both
    phases: the capacity window serializes the two phases and there is no
    handoff.  Disaggregated candidates split a multi-slice cluster into
    two concurrently-running pools (which may have identical configs — a
    1+1 pod split is still two pods); ``handoff_cc`` is the *joined* mesh
    whose ``handoff_axis`` the per-request KV handoff crosses as a
    one-link P2P."""

    cid: str
    prefill_cc: ClusterConfig
    decode_cc: ClusterConfig
    handoff_cc: Optional[ClusterConfig] = None
    handoff_axis: str = "pod"

    @property
    def colocated(self) -> bool:
        return self.handoff_cc is None

    @property
    def num_chips(self) -> int:
        if self.colocated:
            return self.decode_cc.num_chips
        return self.prefill_cc.num_chips + self.decode_cc.num_chips

    @property
    def handoff_lanes(self) -> int:
        """Parallel one-link paths the handoff stripes over: each sender
        pairs with a receiver, so the narrower pool sets the lane count."""
        return max(min(self.prefill_cc.num_chips, self.decode_cc.num_chips), 1)

    @property
    def dollars_per_hour(self) -> float:
        d = self.decode_cc.num_chips * self.decode_cc.chip.cost_per_chip_hour
        if not self.colocated:
            d += (self.prefill_cc.num_chips
                  * self.prefill_cc.chip.cost_per_chip_hour)
        return d


def as_serving_candidate(c) -> ServingCandidate:
    """Accept ServingCandidate | ClusterCandidate | ClusterConfig |
    (cid, cc) — anything a cluster grid already contains serves colocated."""
    if isinstance(c, ServingCandidate):
        return c
    cand = _as_candidate(c)
    return ServingCandidate(cand.cid, cand.cc, cand.cc)


def disaggregate(cand: Union[ClusterCandidate, ServingCandidate]
                 ) -> Optional[ServingCandidate]:
    """The prefill/decode split of a DCN multi-slice candidate: one pod
    becomes the prefill pool, the remaining ``p-1`` the decode pool, and
    the KV handoff crosses the joined mesh's ``pod`` axis (size >= 2, so
    the P2P is never the size-1 no-op).  Single-slice candidates have no
    boundary to split on and return ``None``."""
    if isinstance(cand, ServingCandidate):
        if not cand.colocated:
            return None
        cid, cc = cand.cid, cand.decode_cc
    else:
        cand = _as_candidate(cand)
        cid, cc = cand.cid, cand.cc
    if not cc.mesh_axes or cc.mesh_axes[0] != "pod" or cc.mesh_shape[0] < 2:
        return None
    p = cc.mesh_shape[0]
    inner_shape, inner_axes = cc.mesh_shape[1:], cc.mesh_axes[1:]
    prefill_cc = cc.with_mesh(
        inner_shape, inner_axes,
        torus_links_for(inner_axes, cc.chip, inner_shape))
    if p - 1 > 1:
        dmesh = (p - 1,) + inner_shape
        decode_cc = cc.with_mesh(
            dmesh, cc.mesh_axes, torus_links_for(cc.mesh_axes, cc.chip, dmesh))
    else:
        # 1+1 split: the decode pool is a second pod with the prefill
        # pool's config — physically distinct, so still disaggregated.
        decode_cc = prefill_cc
    return ServingCandidate(f"{cid}+pd", prefill_cc, decode_cc,
                            handoff_cc=cc, handoff_axis="pod")


def join_pools(prefill_cc: ClusterConfig,
               decode_cc: ClusterConfig) -> ClusterConfig:
    """The two-slice mesh a cross-pool KV handoff crosses: the decode
    pool's config with a size-2 ``pod`` axis prepended, so the P2P is
    DCN-classed (the receiver's NIC is the bottleneck end of the wire;
    the chips' DCN rates are fabric-set and identical anyway)."""
    mesh = (2,) + decode_cc.mesh_shape
    axes = ("pod",) + decode_cc.mesh_axes
    return decode_cc.with_mesh(
        mesh, axes, torus_links_for(axes, decode_cc.chip, mesh))


def cross_pool_pairs(cands: Sequence) -> List[ServingCandidate]:
    """Heterogeneous disaggregation: pair single-slice pools of *different
    chip families* as (prefill pool, decode pool), with the KV handoff
    crossing a synthesized joined mesh (:func:`join_pools`).

    This is where prefill/decode disaggregation genuinely earns its keep
    under the cost model: within one chip family every phase scales ~
    linearly with chips, so a same-chip split can never beat its colocated
    parent — but prefill is compute-bound (wants FLOPs/$) while decode
    streams weights (wants HBM-BW/$), and pods come in discrete sizes, so
    the cheapest *stable* fleet can be a compute-dense prefill pod feeding
    a cheaper bandwidth-dense decode pod."""
    singles = []
    for c in cands:
        sc = as_serving_candidate(c)
        if sc.colocated and "pod" not in sc.decode_cc.mesh_axes:
            singles.append(sc)
    out: List[ServingCandidate] = []
    for pf in singles:
        for dc in singles:
            if pf.decode_cc.chip.name == dc.decode_cc.chip.name:
                continue
            out.append(ServingCandidate(
                f"{pf.cid}>{dc.cid}", pf.prefill_cc, dc.decode_cc,
                handoff_cc=join_pools(pf.prefill_cc, dc.decode_cc),
                handoff_axis="pod"))
    return out


def enumerate_serving_clusters(chips=None, pod_counts: Sequence[int] = (1, 2, 4),
                               mesh_variants: int = 2,
                               base: Optional[ClusterConfig] = None,
                               cross_chip: bool = False
                               ) -> List[ServingCandidate]:
    """The serving cluster grid: every :func:`repro_torch.core.resource.
    enumerate_clusters` candidate served colocated, plus the disaggregated
    prefill/decode split of every DCN multi-slice candidate, plus — with
    ``cross_chip=True`` — the heterogeneous single-slice pool pairs of
    :func:`cross_pool_pairs`."""
    out: List[ServingCandidate] = []
    for cand in enumerate_clusters(chips, pod_counts, mesh_variants, base):
        out.append(ServingCandidate(cand.cid, cand.cc, cand.cc))
        split = disaggregate(cand)
        if split is not None:
            out.append(split)
    if cross_chip:
        out.extend(cross_pool_pairs(out))
    return out


# ---------------------------------------------------------------------------
# Costed schedules
# ---------------------------------------------------------------------------


def kv_handoff_bytes(arch: ArchConfig, prompt_tokens: int) -> float:
    """Total KV-cache bytes one prefilled request hands to the decode pool
    — read off :func:`repro_torch.core.planner.resident_components` (the single
    source of truth for cache residency) at batch 1 on a single chip, so
    the payload and the residency model can never disagree."""
    shape = ShapeConfig("kv_handoff", max(int(prompt_tokens), 1), 1, "decode")
    comps = resident_components(arch, shape, ShardingPlan(),
                                single_chip_config())
    return comps.get("kv_cache", 0.0)


def build_handoff_program(payload_bytes: float, axis: str) -> Program:
    """One request's KV handoff as a plan: a P2P send of ``payload_bytes``
    per device across ``axis`` — exactly one link of that axis's fabric
    (:meth:`ClusterConfig.p2p_bw`), DCN-classed when the axis is ``pod``."""
    stat = TensorStat(shape=(max(int(payload_bytes), 1),), dtype="int8",
                      state=MemState.HBM)
    blk = GenericBlock("kv handoff", [
        CreateVar("kv_block", stat),
        P2P("kv_block", axis=axis, bytes_override=float(payload_bytes)),
    ])
    return Program(name=f"kv_handoff[{axis}]", blocks=[blk])


def _window_program(step: Program, label: str, iterations: int) -> Program:
    """Wrap one step program in the schedule's steady-state loop — the
    slot-refill / decode-round window costed through the ForBlock walk
    (first iteration pays staging IO, warm iterations do not)."""
    return Program(name=f"{step.name}|{label}",
                   blocks=[ForBlock(label, max(int(iterations), 1),
                                    list(step.blocks))],
                   functions=dict(step.functions),
                   inputs=dict(step.inputs))


@dataclasses.dataclass(frozen=True)
class ServingScheduleCost:
    """The costed steady state of one (candidate × slot count) schedule.

    All times come from the estimator; the traffic-dependent metrics are
    analytical functions of them, each monotone non-decreasing in every
    time field and in the arrival rate (the floor-soundness requirement).
    """

    slots: int
    decode_steps: int            # K: decode steps per capacity window
    arrival_rate: float          # λ, requests/s
    output_tokens: float         # E[output len], tokens/request
    colocated: bool
    decode_step_time: float      # TPOT: one decode step over `slots`
    prefill_time: float          # one mean-prompt prefill
    prefill_time_p99: float      # one p99-prompt prefill
    handoff_time: float          # per-request KV handoff (0 colocated)
    decode_window_time: float    # K decode steps, costed via the loop IR
    prefill_window_time: float   # B admissions (+ B handoffs), ditto
    dollars_per_hour: float

    # -- schedule algebra -------------------------------------------------
    @property
    def window_time(self) -> float:
        """The capacity window under the PipelinedLoopBlock schedule
        algebra: a colocated pool runs its two phases back to back (the
        S=1 fill-sum degeneracy); disjoint pools overlap, so the steady
        state is the slowest pool (the M→∞ ``(M-1)·max`` term)."""
        if self.colocated:
            return self.prefill_window_time + self.decode_window_time
        return max(self.prefill_window_time, self.decode_window_time)

    # -- utilization (ρ = λ·T/B per pool) ---------------------------------
    @property
    def decode_rho(self) -> float:
        return self.arrival_rate * self.decode_window_time / self.slots

    @property
    def prefill_rho(self) -> float:
        return self.arrival_rate * self.prefill_window_time / self.slots

    @property
    def utilization(self) -> float:
        if self.colocated:
            return self.arrival_rate * self.window_time / self.slots
        return max(self.decode_rho, self.prefill_rho)

    @property
    def stable(self) -> bool:
        return self.utilization < 1.0

    # -- latency ----------------------------------------------------------
    @staticmethod
    def _queue_wait(rho: float, service: float) -> float:
        """M/M/1-shaped mean queue wait; diverges (→ inf) at saturation,
        keeping the metric monotone through the stability boundary."""
        if rho >= 1.0:
            return float("inf")
        return rho / (1.0 - rho) * service

    @property
    def ttft_mean(self) -> float:
        rho_p = self.utilization if self.colocated else self.prefill_rho
        rho_d = self.utilization if self.colocated else self.decode_rho
        wait = (self._queue_wait(rho_p, self.prefill_time + self.handoff_time)
                + self._queue_wait(rho_d, self.decode_step_time))
        return (wait + self.prefill_time + self.handoff_time
                + self.decode_step_time)

    @property
    def ttft_p99(self) -> float:
        """p99 TTFT: exponential-tail queue wait (ln 100 × mean) + p99
        prefill + handoff + the first decode step."""
        rho_p = self.utilization if self.colocated else self.prefill_rho
        rho_d = self.utilization if self.colocated else self.decode_rho
        wait = (self._queue_wait(rho_p, self.prefill_time + self.handoff_time)
                + self._queue_wait(rho_d, self.decode_step_time))
        return (LN100 * wait + self.prefill_time_p99 + self.handoff_time
                + self.decode_step_time)

    # -- throughput / $ ---------------------------------------------------
    @property
    def peak_tokens_per_second(self) -> float:
        """Capacity: the window emits slots × K tokens."""
        w = self.window_time
        return self.slots * self.decode_steps / w if w > 0 else 0.0

    @property
    def tokens_per_second(self) -> float:
        """Delivered throughput: demand-limited when stable, zero when the
        queue diverges."""
        return (self.arrival_rate * self.output_tokens if self.stable
                else 0.0)

    @property
    def cost_per_1k_tokens(self) -> float:
        tps = self.tokens_per_second
        if tps <= 0:
            return float("inf")
        return self.dollars_per_hour / 3600.0 / tps * 1000.0


def cost_serving_schedule(arch: ArchConfig, wl: ServeWorkload,
                          cand: ServingCandidate, slots: int,
                          decode_plan: ShardingPlan,
                          prefill_plan: ShardingPlan,
                          cache: Optional[PlanCostCache] = None,
                          handoff_bytes: Optional[float] = None
                          ) -> ServingScheduleCost:
    """Cost one schedule through the estimator: per-pool step programs,
    the windowed slot-refill loops, and the KV handoff P2P, all sharing
    ``cache`` so repeated sub-plans replay bit-exact.  ``handoff_bytes``
    overrides the per-request KV payload (``None`` reads it off the
    residency model; ``0.0`` makes the handoff free — the degeneracy
    tests pin against)."""
    cand = as_serving_candidate(cand)
    slots = max(int(slots), 1)
    dshape = decode_shape(wl, slots)
    pshape = prefill_shape(wl)
    p99shape = prefill_shape(wl, p99=True)
    k = decode_steps(wl)
    # Mirror planner._cost_candidate: programs are built and estimated
    # under the plan's overlap discount, so the schedule's step times are
    # bit-identical to the PlanDecision times choose_plan reported.
    dcc = cand.decode_cc.with_overlap(
        OVERLAP_FRACTION if decode_plan.overlap else 0.0)
    pcc = cand.prefill_cc.with_overlap(
        OVERLAP_FRACTION if prefill_plan.overlap else 0.0)
    dprog = build_step_program(arch, dshape, decode_plan, dcc)
    t_dec = estimate(dprog, dcc, cache=cache).total
    pprog = build_step_program(arch, pshape, prefill_plan, pcc)
    t_pre = estimate(pprog, pcc, cache=cache).total
    t_pre99 = estimate(build_step_program(arch, p99shape, prefill_plan, pcc),
                       pcc, cache=cache).total
    dwin = estimate(_window_program(dprog, f"decode steady x{k}", k),
                    dcc, cache=cache).total
    pwin = estimate(_window_program(pprog, f"slot refill x{slots}", slots),
                    pcc, cache=cache).total
    if cand.colocated:
        t_handoff = 0.0
    else:
        if handoff_bytes is None:
            handoff_bytes = kv_handoff_bytes(
                arch, int(round(wl.prompt_len.mean)))
        payload = handoff_bytes / cand.handoff_lanes
        if payload > 0:
            hcc = cand.handoff_cc.with_overlap(OVERLAP_FRACTION)
            t_handoff = estimate(build_handoff_program(payload,
                                                       cand.handoff_axis),
                                 hcc, cache=cache).total
        else:
            t_handoff = 0.0
        pwin += slots * t_handoff
    return ServingScheduleCost(
        slots=slots, decode_steps=k, arrival_rate=wl.arrival_rate,
        output_tokens=wl.output_len.mean, colocated=cand.colocated,
        decode_step_time=t_dec, prefill_time=t_pre, prefill_time_p99=t_pre99,
        handoff_time=t_handoff, decode_window_time=dwin,
        prefill_window_time=pwin, dollars_per_hour=cand.dollars_per_hour)


# ---------------------------------------------------------------------------
# Sound serving floors (arrival-rate-scaled, monotone)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingFloor:
    """Lower bounds for one (candidate × slots) entry, each obtained by
    substituting :func:`cluster_floor_time` step floors into the monotone
    traffic formulas (queue waits and the handoff dropped — both
    nonnegative).  A window of N iterations costs at least N × the step
    floor (warm iterations keep the full roofline totals; only the
    first-use IO term shrinks, and the floor never charged IO)."""

    decode_step: float
    prefill_step: float
    prefill_step_p99: float
    utilization: float
    ttft_p99: float


def serving_floor(arch: ArchConfig, wl: ServeWorkload,
                  cand: ServingCandidate, slots: int) -> ServingFloor:
    cand = as_serving_candidate(cand)
    slots = max(int(slots), 1)
    df = cluster_floor_time(arch, decode_shape(wl, slots), cand.decode_cc)
    pf = cluster_floor_time(arch, prefill_shape(wl), cand.prefill_cc)
    pf99 = cluster_floor_time(arch, prefill_shape(wl, p99=True),
                              cand.prefill_cc)
    dwin_f = decode_steps(wl) * df
    pwin_f = slots * pf
    lam = wl.arrival_rate
    if cand.colocated:
        util = lam * (dwin_f + pwin_f) / slots
    else:
        util = lam * max(dwin_f, pwin_f) / slots
    return ServingFloor(decode_step=df, prefill_step=pf,
                        prefill_step_p99=pf99, utilization=util,
                        ttft_p99=pf99 + df)


# ---------------------------------------------------------------------------
# Decisions, ranking, pruning
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingDecision:
    """One (candidate × slot count) outcome: its per-pool plans and costed
    schedule, or why the floor pruned it.  Mirrors
    :class:`repro_torch.core.resource.ResourceDecision`'s surface (``cc`` /
    ``decision`` / ``time`` / ``feasible`` / ``describe``) so sweep cells
    and elastic replanning consume either interchangeably."""

    cluster_id: str
    cand: ServingCandidate
    workload: ServeWorkload
    objective: Objective
    slots: int
    schedule: Optional[ServingScheduleCost]
    decode_decision: Optional[PlanDecision]
    prefill_decision: Optional[PlanDecision]
    floor: Optional[ServingFloor] = None
    pruned: str = ""
    search: Optional[SearchStats] = None

    @property
    def cc(self) -> ClusterConfig:
        return self.cand.decode_cc

    @property
    def decision(self) -> Optional[PlanDecision]:
        return self.decode_decision

    @property
    def time(self) -> float:
        """The serving step-time analogue: one decode step (TPOT)."""
        return (self.schedule.decode_step_time if self.schedule
                else float("inf"))

    @property
    def fits(self) -> bool:
        return bool(self.decode_decision and self.decode_decision.feasible
                    and self.prefill_decision
                    and self.prefill_decision.feasible)

    @property
    def stable(self) -> bool:
        return bool(self.schedule and self.schedule.stable)

    @property
    def feasible(self) -> bool:
        return self.fits and self.stable

    @property
    def ttft_p99(self) -> float:
        return self.schedule.ttft_p99 if self.schedule else float("inf")

    @property
    def tokens_per_second(self) -> float:
        return (self.schedule.tokens_per_second
                if (self.schedule and self.fits) else 0.0)

    @property
    def dollars_per_hour(self) -> float:
        return self.cand.dollars_per_hour

    @property
    def cost_per_1k_tokens(self) -> float:
        if not self.fits or self.schedule is None:
            return float("inf")
        return self.schedule.cost_per_1k_tokens

    def meets(self, slo: Optional[float]) -> bool:
        return self.feasible and slo is not None and self.ttft_p99 <= slo

    def describe(self) -> str:
        if self.pruned:
            return f"{self.cluster_id}@B{self.slots}: pruned ({self.pruned})"
        s = self.schedule
        pools = ("colocated" if self.cand.colocated else
                 f"pd {self.cand.prefill_cc.num_chips}"
                 f"+{self.cand.decode_cc.num_chips}ch")
        return (f"{self.cluster_id}@B{self.slots} [{pools}] "
                f"tpot={s.decode_step_time * 1e3:.2f}ms "
                f"ttft99={self.ttft_p99 * 1e3:.0f}ms "
                f"util={s.utilization * 100:.0f}% "
                f"${self.cost_per_1k_tokens:.4f}/1k")


def canon_serving_objective(objective: Union[str, Objective],
                            slo: Optional[float],
                            wl: ServeWorkload) -> Objective:
    """Canonicalize to a serving objective kind; an unset TTFT SLO falls
    back to the workload's declared target."""
    obj = as_objective(objective, slo)
    kind = _SERVING_KIND.get(obj.kind)
    if kind is None:
        raise ValueError(f"objective {obj.kind!r} has no serving meaning")
    slo_v = obj.slo if obj.slo is not None else wl.ttft_slo
    if kind == "ttft_p99" and slo_v is None:
        raise ValueError("the ttft_p99 objective needs a target: pass "
                         "slo=... or set ServeWorkload.ttft_slo")
    return Objective(kind, slo=slo_v, steps_per_job=obj.steps_per_job)


def _rank_key(obj: Objective):
    def key(sd: ServingDecision) -> Tuple:
        if sd.pruned:
            return (1, sd.floor.utilization if sd.floor else 0.0,
                    sd.cluster_id, sd.slots)
        if obj.kind == "ttft_p99":
            vals: Tuple = (0 if sd.meets(obj.slo) else 1,
                           sd.dollars_per_hour, sd.ttft_p99, sd.time)
        elif obj.kind == "tokens_per_dollar":
            vals = (sd.cost_per_1k_tokens, sd.ttft_p99, sd.time)
        else:                                   # step_time → TPOT
            vals = (sd.time, sd.dollars_per_hour, sd.ttft_p99)
        return (0, 0 if sd.feasible else 1) + vals + (sd.cluster_id,
                                                      sd.slots)
    return key


def _visit_order_key(obj: Objective):
    """Most-promising-first ordering so the incumbent forms early."""
    def key(entry) -> Tuple:
        cand, slots, floor = entry
        dph = cand.dollars_per_hour
        if obj.kind == "ttft_p99":
            ok = floor.utilization < 1.0 and floor.ttft_p99 <= obj.slo
            return (0 if ok else 1, dph, floor.ttft_p99, cand.cid, slots)
        if obj.kind == "tokens_per_dollar":
            return (0 if floor.utilization < 1.0 else 1, dph,
                    floor.ttft_p99, cand.cid, slots)
        return (floor.decode_step, dph, cand.cid, slots)
    return key


def _floor_cannot_win(obj: Objective, wl: ServeWorkload,
                      incumbent: ServingDecision, cand: ServingCandidate,
                      floor: ServingFloor) -> bool:
    """Sound pruning test against a *feasible* incumbent, mirroring
    resource._floor_cannot_win: strict inequalities only, so exact ties
    are still costed and resolved by the deterministic tie-break.  Every
    floor metric lower-bounds its costed value (monotone substitution),
    and the $-rate terms are exact per candidate."""
    if floor.utilization >= 1.0:
        # Unstable at the floor => unstable at any costed plan => can
        # never enter the feasible group the incumbent sits in.
        return True
    dph = cand.dollars_per_hour
    if obj.kind == "ttft_p99":
        if incumbent.meets(obj.slo):
            return (floor.ttft_p99 > obj.slo
                    or dph > incumbent.dollars_per_hour)
        return (floor.ttft_p99 > obj.slo
                and dph > incumbent.dollars_per_hour)
    if obj.kind == "tokens_per_dollar":
        # Throughput is demand-limited (λ·E[out]) for every stable
        # schedule, so the $/token floor is the exact $-rate over demand.
        tps = wl.tokens_per_second
        if tps <= 0:
            return False
        floor_c1k = dph / 3600.0 / tps * 1000.0
        return floor_c1k > incumbent.cost_per_1k_tokens
    return floor.decode_step > incumbent.time


# ---------------------------------------------------------------------------
# The (cluster × plan × schedule) co-search
# ---------------------------------------------------------------------------


def optimize_serving(arch: ArchConfig, wl: ServeWorkload,
                     clusters: Optional[Sequence] = None,
                     objective: Union[str, Objective] = "tokens_per_dollar",
                     slo: Optional[float] = None, *,
                     search: str = "beam", beam_width: int = 4,
                     prune: Optional[bool] = None,
                     slot_opts: Sequence[int] = SLOT_OPTS,
                     cache: Optional[PlanCostCache] = None,
                     stats: Optional[ResourceSearchStats] = None,
                     jobs: int = 1) -> List[ServingDecision]:
    """Rank (pool layout × slot count) candidates with their best per-pool
    plans under a serving objective.  ``search="beam"`` prunes entries by
    the sound serving floors and plans by the staged beam;
    ``search="exhaustive"`` costs every (candidate × slots × plan) cell —
    the verification oracle.  Both return the identical winner (gated by
    benchmarks/bench_serving.py).  ``jobs`` > 1 warms the cache by running
    the search on candidate shards in parallel (decisions discarded, cache
    deltas merged), then the serial pass below re-runs warm — bit-identical
    to ``jobs=1`` (incumbent pruning is visit-order dependent)."""
    obj = canon_serving_objective(objective, slo, wl)
    if prune is None:
        prune = search == "beam"
    cands = [as_serving_candidate(c) for c in
             (clusters if clusters is not None
              else enumerate_serving_clusters())]
    if cache is None:
        cache = PlanCostCache()
    if stats is None:
        stats = ResourceSearchStats()
    if jobs > 1 and len(cands) > 1:
        from repro_torch.core import parallel
        stats.worker_cache = parallel.warm_shards(
            "serving", arch, wl, cands,
            dict(objective=objective, slo=slo, search=search,
                 beam_width=beam_width, prune=prune,
                 slot_opts=tuple(slot_opts)),
            jobs, cache)
    pshape = prefill_shape(wl)
    entries = []
    for cand in cands:
        stats.exhaustive_plan_space += _plan_space_size(
            arch, pshape, cand.prefill_cc.mesh_shape,
            cand.prefill_cc.mesh_axes)
        for slots in slot_opts:
            dshape = decode_shape(wl, slots)
            stats.exhaustive_plan_space += _plan_space_size(
                arch, dshape, cand.decode_cc.mesh_shape,
                cand.decode_cc.mesh_axes)
            entries.append((cand, int(slots),
                            serving_floor(arch, wl, cand, slots)))
    stats.clusters_total += len(entries)
    if prune:
        entries.sort(key=_visit_order_key(obj))
    key = _rank_key(obj)
    pool = DominancePool(
        rank_key=key,
        cannot_win=(lambda bound, best: _floor_cannot_win(
            obj, wl, best, bound[0], bound[1])) if prune else None)
    pre_memo: Dict[str, Tuple[PlanDecision, int]] = {}
    out: List[ServingDecision] = []
    for cand, slots, floor in entries:
        if not pool.admit((cand, floor)):
            stats.clusters_pruned += 1
            out.append(ServingDecision(
                cand.cid, cand, wl, obj, slots, None, None, None,
                floor=floor,
                pruned=f"floor loses to {pool.best.cluster_id}"
                       f"@B{pool.best.slots}"))
            continue
        pstats = SearchStats()
        dec_best = choose_plan(arch, decode_shape(wl, slots), cand.decode_cc,
                               top_k=1, search=search, beam_width=beam_width,
                               cache=cache, stats=pstats)[0]
        memo = pre_memo.get(cand.cid)
        if memo is None:
            pre_best = choose_plan(arch, pshape, cand.prefill_cc, top_k=1,
                                   search=search, beam_width=beam_width,
                                   cache=cache, stats=pstats)[0]
            pre_memo[cand.cid] = (pre_best, pstats.costed)
        else:
            pre_best = memo[0]
        stats.plan_evals += pstats.costed
        stats.clusters_costed += 1
        sched = cost_serving_schedule(arch, wl, cand, slots, dec_best.plan,
                                      pre_best.plan, cache=cache)
        sd = ServingDecision(cand.cid, cand, wl, obj, slots, sched,
                             dec_best, pre_best, floor=floor, search=pstats)
        out.append(sd)
        if sd.feasible:
            pool.offer(sd)
    stats.cache = cache.stats()
    out.sort(key=key)
    return out


def serve_cell(arch: ArchConfig, wl: ServeWorkload, cc: ClusterConfig,
               cluster_id: Optional[str] = None, *, search: str = "beam",
               beam_width: int = 4, cache: Optional[PlanCostCache] = None
               ) -> Tuple[PlanDecision, SearchStats]:
    """One sweep-grid serving cell: the best schedule of this workload on
    this one cluster (served colocated), reported as the winning decode
    pool's :class:`PlanDecision` — feasibility tightened to require a
    *stable* schedule, not just an HBM fit — so sweep tables and golden
    cells consume serving cells exactly like step cells."""
    cand = as_serving_candidate((cluster_id, cc) if cluster_id else cc)
    rstats = ResourceSearchStats()
    decisions = optimize_serving(arch, wl, [cand],
                                 objective="tokens_per_dollar",
                                 search=search, beam_width=beam_width,
                                 cache=cache, stats=rstats)
    best = decisions[0]
    pd = dataclasses.replace(best.decode_decision, feasible=best.feasible)
    return pd, SearchStats(costed=rstats.plan_evals)


def format_serving_decisions(decisions: Sequence[ServingDecision]) -> str:
    """Fixed-width ranked table for examples / EXPLAIN output."""
    header = (f"{'#':>3} {'candidate':30} {'B':>4} {'chips':>6} "
              f"{'tpot':>9} {'ttft99':>9} {'util':>5} {'$/1k tok':>9} "
              f"{'feas':>4}  {'decode plan':36}")
    lines = [header, "-" * len(header)]
    for i, sd in enumerate(decisions, 1):
        if sd.pruned:
            lines.append(f"{i:>3} {sd.cluster_id:30} {sd.slots:>4} "
                         f"{sd.cand.num_chips:>6} {'--':>9} {'--':>9} "
                         f"{'--':>5} {'--':>9} {'cut':>4}  "
                         f"pruned: {sd.pruned[:40]}")
            continue
        s = sd.schedule
        feas = "y" if sd.feasible else ("sat" if sd.fits else "OOM")
        c1k = sd.cost_per_1k_tokens
        lines.append(
            f"{i:>3} {sd.cluster_id:30} {sd.slots:>4} "
            f"{sd.cand.num_chips:>6} {s.decode_step_time * 1e3:8.2f}m "
            f"{min(sd.ttft_p99, 9999) * 1e3:8.0f}m "
            f"{min(s.utilization, 9.99) * 100:4.0f}% "
            f"{min(c1k, 999.9):9.4f} {feas:>4}  "
            f"{sd.decode_decision.plan.describe():36}")
    return "\n".join(lines)
