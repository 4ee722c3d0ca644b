"""Resource optimization: co-search cluster configs and sharding plans.

The paper's cost model exists *for* optimizers — SystemML's resource
optimizer enumerates cluster configurations and re-costs the program under
each.  The TPU analogue enumerates **cluster candidates** (chip type from
the :data:`repro_torch.core.cluster.CHIPS` table, pod count, mesh shape / axis
layout, DCN- vs ICI-linked multi-slice topologies) and, for each, runs the
staged beam :func:`repro_torch.core.planner.choose_plan` through one shared
:class:`repro_torch.core.costmodel.PlanCostCache`, ranking the results under a
pluggable objective:

  * ``step_time``       — fastest feasible step,
  * ``cost`` (alias ``device_seconds``) — cheapest step: step time x chips
    weighted by :attr:`ChipSpec.cost_per_chip_hour` (the $-cost proxy),
  * ``job_cost``        — cheapest **job**: :func:`job_dollars` amortizes
    startup, checkpoint restore and expected-preemption overhead over
    ``steps_per_job`` steps (big cheap-per-step slices get preempted more),
  * ``slo``             — cheapest config whose step time meets an SLO.

Candidate clusters are pruned *soundly* before any plan is costed: a
cluster whose analytic **cost floor** already loses to the incumbent
cannot contain the winner, so the whole (cluster x plan) subtree is
skipped.  The floor (:func:`cluster_floor_time`) is built from the cost
estimator's own work totals (:class:`repro_torch.core.costmodel.ProgramTotals`)
of one minimum-work reference plan per axis-role class — compute/memory
rooflines *plus* the role's unavoidable collective wire volume over
ICI/DCN — so the floor shares the estimator's linearization semantics by
construction, and memory-bound decode cells (whose collectives dominate)
prune as hard as train cells.  Together with the staged beam inside each
cluster and the shared sub-plan cache, the co-search returns the exact
exhaustive-scan winner at a small fraction of the full plan evaluations
(gated by tests and benchmarks).  The soundness argument is spelled out in
``docs/COST_MODEL.md``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.cluster import (CHIPS, DEFAULT_CHECKPOINT_RESTORE_SECONDS,
                                      ChipSpec, ClusterConfig)
from repro_torch.core.costmodel import (VPU_FRACTION, CacheStats, PlanCostCache,
                                        ProgramTotals, estimate)
from repro_torch.core.dominance import DominancePool
from repro_torch.core.planner import (MAX_MICROBATCHES, OVERLAP_FRACTION,
                                      PlanDecision, SearchStats,
                                      build_step_program, choose_plan,
                                      enumerate_plans, reference_plans)
from repro_torch.core.workload import (DEFAULT_STEPS_PER_JOB, OBJECTIVE_ALIASES,
                                       SERVING_OBJECTIVES, TRAIN_OBJECTIVES,
                                       Objective, ServeWorkload, TrainWorkload,
                                       as_objective)

OBJECTIVES = TRAIN_OBJECTIVES
# Spellings that canonicalize to a *training* objective kind; serving-only
# kinds are recognized (for the helpful error below) but not accepted here.
_OBJECTIVE_ALIASES = {k: v for k, v in OBJECTIVE_ALIASES.items()
                      if v in TRAIN_OBJECTIVES}

# Purchasable slice granularity per chip generation (chips per pod slice).
POD_CHIPS = {"tpu_v5e": 256, "tpu_v5p": 64, "tpu_v6e": 256}


# ---------------------------------------------------------------------------
# Cluster candidates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterCandidate:
    """One enumerable cluster configuration, with a stable display id."""

    cid: str
    cc: ClusterConfig


def _short(chip: ChipSpec) -> str:
    return chip.name.replace("tpu_", "")


def _make_cc(chip: ChipSpec, mesh_shape: Tuple[int, ...],
             mesh_axes: Tuple[str, ...],
             base: Optional[ClusterConfig] = None,
             torus_links: Tuple[int, ...] = ()) -> ClusterConfig:
    if base is not None:
        return dataclasses.replace(base, chip=chip, mesh_shape=mesh_shape,
                                   mesh_axes=mesh_axes,
                                   torus_links=tuple(torus_links))
    return ClusterConfig(chip=chip, mesh_shape=mesh_shape,
                         mesh_axes=mesh_axes,
                         torus_links=tuple(torus_links))


def torus_links_for(axes: Tuple[str, ...], chip: ChipSpec,
                    mesh_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Per-axis ICI link counts for a candidate mesh layout.

    A 3-ICI-axis layout on a chip whose fabric builds a 3D torus earns the
    wrapped-ring rate (2 links) — but only on axes whose extent spans a
    whole number of the chip's building-block cubes
    (``ChipSpec.ici_cube_dim``; v5p slices compose 4x4x4 cubes).  A
    sub-cube extent (e.g. the 2-wide axis of an 8x4x2 slice) has no
    wraparound to close the ring: it is an open line, 1 link.  Everything
    else — 2D layouts, or any layout on a 2D-torus chip — keeps the
    calibrated flat model (empty -> 1 link per axis); so does a slice with
    no full-cube axis at all, making full-cube cells (4x4x4, 12x4x4, ...)
    bit-identical to the pre-fidelity behavior.  The chip gate lives here
    so no caller can accidentally price wrapped rings on hardware without
    a third fabric dimension."""
    ici_axes = sum(1 for a in axes if a != "pod")
    if ici_axes < 3 or chip.ici_torus_dims < 3:
        return ()
    cube = max(int(chip.ici_cube_dim), 1)
    links = tuple(
        1 if (a == "pod" or n < 2 or n % cube) else 2
        for a, n in zip(axes, mesh_shape))
    return links if any(l == 2 for l in links) else ()


def mesh_factorizations_3d(n: int, variants: int = 2
                           ) -> List[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """(data, model, depth) splits of an n-chip 3D-torus slice, most
    cube-balanced first.  The model and depth axes are power-of-two sized;
    the data axis takes the remainder ``n / (model * depth)`` (e.g. 192
    splits as (12, 4, 4)).  Ordered ``data >= model >= depth >= 2`` so
    each candidate names a distinct physical layout."""
    out: List[Tuple[Tuple[int, ...], Tuple[str, ...]]] = []
    z = 2
    while z * z * z <= n:
        if n % z == 0:
            m = z
            while m * m * z <= n:
                if (n // z) % m == 0:
                    out.append(((n // (m * z), m, z),
                                ("data", "model", "depth")))
                m *= 2
        z *= 2
    out.sort(key=lambda mz: (mz[0][0] / mz[0][2], mz[0]))
    return out[:variants]


def mesh_factorizations(n: int, variants: int = 2, torus_dims: int = 2
                        ) -> List[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """Mesh splits of an n-chip slice: the 2D (data, model) layouts —
    balanced first, then a wide-data / narrow-model variant — plus, when
    the chip's fabric builds a 3D torus (``torus_dims >= 3``), the
    near-cubic (data, model, depth) layouts appended after them.  The 2D
    list is unchanged by the torus dimension, so pre-torus candidate ids
    and costs are stable."""
    if n <= 1:
        return [((1,), ("data",))]
    out: List[Tuple[Tuple[int, ...], Tuple[str, ...]]] = []
    balanced_model = 1
    while balanced_model * balanced_model * 4 <= n:
        balanced_model *= 2
    seen = set()
    for model in (balanced_model, max(balanced_model // 4, min(4, n))):
        if n % model:
            continue
        mesh = (n // model, model) if model > 1 else (n,)
        axes = ("data", "model") if model > 1 else ("data",)
        if mesh not in seen:
            seen.add(mesh)
            out.append((mesh, axes))
        if len(out) >= variants:
            break
    out = out or [((n,), ("data",))]
    if torus_dims >= 3:
        out.extend(mesh_factorizations_3d(n, variants))
    return out


def mesh_candidates(chip: ChipSpec, num_chips: int,
                    base: Optional[ClusterConfig] = None
                    ) -> List[ClusterCandidate]:
    """All single-slice mesh layouts for a fixed chip count (elastic
    re-meshing: the devices that survived, re-factored).

    Never returns an empty list for ``num_chips >= 1``: a chip count with
    no 2D factorization beyond trivial (primes, odd survivor counts)
    still yields the degenerate 1D all-data mesh, so
    :func:`repro.runtime.elastic.replan` always has a candidate to cost
    after device loss.  Chips whose fabric builds a 3D torus
    (``ici_torus_dims >= 3``) also contribute the 3D layouts of the
    survivor count."""
    if num_chips < 1:
        raise ValueError(f"mesh_candidates needs >=1 chip, got {num_chips}")
    out = []
    seen = set()
    for model in (1, 2, 4, 8, 16, 32):
        if num_chips % model or model > num_chips:
            continue
        mesh = (num_chips // model, model) if model > 1 else (num_chips,)
        axes = ("data", "model") if model > 1 else ("data",)
        if mesh in seen:
            continue
        seen.add(mesh)
        out.append(ClusterCandidate(
            f"{_short(chip)}-{'x'.join(map(str, mesh))}",
            _make_cc(chip, mesh, axes, base)))
    if chip.ici_torus_dims >= 3:
        for mesh, axes in mesh_factorizations_3d(num_chips):
            if mesh in seen:
                continue
            seen.add(mesh)
            out.append(ClusterCandidate(
                f"{_short(chip)}-{'x'.join(map(str, mesh))}-3d",
                _make_cc(chip, mesh, axes, base,
                         torus_links=torus_links_for(axes, chip, mesh))))
    if not out:          # unreachable (model=1 always fits) — belt/braces
        out.append(ClusterCandidate(
            f"{_short(chip)}-{num_chips}",
            _make_cc(chip, (num_chips,), ("data",), base)))
    return out


def enumerate_clusters(chips: Optional[Sequence[Union[str, ChipSpec]]] = None,
                       pod_counts: Sequence[int] = (1, 2, 4),
                       mesh_variants: int = 2,
                       base: Optional[ClusterConfig] = None
                       ) -> List[ClusterCandidate]:
    """The default cluster grid: chip type x pod count x mesh layout, with
    both ICI-linked superslices (when the chip's ICI domain allows) and
    DCN-linked multi-pod topologies.  Chips whose fabric builds a 3D torus
    (v5p: ``ici_torus_dims == 3``) contribute the near-cubic 3D layouts of
    each ICI slice alongside the 2D ones — plus, for multi-slice counts, a
    (pod x 3D inner torus) 4-axis family — with per-axis link counts set
    by :func:`torus_links_for` (wrapped rings only on full-cube axes)."""
    chip_specs = [CHIPS[c] if isinstance(c, str) else c
                  for c in (chips if chips is not None else CHIPS)]
    out: List[ClusterCandidate] = []
    for chip in chip_specs:
        pod = POD_CHIPS.get(chip.name, 256)
        for p in pod_counts:
            total = pod * p
            fits_ici = total <= chip.ici_domain
            if fits_ici:
                for mesh, axes in mesh_factorizations(
                        total, mesh_variants,
                        torus_dims=chip.ici_torus_dims):
                    tag = "-3d" if len(mesh) >= 3 else ""
                    out.append(ClusterCandidate(
                        f"{_short(chip)}-{'x'.join(map(str, mesh))}{tag}",
                        _make_cc(chip, mesh, axes, base,
                                 torus_links=torus_links_for(axes, chip,
                                                             mesh))))
            if p > 1:
                # DCN multi-slice: "pod" axis crosses the data-center network
                nv = 1 if fits_ici else mesh_variants
                for mesh, axes in mesh_factorizations(pod, nv):
                    out.append(ClusterCandidate(
                        f"{_short(chip)}-{p}x{'x'.join(map(str, mesh))}-dcn",
                        _make_cc(chip, (p,) + mesh, ("pod",) + axes, base)))
                if chip.ici_torus_dims >= 3:
                    # (pod x 3D inner torus): a 4-axis mesh.  The role
                    # assignment has handled 4 axes since the depth axis
                    # landed; this emits the candidates — and it is where
                    # pipeline-over-DCN meets wrapped-ring slices.
                    for mesh, axes in mesh_factorizations_3d(pod, nv):
                        full_mesh, full_axes = (p,) + mesh, ("pod",) + axes
                        out.append(ClusterCandidate(
                            f"{_short(chip)}-{p}x"
                            f"{'x'.join(map(str, mesh))}-dcn-3d",
                            _make_cc(chip, full_mesh, full_axes, base,
                                     torus_links=torus_links_for(
                                         full_axes, chip, full_mesh))))
    return out


def _as_candidate(c) -> ClusterCandidate:
    if isinstance(c, ClusterCandidate):
        return c
    if isinstance(c, ClusterConfig):
        label = "x".join(str(s) for s in c.mesh_shape)
        return ClusterCandidate(f"{c.chip.name}[{label}]", c)
    if isinstance(c, tuple) and len(c) == 2:
        return ClusterCandidate(str(c[0]), c[1])
    raise TypeError(f"not a cluster candidate: {c!r}")


# ---------------------------------------------------------------------------
# Sound per-cluster cost floors (prune whole clusters without costing plans)
# ---------------------------------------------------------------------------
#
# One minimum-work reference plan per axis-role class is generated and
# costed through the estimator itself; the floor is read off the resulting
# ProgramTotals.  There is no second plan walker to keep in sync (the old
# ``_walk_totals`` hand-mirror and its runtime tripwire are gone): the
# totals come from the same recursive pass that produces the costs, so the
# floor inherits the estimator's semantics by construction.

# Reference walks share one cache: role bodies repeat across geometries.
_FLOOR_CACHE = PlanCostCache()


@functools.lru_cache(maxsize=None)
def _plan_space_size(arch: ArchConfig, shape: ShapeConfig,
                     mesh_shape: Tuple[int, ...],
                     mesh_axes: Tuple[str, ...]) -> int:
    """|enumerate_plans| for the exhaustive-scan statistic.  The space
    depends only on the mesh geometry (roles/knobs never consult the chip),
    so the count is cached instead of re-enumerated per optimize call."""
    cc = ClusterConfig(mesh_shape=mesh_shape, mesh_axes=mesh_axes)
    return len(enumerate_plans(arch, shape, cc))


@functools.lru_cache(maxsize=None)
def _floor_totals(arch: ArchConfig, shape: ShapeConfig,
                  mesh_shape: Tuple[int, ...],
                  mesh_axes: Tuple[str, ...],
                  fusion: str = "off"
                  ) -> Tuple[Tuple[str, ProgramTotals, int], ...]:
    """Estimator-charged work totals of each role's minimum-work reference
    plan (:func:`repro_torch.core.planner.reference_plans`) on a mesh geometry,
    keyed by role name and paired with the role's pipeline-stage count S
    (1 for every non-pipelined role).

    Totals (per-device flops/bytes after sharding, collective wire volume
    per link class) never consult the chip, so one entry serves every chip
    generation with that geometry — the walks amortize across the whole
    candidate grid and across optimize calls."""
    cc = ClusterConfig(mesh_shape=mesh_shape, mesh_axes=mesh_axes)
    return tuple(
        (plan.name,
         estimate(build_step_program(arch, shape, plan, cc), cc,
                  cache=_FLOOR_CACHE).totals,
         plan.degree(cc, plan.pp_axes))
        for plan in reference_plans(arch, shape, cc, fusion=fusion))


def role_floor_times(arch: ArchConfig, shape: ShapeConfig,
                     cc: ClusterConfig,
                     fusion: str = "off") -> Dict[str, float]:
    """Per-role sound lower bounds on ``C(P, cc)``: role name -> a floor
    that every enumerated plan *in that role* must at least pay, knob
    values included (see :func:`cluster_floor_time` for the derivation —
    the cluster floor is exactly the minimum over these values).  The
    plan searcher's dominance pool (``choose_plan(search="batched")``)
    uses the per-role resolution to skip whole structure groups whose
    role floor already loses to a feasible incumbent.

    ``fusion="search"`` makes the floors sound over the fusion-widened
    plan space: :func:`repro_torch.core.planner.reference_plans` then yields a
    second, traffic-minimal ``fusion="full"`` representative per role and
    the per-name ``min`` below keeps whichever bounds lower — "full"
    members are no longer under-bounded by an off-only rep."""
    vpu_peak = cc.chip.peak("float32") * VPU_FRACTION
    ici_bw_best = cc.ici_bw_eff * cc.max_ici_links
    # The wire discount must match the most generous overlap any plan can
    # earn — per fabric, because a calibrated profile may hide more ICI
    # than DCN time (or vice versa).  Overlap-enabled plans are costed
    # under with_overlap(OVERLAP_FRACTION), whose cc.overlap(fabric)
    # resolves the calibrated per-fabric value; uncalibrated both fabrics
    # give exactly OVERLAP_FRACTION and the lumped pre-calibration form is
    # kept bit-identical.
    occ = cc.with_overlap(OVERLAP_FRACTION)
    o_ici, o_dcn = occ.overlap("ici"), occ.overlap("dcn")
    floors: Dict[str, float] = {}
    for name, t, pp_s in _floor_totals(arch, shape, cc.mesh_shape,
                                       cc.mesh_axes, fusion):
        t_flops = sum(f / (cc.chip.peak(dt) * cc.mxu_util_ceiling(dt))
                      for dt, f in t.mxu_flops.items())
        t_flops += t.vpu_flops / vpu_peak
        t_mem = t.hbm_bytes / cc.hbm_bw_eff
        if pp_s > 1:
            cand = (max(t_flops, t_mem) / pp_s
                    * (1.0 + (pp_s - 1) / MAX_MICROBATCHES))
        else:
            if o_ici == o_dcn:
                t_coll = (t.ici_bytes / ici_bw_best
                          + t.dcn_bytes / cc.dcn_bw_eff) * (1.0 - o_ici)
            else:
                t_coll = (t.ici_bytes / ici_bw_best * (1.0 - o_ici)
                          + t.dcn_bytes / cc.dcn_bw_eff * (1.0 - o_dcn))
            cand = max(t_flops, t_mem) + t_coll
        floors[name] = min(floors.get(name, float("inf")), cand)
    return floors


def cluster_floor_time(arch: ArchConfig, shape: ShapeConfig,
                       cc: ClusterConfig) -> float:
    """A sound lower bound on ``C(P, cc)`` over every enumerated plan P.

    For each axis-role class, the estimator charges its reference plan a
    set of per-device totals that every plan in the class must at least
    match (see :func:`repro_torch.core.planner.reference_plans`).  The estimator
    prices those totals as a *sum over instructions* of
    ``max(t_flops, t_mem)`` plus collectives at
    ``(wire/link_bw + hops·latency) · (1 − overlap)`` plus nonnegative
    IO/latency terms; this floor keeps only

      ``max(Σ t_flops, Σ t_mem)
        + wire_ici/ici_bw_best · (1 − o_ici)
        + wire_dcn/dcn_bw_eff · (1 − o_dcn)``

    at the most generous rates (the per-dtype MXU ceiling
    ``cc.mxu_util_ceiling`` for every MXU op, effective link bandwidths at
    the mesh's *best* per-axis link count, no phase latency, the
    per-fabric overlap discount o_ici/o_dcn of an overlap-*enabled* plan),
    each a term-wise lower bound of what the estimator charges.  The
    per-fabric split matters once a :class:`CalibrationProfile` fits
    different overlap for ICI and DCN: lumping both fabrics under one
    discount would over- or under-discount one of them.  Every rate above
    consults ``cc.calibration`` exactly as the estimator does, so the
    floor stays a term-wise bound under ANY profile — and with fitted
    factors ≤ 1 each calibrated rate only drops below its hand-set value,
    never above peak (see docs/COST_MODEL.md §Calibration).
    On a 3D-torus mesh the estimator prices each ICI axis at up to
    ``ici_bw_eff · axis_links`` (wrapped rings expose 2 links), so the
    floor divides the pooled ICI wire volume by ``ici_bw_eff ·
    max_ici_links`` — never charging more for the wire than any actual
    axis assignment could.  2D meshes have ``max_ici_links == 1`` and keep
    the pre-torus floor bit-identical.  The minimum over role classes then
    bounds the whole plan space — including memory-bound decode cells,
    whose unavoidable tensor-parallel collectives now tighten the floor
    instead of being ignored.

    **Pipelined roles** overlap stage times, so their reference totals —
    which sum work over every stage, as the estimator's sequential-weight
    aggregation must — would overstate a pipelined plan's time if priced
    as one roofline.  For a role with S stages the schedule satisfies

        T  =  Σ_s T_s,first + (M-1) · max_s T_s,warm
           >= R/M + (M-1)/M · R/S  =  (R/S) · (1 + (S-1)/M)

    where R is the roofline of the role's (microbatch-invariant) totals:
    a microbatch's stage times sum to at least its roofline R/M, and the
    slowest of S stages is at least 1/S of their sum.  The bound is
    decreasing in M, so evaluating it at the knob ceiling
    ``MAX_MICROBATCHES`` lower-bounds every enumerable M.  The role's
    nonnegative p2p/collective time is dropped (a floor may only err
    low), so the pipeline floor can only *drop* below the sequential
    roofline where pipelining genuinely helps — verified by full plan
    enumeration in tests/test_pipeline.py."""
    return min(role_floor_times(arch, shape, cc).values(),
               default=float("inf"))


# ---------------------------------------------------------------------------
# Job-level pricing ($/job: amortized startup, restore, preemption)
# ---------------------------------------------------------------------------

# Bytes written per parameter into a training checkpoint: fp32 master
# weights + the two fp32 Adam moments.  Analytical constant (R1), like the
# chip table.
CHECKPOINT_BYTES_PER_PARAM = 12.0


def checkpoint_bytes(arch: ArchConfig) -> float:
    """Total checkpoint size (bytes) for one architecture."""
    return arch.param_counts()["total"] * CHECKPOINT_BYTES_PER_PARAM


def _checkpoint_path_seconds(cc: ClusterConfig, arch: ArchConfig) -> float:
    """Seconds to move one checkpoint across the disk <-> PCIe path, each
    host handling its own shard — the shared derivation behind both the
    restore and the write term of job pricing (the path is symmetric)."""
    per_dev = checkpoint_bytes(arch) / max(cc.num_chips, 1)
    return per_dev / cc.chip.disk_bw + per_dev / cc.chip.pcie_bw


def checkpoint_restore_seconds(cc: ClusterConfig,
                               arch: Optional[ArchConfig] = None) -> float:
    """Seconds to read + reshard one checkpoint onto the cluster.

    Derived from the architecture's checkpoint bytes over the disk + PCIe
    path, sharded across the cluster's chips (each host restores its own
    shard) — so job pricing scales with model size instead of charging a
    0.5B model and a 671B model the same constant.  A non-``None``
    ``cc.checkpoint_restore_seconds`` overrides the derivation (backward
    compatibility); with no architecture in hand the old constant is the
    fallback."""
    if cc.checkpoint_restore_seconds is not None:
        return float(cc.checkpoint_restore_seconds)
    if arch is None:
        return DEFAULT_CHECKPOINT_RESTORE_SECONDS
    return _checkpoint_path_seconds(cc, arch)


def checkpoint_write_seconds(cc: ClusterConfig,
                             arch: Optional[ArchConfig] = None) -> float:
    """Seconds the job stalls to write one checkpoint (device -> host ->
    disk, each host writing its own shard).  Symmetric to
    :func:`checkpoint_restore_seconds`'s derivation; with no architecture
    in hand there are no bytes to price, so the stall is 0 (the pre-PR-5
    behavior for anonymous callers)."""
    if arch is None:
        return 0.0
    return _checkpoint_path_seconds(cc, arch)


def job_seconds(cc: ClusterConfig, step_time: float,
                steps_per_job: int = DEFAULT_STEPS_PER_JOB,
                arch: Optional[ArchConfig] = None) -> float:
    """Expected wall-clock seconds to complete ``steps_per_job`` steps.

    The base time is ``startup + compute + checkpoint-write stalls``
    (one :func:`checkpoint_write_seconds` stall every
    ``checkpoint_interval_steps``).  Preemptions arrive at a rate
    proportional to *wall* time — a job inflated by restarts is exposed
    to further preemptions during those restarts — so the expectation is
    the fixpoint ``wall = base + λ·wall·restart`` with
    ``λ = preemption_rate_per_chip_hour · num_chips / 3600`` (per wall
    second) and ``restart = startup + checkpoint restore
    (:func:`checkpoint_restore_seconds`, per-arch bytes over disk/PCIe
    when ``arch`` is given) + half a checkpoint interval of recomputed
    steps``.  The closed form of the geometric restart series is

        wall = base / (1 - λ · restart),

    diverging to ``inf`` when ``λ · restart >= 1`` (each restart breeds
    at least one more preemption — the job never finishes; such configs
    rank after every finite one).

    Strictly increasing in ``step_time`` for a fixed cluster — base and
    restart both grow with it, so the inflation factor does too — which
    is what lets the job-cost objective prune clusters by their step-time
    floor (:func:`cluster_floor_time`) without losing soundness."""
    steps = max(int(steps_per_job), 1)
    compute = step_time * steps
    n_checkpoints = steps // max(int(cc.checkpoint_interval_steps), 1)
    base = (cc.job_startup_seconds + compute
            + n_checkpoints * checkpoint_write_seconds(cc, arch))
    restart = (cc.job_startup_seconds + checkpoint_restore_seconds(cc, arch)
               + 0.5 * cc.checkpoint_interval_steps * step_time)
    lam = cc.preemption_rate_per_chip_hour * cc.num_chips / 3600.0
    denom = 1.0 - lam * restart
    if denom <= 0.0:
        return float("inf")
    return base / denom


def job_dollars(cc: ClusterConfig, step_time: float,
                steps_per_job: int = DEFAULT_STEPS_PER_JOB,
                arch: Optional[ArchConfig] = None) -> float:
    """$ to complete a job: expected wall seconds x chips x $/chip-hour."""
    return (job_seconds(cc, step_time, steps_per_job, arch) * cc.num_chips
            * cc.chip.cost_per_chip_hour / 3600.0)


# ---------------------------------------------------------------------------
# Decisions + ranking
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResourceDecision:
    """One cluster candidate's outcome: its best plan (or why it was pruned)
    plus the objective values the ranking uses."""

    cluster_id: str
    cc: ClusterConfig
    decision: Optional[PlanDecision]        # None when pruned before costing
    floor_time: float
    pruned: str = ""                        # non-empty: skipped, why
    search: Optional[SearchStats] = None
    steps_per_job: int = DEFAULT_STEPS_PER_JOB
    arch: Optional[ArchConfig] = None       # prices per-arch restore time

    @property
    def time(self) -> float:
        return self.decision.time if self.decision else float("inf")

    @property
    def feasible(self) -> bool:
        return bool(self.decision and self.decision.feasible)

    @property
    def device_seconds(self) -> float:
        return self.time * self.cc.num_chips

    @property
    def cost_per_step(self) -> float:
        """$ per step: device-seconds priced at cost_per_chip_hour."""
        return self.device_seconds * self.cc.chip.cost_per_chip_hour / 3600.0

    @property
    def job_seconds(self) -> float:
        """Expected wall seconds for a ``steps_per_job``-step job."""
        return job_seconds(self.cc, self.time, self.steps_per_job, self.arch)

    @property
    def cost_per_job(self) -> float:
        """$ per job, overheads amortized (see :func:`job_dollars`)."""
        return job_dollars(self.cc, self.time, self.steps_per_job, self.arch)

    def meets(self, slo: Optional[float]) -> bool:
        return self.feasible and slo is not None and self.time <= slo

    def describe(self) -> str:
        if self.pruned:
            return f"{self.cluster_id}: pruned ({self.pruned})"
        return (f"{self.cluster_id}: {self.decision.plan.describe()} "
                f"T={self.time * 1e3:.2f}ms ${self.cost_per_step:.4f}/step "
                f"${self.cost_per_job:.2f}/job")


@dataclasses.dataclass
class ResourceSearchStats:
    """Observability for one co-search: how much of the (cluster x plan)
    space was actually evaluated."""

    clusters_total: int = 0
    clusters_costed: int = 0
    clusters_pruned: int = 0
    plan_evals: int = 0                 # full generate+cost evaluations run
    exhaustive_plan_space: int = 0      # sum over clusters of |enumerate_plans|
    cache: Optional[CacheStats] = None
    # per-worker local-cache traffic of the jobs>1 warm phase (unset when
    # the search ran serially); the driver's own traffic is in `cache`
    worker_cache: Optional[List[CacheStats]] = None

    @property
    def evals_ratio(self) -> float:
        """How many times fewer evaluations than the exhaustive scan."""
        return self.exhaustive_plan_space / max(self.plan_evals, 1)

    def describe(self) -> str:
        bits = [f"clusters={self.clusters_costed}/{self.clusters_total}",
                f"evals={self.plan_evals}/{self.exhaustive_plan_space}"
                f"({self.evals_ratio:.1f}x)"]
        if self.cache is not None:
            bits.append(f"cache={self.cache.hits}/"
                        f"{self.cache.hits + self.cache.misses}")
        if self.worker_cache:
            agg = self.worker_cache[0]
            for w in self.worker_cache[1:]:
                agg = agg + w
            bits.append(f"workers={len(self.worker_cache)}"
                        f"({agg.hits}/{agg.hits + agg.misses})")
        return " ".join(bits)


def _canon_objective(objective: str, slo: Optional[float]) -> str:
    key = _OBJECTIVE_ALIASES.get(objective)
    if key is None:
        if OBJECTIVE_ALIASES.get(objective) in SERVING_OBJECTIVES:
            raise ValueError(
                f"objective {objective!r} ranks serving schedules; pass a "
                f"ServeWorkload as the shape (see repro_torch.core.serving)")
        raise ValueError(f"unknown objective {objective!r}; "
                         f"one of {sorted(set(_OBJECTIVE_ALIASES))}")
    if key == "slo" and slo is None:
        raise ValueError("objective 'slo' needs a step-time target (slo=...)")
    return key


def _rank_key(objective: str, slo: Optional[float]):
    def key(rd: ResourceDecision) -> Tuple:
        if rd.pruned:
            return (1, 0, rd.floor_time, 0.0, rd.cluster_id)
        if objective == "step_time":
            vals: Tuple = (rd.time, rd.cost_per_step)
        elif objective == "cost":
            vals = (rd.cost_per_step, rd.time)
        elif objective == "job_cost":
            vals = (rd.cost_per_job, rd.time)
        else:
            vals = (0 if rd.meets(slo) else 1, rd.cost_per_step, rd.time)
        return (0, 0 if rd.feasible else 1) + vals + (rd.cluster_id,)
    return key


def _floor_cannot_win(objective: str, slo: Optional[float],
                      incumbent: ResourceDecision, cc: ClusterConfig,
                      floor_t: float, steps_per_job: int,
                      arch: Optional[ArchConfig] = None) -> bool:
    """Sound pruning test: could ANY plan on this cluster outrank the
    (feasible) incumbent?  Uses strict inequalities so exact ties are still
    costed and resolved by the deterministic tie-break.  For the job-cost
    objective the step-time floor maps through :func:`job_dollars` (with
    the same per-arch restore pricing the ranking uses), which is strictly
    increasing in step time, so the mapped value is still a lower bound on
    any plan's $/job."""
    floor_cost = floor_t * cc.num_chips * cc.chip.cost_per_chip_hour / 3600.0
    if objective == "step_time":
        return floor_t > incumbent.time
    if objective == "cost":
        return floor_cost > incumbent.cost_per_step
    if objective == "job_cost":
        return (job_dollars(cc, floor_t, steps_per_job, arch)
                > incumbent.cost_per_job)
    if incumbent.meets(slo):
        return floor_t > slo or floor_cost > incumbent.cost_per_step
    return floor_t > slo and floor_cost > incumbent.cost_per_step


def _visit_order_key(objective: str, slo: Optional[float],
                     steps_per_job: int, arch: Optional[ArchConfig] = None):
    def key(entry) -> Tuple:
        cand, floor_t = entry
        floor_cost = (floor_t * cand.cc.num_chips
                      * cand.cc.chip.cost_per_chip_hour / 3600.0)
        if objective == "step_time":
            return (floor_t, floor_cost, cand.cid)
        if objective == "cost":
            return (floor_cost, floor_t, cand.cid)
        if objective == "job_cost":
            return (job_dollars(cand.cc, floor_t, steps_per_job, arch),
                    floor_t, cand.cid)
        return (0 if (slo is None or floor_t <= slo) else 1,
                floor_cost, floor_t, cand.cid)
    return key


# ---------------------------------------------------------------------------
# The co-search
# ---------------------------------------------------------------------------


def optimize_resources(arch: ArchConfig,
                       shape: Union[ShapeConfig, TrainWorkload,
                                    ServeWorkload],
                       clusters: Optional[Sequence] = None,
                       objective: Union[str, Objective] = "step_time",
                       slo: Optional[float] = None, *,
                       search: str = "beam", beam_width: int = 4,
                       prune: Optional[bool] = None,
                       steps_per_job: int = DEFAULT_STEPS_PER_JOB,
                       cache: Optional[PlanCostCache] = None,
                       stats: Optional[ResourceSearchStats] = None,
                       jobs: int = 1) -> List[ResourceDecision]:
    """Rank cluster candidates (with their best sharding plan) under an
    objective.

    ``search="beam"`` (default) prunes clusters by their sound cost floor
    and plans by the staged beam; ``search="exhaustive"`` costs every
    (cluster x plan) cell — the verification oracle.  Both return the
    identical winner (gated by tests/benchmarks).  ``steps_per_job`` sizes
    the job the ``job_cost`` objective prices (ignored otherwise).  Pass a
    shared :class:`PlanCostCache` to reuse sub-plan costs across calls and
    a :class:`ResourceSearchStats` to observe how much of the space was
    actually evaluated.

    The workload may be typed: a :class:`TrainWorkload` carries its own
    ``steps_per_job``; a :class:`ServeWorkload` dispatches to
    :func:`repro_torch.core.serving.optimize_serving` (the schedule co-search,
    returning :class:`~repro_torch.core.serving.ServingDecision` rows).  A typed
    :class:`Objective` is accepted anywhere the string spelling is.

    ``jobs`` > 1 warms the cache in parallel first: the search itself
    runs on candidate shards across a worker pool (decisions discarded,
    cache deltas merged), then the serial pass below re-runs against the
    warm cache — incumbent pruning is visit-order dependent, so this is
    how the parallel path stays bit-identical to ``jobs=1``.
    """
    if isinstance(shape, ServeWorkload):
        from repro_torch.core import serving
        return serving.optimize_serving(
            arch, shape, clusters, objective=objective, slo=slo,
            search=search, beam_width=beam_width, prune=prune,
            cache=cache, stats=stats, jobs=jobs)
    if isinstance(shape, TrainWorkload):
        if steps_per_job == DEFAULT_STEPS_PER_JOB:
            steps_per_job = shape.steps_per_job
        shape = shape.shape
    obj = as_objective(objective, slo, steps_per_job)
    slo = obj.slo
    if obj.steps_per_job is not None:
        steps_per_job = obj.steps_per_job
    objective = _canon_objective(obj.kind, slo)
    if prune is None:
        prune = search == "beam"
    cands = [_as_candidate(c) for c in
             (clusters if clusters is not None else enumerate_clusters())]
    if cache is None:
        cache = PlanCostCache()
    if stats is None:
        stats = ResourceSearchStats()
    if jobs > 1 and len(cands) > 1:
        from repro_torch.core import parallel
        stats.worker_cache = parallel.warm_shards(
            "resource", arch, shape, cands,
            dict(objective=objective, slo=slo, search=search,
                 beam_width=beam_width, prune=prune,
                 steps_per_job=steps_per_job),
            jobs, cache)
    entries = [(cand, cluster_floor_time(arch, shape, cand.cc))
               for cand in cands]
    stats.clusters_total += len(entries)
    stats.exhaustive_plan_space += sum(
        _plan_space_size(arch, shape, cand.cc.mesh_shape, cand.cc.mesh_axes)
        for cand, _ in entries)
    if prune:
        entries.sort(key=_visit_order_key(objective, slo, steps_per_job,
                                          arch))
    key = _rank_key(objective, slo)
    pool = DominancePool(
        rank_key=key,
        cannot_win=(lambda bound, best: _floor_cannot_win(
            objective, slo, best, bound[0].cc, bound[1], steps_per_job,
            arch)) if prune else None)
    out: List[ResourceDecision] = []
    for cand, floor_t in entries:
        if not pool.admit((cand, floor_t)):
            stats.clusters_pruned += 1
            out.append(ResourceDecision(
                cand.cid, cand.cc, None, floor_t,
                pruned=f"floor {floor_t * 1e3:.2f}ms loses to "
                       f"{pool.best.cluster_id}",
                steps_per_job=steps_per_job, arch=arch))
            continue
        pstats = SearchStats()
        best = choose_plan(arch, shape, cand.cc, top_k=1, search=search,
                           beam_width=beam_width, cache=cache,
                           stats=pstats)[0]
        stats.plan_evals += pstats.costed
        stats.clusters_costed += 1
        rd = ResourceDecision(cand.cid, cand.cc, best, floor_t, search=pstats,
                              steps_per_job=steps_per_job, arch=arch)
        out.append(rd)
        if rd.feasible:
            pool.offer(rd)
    stats.cache = cache.stats()
    out.sort(key=key)
    return out


def format_decisions(decisions: Sequence[ResourceDecision],
                     slo: Optional[float] = None) -> str:
    """Fixed-width ranked table for examples / EXPLAIN output."""
    header = (f"{'#':>3} {'cluster':24} {'chips':>6} {'step':>10} "
              f"{'$/step':>9} {'$/job':>9} {'feas':>4}  "
              f"{'chosen plan':40} {'search':28}")
    lines = [header, "-" * len(header)]
    for i, rd in enumerate(decisions, 1):
        if rd.pruned:
            lines.append(f"{i:>3} {rd.cluster_id:24} "
                         f"{rd.cc.num_chips:>6} {'--':>10} {'--':>9} "
                         f"{'--':>9} {'cut':>4}  pruned: {rd.pruned[:56]}")
            continue
        feas = "y" if rd.feasible else "OOM"
        if slo is not None:
            feas = "slo" if rd.meets(slo) else feas
        lines.append(
            f"{i:>3} {rd.cluster_id:24} {rd.cc.num_chips:>6} "
            f"{rd.time * 1e3:9.2f}ms {rd.cost_per_step:9.5f} "
            f"{rd.cost_per_job:9.2f} {feas:>4}  "
            f"{rd.decision.plan.describe():40} "
            f"{rd.search.describe() if rd.search else '':28}")
    return "\n".join(lines)
