"""Scenario sweep engine: cost a grid of (config x shape x cluster).

The ROADMAP's north star — "as fast as the hardware allows, as many
scenarios as you can imagine" — needs plan costing cheap enough to run for
*every* scenario an operator can dream up, not just the one in front of
them.  This module turns the plan-search stack into exactly that: a grid
of (architecture x input shape x cluster config) cells, each resolved to
its best sharding plan by :func:`repro_torch.core.planner.choose_plan`, all
sharing one :class:`repro_torch.core.costmodel.PlanCostCache` so sub-plans that
repeat across scenarios (per-layer loop bodies, shared program prefixes,
same-arch candidates under different knobs) are costed exactly once.

The output is a ranked table — fastest feasible step time first, OOM
cells sunk to the bottom, skipped cells (assignment rules) last — plus
per-cell search statistics so regressions in pruning or cache behavior
are visible in benchmarks and CI.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.cluster import (TPU_V5P, TPU_V6E, ClusterConfig,
                                      multi_pod_config, single_pod_config,
                                      torus_3d_config)
from repro_torch.core.costmodel import CacheStats, PlanCostCache
from repro_torch.core.planner import PlanDecision, SearchStats, choose_plan
from repro_torch.core.resource import (DEFAULT_STEPS_PER_JOB, ClusterCandidate,
                                       ResourceDecision, ResourceSearchStats,
                                       optimize_resources, torus_links_for)
from repro_torch.core.workload import (SERVE_WORKLOADS, Objective, ServeWorkload,
                                       TrainWorkload)

# Named cluster shorthands accepted anywhere a cluster is given (pure
# dataclass constants — building them never touches jax device state).
CLUSTERS: Dict[str, ClusterConfig] = {
    "pod": single_pod_config(),
    "2pod": multi_pod_config(),
    "v5p-pod": ClusterConfig(chip=TPU_V5P, mesh_shape=(8, 8),
                             mesh_axes=("data", "model")),
    "v6e-pod": ClusterConfig(chip=TPU_V6E, mesh_shape=(16, 16),
                             mesh_axes=("data", "model")),
    # One v5p pod slice laid out as its native 3D torus: three ICI axes
    # ("data", "model", "depth"), wrapped rings with 2 links per axis.
    "v5p-3d": torus_3d_config((4, 4, 4)),
    # Four v5p slices joined over DCN — the pipeline-over-DCN scenario:
    # the "pod" axis can carry pipeline stages whose boundaries pay one
    # p2p activation hop per microbatch instead of pod-phased collectives,
    # and per-stage resident state drops S-fold (which is what lets
    # frontier-dense training fit here at all).
    "v5p-dcn": ClusterConfig(chip=TPU_V5P, mesh_shape=(4, 8, 8),
                             mesh_axes=("pod", "data", "model")),
    # The 4-axis family: pod over a full 3D inner torus (wrapped rings on
    # every full-cube inner axis, derived by the same rule the candidate
    # enumeration uses).
    "v5p-dcn-3d": ClusterConfig(
        chip=TPU_V5P, mesh_shape=(4, 4, 4, 4),
        mesh_axes=("pod", "data", "model", "depth"),
        torus_links=torus_links_for(("pod", "data", "model", "depth"),
                                    TPU_V5P, (4, 4, 4, 4))),
}


@dataclasses.dataclass
class SweepCell:
    """One costed scenario: the chosen plan plus search observability."""

    arch_id: str
    shape_id: str
    cluster_id: str
    decision: Optional[PlanDecision]     # None when the cell was skipped
    stats: Optional[SearchStats]
    elapsed_s: float = 0.0
    skipped: str = ""                    # non-empty: why the cell was skipped
    worker: int = -1                     # pool worker that costed it (-1: driver)

    @property
    def key(self) -> str:
        return f"{self.arch_id}|{self.shape_id}|{self.cluster_id}"

    @property
    def time(self) -> float:
        return self.decision.time if self.decision else float("inf")

    @property
    def feasible(self) -> bool:
        return bool(self.decision and self.decision.feasible)


class SweepEngine:
    """Costs scenario grids through one shared sub-plan cache.

    The engine is long-lived by design: successive :meth:`sweep` calls
    (new shapes, a what-if cluster, one more architecture) keep hitting
    the same cache, so the marginal cost of a new scenario drops toward
    the cache-replay floor rather than paying full plan-walk price.

    ``search`` selects the per-cell plan search: ``"beam"`` (default),
    ``"exhaustive"``, or ``"batched"`` — the vectorized engine that walks
    each structure signature once with the whole knob grid as lane
    vectors and prunes provably-dominated groups by their role floors
    (see :func:`repro_torch.core.planner.choose_plan`); its winners are
    bit-identical to the exhaustive scan, so swapping it in never moves a
    sweep's golden results.

    ``jobs`` > 1 costs sweep cells over a spawn-based worker pool
    (:mod:`repro_torch.core.parallel`): workers get a snapshot of the engine
    cache, cost their cache-affinity shard locally, and the driver merges
    their deltas back — the ranked table is identical to a serial sweep
    because cell costing is cache-state independent.  ``cache_path``
    makes the cache persistent: loaded (if fresh — see
    :func:`repro_torch.core.costmodel.cost_model_fingerprint`) at construction
    and re-saved after every sweep, so the next process starts warm.
    ``max_entries`` bounds the cache (clock-hand eviction, bit-exact).
    """

    def __init__(self, search: str = "beam", beam_width: int = 4,
                 cache: Optional[PlanCostCache] = None, jobs: int = 1,
                 cache_path: Optional[str] = None,
                 max_entries: Optional[int] = None):
        self.search = search
        self.beam_width = beam_width
        self.jobs = max(int(jobs), 1)
        self.cache_path = cache_path
        self.max_entries = max_entries
        self.cache = (cache if cache is not None
                      else PlanCostCache(max_entries=max_entries))
        self._persisted_seq = None   # cache._seq as of cache_path on disk
        if cache_path:
            preloaded = self.cache.entries
            loaded = self.cache.load_from(cache_path)
            if preloaded == 0 and loaded > 0:
                # memory now mirrors disk exactly — until something is
                # recorded, workers can seed from the file directly and
                # save_cache() has nothing new to write
                self._persisted_seq = self.cache._seq
        # Per-worker lookup traffic of the last parallel sweep; [] after a
        # serial sweep (the engine cache's own counters already tell all).
        self.last_worker_stats: List[CacheStats] = []

    def cost_cell(self, arch: Union[str, ArchConfig],
                  shape: Union[str, ShapeConfig, ServeWorkload],
                  cluster: Union[str, ClusterConfig],
                  top_k: int = 1) -> SweepCell:
        arch_id, arch = _resolve_arch(arch)
        shape_id, shape = _resolve_shape(shape)
        cluster_id, cc = _resolve_cluster(cluster)
        # Marginal attribution against this engine's own cache is sound
        # because an engine (driver or pool worker) owns its cache
        # exclusively — parallel sweeps give every worker a *local*
        # engine, so concurrent cells never interleave these counters.
        h0, m0 = self.cache.hits, self.cache.misses
        if isinstance(shape, ServeWorkload):
            # A serving cell: the best costed schedule of this traffic on
            # this cluster, reported as the winning decode-pool decision
            # (feasible additionally requires a *stable* schedule).  No
            # shape_applicable gate — workloads declare their own context.
            from repro_torch.core import serving
            t0 = time.perf_counter()
            decision, stats = serving.serve_cell(
                arch, shape, cc, cluster_id=cluster_id, search=self.search,
                beam_width=self.beam_width, cache=self.cache)
            elapsed = time.perf_counter() - t0
            stats.cache = CacheStats(self.cache.hits - h0,
                                     self.cache.misses - m0,
                                     self.cache.entries)
            return SweepCell(arch_id, shape_id, cluster_id, decision, stats,
                             elapsed)
        ok, why = shape_applicable(arch, shape)
        if not ok:
            return SweepCell(arch_id, shape_id, cluster_id, None, None,
                             skipped=why)
        stats = SearchStats()
        t0 = time.perf_counter()
        decisions = choose_plan(arch, shape, cc, top_k=top_k,
                                search=self.search,
                                beam_width=self.beam_width,
                                cache=self.cache, stats=stats)
        elapsed = time.perf_counter() - t0
        # report this cell's marginal cache traffic, not the shared totals
        stats.cache = CacheStats(self.cache.hits - h0,
                                 self.cache.misses - m0, self.cache.entries)
        return SweepCell(arch_id, shape_id, cluster_id, decisions[0], stats,
                         elapsed)

    def sweep(self, archs: Sequence[Union[str, ArchConfig]],
              shapes: Sequence[Union[str, ShapeConfig]],
              clusters: Sequence[Union[str, ClusterConfig]],
              jobs: Optional[int] = None) -> List[SweepCell]:
        """Cost the full grid and return cells ranked fastest-first
        (feasible before OOM, skipped cells last).

        Cells are visited arch x shape outermost — the cache-affinity
        order: cells of one (arch, shape) stay adjacent and whole groups
        shard onto one worker.  The ranked output is sorted, so visit
        order never moves results.
        """
        jobs = self.jobs if jobs is None else max(int(jobs), 1)
        specs = [(a, s, c) for a in archs for s in shapes for c in clusters]
        if jobs > 1 and len(specs) > 1:
            cells = self._sweep_parallel(specs, jobs)
        else:
            self.last_worker_stats = []
            cells = [self.cost_cell(a, s, c) for a, s, c in specs]
        self.save_cache()
        return rank_cells(cells)

    def _sweep_parallel(self, specs: Sequence[Tuple], jobs: int
                        ) -> List[SweepCell]:
        from repro_torch.core import parallel
        # When the cache is byte-for-byte what cache_path holds (freshly
        # loaded, nothing recorded since), seed workers straight from the
        # file instead of re-serializing ~the whole cache to a temp copy.
        clean = (self.cache_path is not None
                 and self._persisted_seq == self.cache._seq)
        cells, deltas, wstats = parallel.sweep_shards(
            specs, jobs, search=self.search, beam_width=self.beam_width,
            max_entries=self.max_entries, seed_cache=self.cache,
            seed_path=self.cache_path if clean else None,
            key=_spec_affinity, weight=_spec_weight)
        for delta in deltas:
            self.cache.merge(delta)
        self.last_worker_stats = wstats
        return cells

    def save_cache(self) -> None:
        """Persist the engine cache when ``cache_path`` is configured and
        anything was recorded since the last load/save (a fully-warm
        sweep rewrites nothing)."""
        if self.cache_path and self._persisted_seq != self.cache._seq:
            self.cache.save(self.cache_path)
            self._persisted_seq = self.cache._seq

    def traffic_stats(self) -> CacheStats:
        """Honest lookup traffic of the last sweep: the engine cache's own
        counters plus (after a parallel sweep) every worker's local-cache
        traffic, with ``entries`` reporting the merged engine cache."""
        st = self.cache.stats()
        for w in self.last_worker_stats:
            st = st + w
        return CacheStats(st.hits, st.misses, self.cache.entries,
                          st.evictions)

    def optimize_cell(self, arch: Union[str, ArchConfig],
                      shape: Union[str, ShapeConfig, TrainWorkload,
                                   ServeWorkload],
                      clusters: Optional[Sequence] = None,
                      objective: Union[str, Objective] = "step_time",
                      slo: Optional[float] = None,
                      steps_per_job: int = DEFAULT_STEPS_PER_JOB,
                      jobs: Optional[int] = None,
                      ) -> Tuple[List[ResourceDecision], ResourceSearchStats]:
        """The ``--resources`` dimension: instead of costing one fixed
        cluster, co-search the cluster grid for this (arch x shape) through
        the engine's shared sub-plan cache and return the ranked
        :class:`ResourceDecision` table plus search stats.
        ``steps_per_job`` sizes the job priced by ``objective="job_cost"``.
        Typed workloads and objectives pass straight through — a
        :class:`ServeWorkload` makes this the serving schedule co-search
        (:class:`~repro_torch.core.serving.ServingDecision` rows)."""
        _, arch = _resolve_arch(arch)
        if not isinstance(shape, TrainWorkload):
            _, shape = _resolve_shape(shape)
        stats = ResourceSearchStats()
        decisions = optimize_resources(
            arch, shape, clusters, objective=objective, slo=slo,
            search=self.search, beam_width=self.beam_width,
            steps_per_job=steps_per_job, cache=self.cache, stats=stats,
            jobs=self.jobs if jobs is None else jobs)
        self.save_cache()
        return decisions, stats


def rank_cells(cells: Sequence[SweepCell]) -> List[SweepCell]:
    return sorted(cells, key=lambda c: (bool(c.skipped), not c.feasible,
                                        c.time))


def format_table(cells: Sequence[SweepCell]) -> str:
    """Render ranked cells as a fixed-width table (examples / EXPLAIN)."""
    header = (f"{'#':>3} {'scenario':44s} {'step':>10} {'hbm/dev':>8} "
              f"{'feas':>4}  {'chosen plan':40s} {'search':22s}")
    lines = [header, "-" * len(header)]
    for i, c in enumerate(rank_cells(cells), 1):
        if c.skipped:
            lines.append(f"{i:>3} {c.key:44s} {'--':>10} {'--':>8} "
                         f"{'skip':>4}  {c.skipped[:64]}")
            continue
        d = c.decision
        # cells costed on a pool worker report that worker's local cache
        # traffic — label them like sweep_rows does
        where = f" @w{c.worker}" if c.worker >= 0 else ""
        lines.append(
            f"{i:>3} {c.key:44s} {d.time * 1e3:9.1f}ms "
            f"{d.hbm_est / 1e9:7.1f}G {'y' if d.feasible else 'OOM':>4}  "
            f"{d.plan.describe():40s} {c.stats.describe():22s}{where}")
    return "\n".join(lines)


def sweep_rows(cells: Sequence[SweepCell]) -> List[str]:
    """Benchmark-harness rows: ``sweep.<arch>|<shape>|<mesh>,us,derived``.

    The ``cache=h/n`` fragment is the cell's marginal traffic against the
    cache of the engine that costed it; cells costed on a pool worker are
    labelled ``@w<N>`` because those numbers are against worker ``N``'s
    *local* cache, not the merged engine cache."""
    rows = []
    for c in rank_cells(cells):
        if c.skipped:
            rows.append(f"sweep.{c.key},0,SKIP;{c.skipped[:60]}")
            continue
        d = c.decision
        st = c.stats
        where = f"@w{c.worker}" if c.worker >= 0 else ""
        rows.append(
            f"sweep.{c.key},{c.elapsed_s * 1e6:.0f},"
            f"best={d.plan.describe()};T={d.time * 1e3:.2f}ms;"
            f"hbm={d.hbm_est / 1e9:.1f}GB;feas={d.feasible};"
            f"costed={st.costed};pruned={st.pruned_infeasible + st.pruned_dominated};"
            f"cache={st.cache.hits}/{st.cache.hits + st.cache.misses}{where}")
    return rows


def _spec_affinity(spec: Tuple) -> Tuple[str, str]:
    """Shard-affinity key for an ``(arch, shape, cluster)`` sweep spec:
    cells of one (arch, shape) share plan structure signatures, so they
    belong on one worker's cache."""
    arch_id, _ = _resolve_arch(spec[0])
    shape_id, _ = _resolve_shape(spec[1])
    return arch_id, shape_id


def _spec_weight(spec: Tuple) -> float:
    """Relative cost estimate for shard load-balancing: train and serving
    cells walk orders of magnitude more plan than single-token decode
    cells (measured ~10x on the golden grid)."""
    _, shape = _resolve_shape(spec[1])
    if isinstance(shape, ServeWorkload):
        return 8.0
    return 8.0 if getattr(shape, "mode", "train") == "train" else 1.0


def _resolve_arch(arch) -> Tuple[str, ArchConfig]:
    if isinstance(arch, str):
        return arch, get_config(arch)
    return arch.name, arch


def _resolve_shape(shape) -> Tuple[str, Union[ShapeConfig, ServeWorkload]]:
    if isinstance(shape, str):
        if shape in SHAPES:
            return shape, SHAPES[shape]
        if shape in SERVE_WORKLOADS:
            return shape, SERVE_WORKLOADS[shape]
        raise KeyError(f"unknown shape {shape!r}; one of "
                       f"{sorted(SHAPES) + sorted(SERVE_WORKLOADS)}")
    return shape.name, shape


def _resolve_cluster(cluster) -> Tuple[str, ClusterConfig]:
    if isinstance(cluster, str):
        return cluster, CLUSTERS[cluster]
    if isinstance(cluster, ClusterCandidate):
        return cluster.cid, cluster.cc
    label = "x".join(str(s) for s in cluster.mesh_shape)
    return f"{cluster.chip.name}[{label}]", cluster
