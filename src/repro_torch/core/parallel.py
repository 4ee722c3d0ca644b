"""Process-parallel plan search over mergeable plan-cost caches.

The grid loops (``SweepEngine.sweep``, ``optimize_resources``,
``optimize_serving``) are embarrassingly parallel *between* cells and
candidates, and the :class:`~repro_torch.core.costmodel.PlanCostCache` is
mergeable (keys embed every input to a walk, see COST_MODEL.md).  This
module combines the two:

  * work is sharded deterministically in **cache-affinity order** —
    specs are grouped by an affinity key (arch x shape for sweeps) and
    whole groups are greedy-packed onto shards heaviest-first, so
    structure-sharing cells land on one worker and shard loads balance;
  * each **spawn**-based worker costs its shard against a local cache
    seeded from a snapshot of the driver's cache, then returns its
    results plus :meth:`~repro_torch.core.costmodel.PlanCostCache.export_delta`
    (only the entries it recorded, not the seed);
  * the driver merges deltas back into the long-lived engine cache in
    shard order — merge is order-independent, the fixed order just keeps
    entry iteration deterministic.

Workers are plain importable functions (the ``spawn`` start method
re-imports this module in the child — never define pool workers in
``__main__``).  ``fork`` is deliberately not used: a parent that has
initialised CUDA may hold unforkable state, and spawn children import only
``repro_torch.core`` (numpy and the standard library: no torch, no CUDA).

Two parallel shapes are offered:

  * :func:`sweep_shards` — sweep cells are independent, so workers return
    their costed cells directly and the driver just reassembles the grid.
  * :func:`warm_shards` — ``optimize_resources``/``optimize_serving``
    prune against a shared incumbent, which is visit-order dependent; a
    parallel run therefore only *warms the cache* on candidate shards and
    the caller re-runs the unchanged serial search against the warm cache.
    Replays are exact, so the serial pass reproduces the serial ranked
    table bit-for-bit while every expensive plan walk is a cache hit.
"""
from __future__ import annotations

import multiprocessing
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import CacheDelta, CacheStats, PlanCostCache

__all__ = ["default_jobs", "shard_specs", "sweep_shards", "warm_shards"]


def default_jobs() -> int:
    """Usable CPU count (cgroup/affinity aware where the OS exposes it)."""
    try:
        return max(len(os.sched_getaffinity(0)), 1)
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def shard_specs(specs: Sequence, jobs: int,
                key: Optional[Callable] = None,
                weight: Optional[Callable] = None) -> List[List]:
    """Deterministically shard ``specs`` onto at most ``jobs`` shards.

    Specs with the same affinity ``key`` always share a shard (cache
    affinity: they are the ones that can share plan-cost entries), and
    groups are packed heaviest-first onto the least-loaded shard
    (``weight`` per spec, default 1) so one expensive group does not
    serialize the pool.  Ties break on first-appearance order, making the
    sharding a pure function of the spec list.
    """
    jobs = max(int(jobs), 1)
    if weight is None:
        weight = lambda s: 1.0     # noqa: E731
    order: List = []
    groups: Dict = {}
    for i, s in enumerate(specs):
        k = key(s) if key is not None else i   # no key: one group per spec
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(s)
    ranked = sorted(range(len(order)),
                    key=lambda i: (-sum(weight(s) for s in groups[order[i]]),
                                   i))
    shards: List[List] = [[] for _ in range(min(jobs, len(order)))]
    loads = [0.0] * len(shards)
    for i in ranked:
        k = order[i]
        j = min(range(len(shards)), key=lambda j: (loads[j], j))
        shards[j].extend(groups[k])
        loads[j] += sum(weight(s) for s in groups[k])
    return [s for s in shards if s]


# --------------------------------------------------------------- plumbing
def _snapshot(cache: Optional[PlanCostCache]) -> Optional[str]:
    if cache is None or not cache.entries:
        return None
    fd, path = tempfile.mkstemp(prefix="plancache-", suffix=".pkl")
    os.close(fd)
    cache.save(path)
    return path


def _pool_map(worker: Callable, jobs_args: List[Tuple]) -> List:
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=len(jobs_args)) as pool:
        return pool.map(worker, jobs_args)


# ------------------------------------------------------------ sweep cells
def _sweep_worker(args: Tuple):
    (widx, indexed_specs, search, beam_width, max_entries, snapshot) = args
    from repro_torch.core.sweep import SweepEngine
    cache = PlanCostCache(max_entries=max_entries)
    if snapshot:
        cache.load_from(snapshot)
    cache.mark()    # the delta must exclude the seed entries
    engine = SweepEngine(search=search, beam_width=beam_width, cache=cache)
    cells = []
    for pos, (arch, shape, cluster) in indexed_specs:
        cell = engine.cost_cell(arch, shape, cluster)
        cell.worker = widx
        cells.append((pos, cell))
    # lean: the driver deserializes every worker's delta serially, so the
    # wire delta carries only block entries (see export_delta docstring)
    return widx, cells, cache.export_delta(lean=True)


def sweep_shards(specs: Sequence[Tuple], jobs: int, *,
                 search: str, beam_width: int,
                 max_entries: Optional[int] = None,
                 seed_cache: Optional[PlanCostCache] = None,
                 seed_path: Optional[str] = None,
                 key: Optional[Callable] = None,
                 weight: Optional[Callable] = None,
                 ) -> Tuple[List, List[CacheDelta], List[CacheStats]]:
    """Cost ``(arch, shape, cluster)`` sweep specs across a worker pool.

    Returns ``(cells, deltas, worker_stats)`` with cells in the input spec
    order (cell costing is cache-state independent, so the assembled grid
    is identical to a serial pass).  The caller merges the deltas.

    ``seed_path`` seeds workers from an existing snapshot file instead of
    re-serializing ``seed_cache`` — pass it when the cache is unchanged
    since it was loaded from that very file.
    """
    indexed = list(enumerate(specs))
    shards = shard_specs(
        indexed, jobs,
        key=None if key is None else (lambda p: key(p[1])),
        weight=None if weight is None else (lambda p: weight(p[1])))
    snapshot = seed_path if seed_path else _snapshot(seed_cache)
    try:
        results = _pool_map(_sweep_worker, [
            (i, shard, search, beam_width, max_entries, snapshot)
            for i, shard in enumerate(shards)])
    finally:
        if snapshot and not seed_path:
            os.unlink(snapshot)
    results.sort(key=lambda r: r[0])
    cells: List = [None] * len(indexed)
    for _widx, shard_cells, _delta in results:
        for pos, cell in shard_cells:
            cells[pos] = cell
    deltas = [delta for _, _, delta in results]
    return cells, deltas, [d.stats for d in deltas]


# ------------------------------------------------- resource/serving warm
def _warm_worker(args: Tuple):
    (widx, kind, arch, shape, cands, kwargs, snapshot) = args
    cache = PlanCostCache()
    if snapshot:
        cache.load_from(snapshot)
    cache.mark()
    if kind == "serving":
        from repro_torch.core.serving import optimize_serving
        optimize_serving(arch, shape, cands, cache=cache, **kwargs)
    else:
        from repro_torch.core.resource import optimize_resources
        optimize_resources(arch, shape, cands, cache=cache, **kwargs)
    return widx, cache.export_delta(lean=True)


def warm_shards(kind: str, arch, shape, cands: Sequence, kwargs: dict,
                jobs: int, cache: PlanCostCache,
                key: Optional[Callable] = None,
                weight: Optional[Callable] = None) -> List[CacheStats]:
    """Warm ``cache`` for a resource/serving co-search by running the
    search itself on candidate shards in parallel and merging back only
    the cache deltas.  Each worker prunes against its own shard-local
    incumbent — decisions are discarded, so per-shard pruning differences
    cannot leak into the caller's serial pass.  Returns per-worker
    lookup-traffic stats."""
    shards = shard_specs(cands, jobs, key=key, weight=weight)
    snapshot = _snapshot(cache)
    try:
        results = _pool_map(_warm_worker, [
            (i, kind, arch, shape, shard, kwargs, snapshot)
            for i, shard in enumerate(shards)])
    finally:
        if snapshot:
            os.unlink(snapshot)
    results.sort(key=lambda r: r[0])
    for _, delta in results:
        cache.merge(delta)
    return [delta.stats for _, delta in results]
