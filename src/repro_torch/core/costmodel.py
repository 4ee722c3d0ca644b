"""The cost estimator (paper §3): ``C(P, cc) = T-hat(P)``.

Single recursive pass over the runtime plan in execution order:

  * maintains the live-variable symbol table (sizes + memory state), so IO
    is paid exactly once by the first consumer (§3.2);
  * per-instruction time = latency + IO + compute, with compute =
    max(memory-bandwidth time, FLOP-model time) (§3.3);
  * aggregates over control flow with Eq (1): blocks sum children, loops
    scale by N-hat (first-iteration IO correction applied), parfor divides
    by parallelism, branches take a weighted sum, software-pipelined
    microbatch loops (:class:`repro_torch.core.plan.PipelinedLoopBlock`) pay
    fill/drain plus ``(M-1) * max_stage`` steady state, function-call
    stacks prevent recursion cycles;
  * linearizes everything into one scalar, estimated execution time (R2).

Costs are *per-program-run* wall-clock seconds given a cluster config.

Sub-plan memoization (beyond the paper, in its spirit — §2 argues costing
must be cheap enough to sit inside enumerating optimizers): pass a
:class:`PlanCostCache` to :func:`estimate` and repeated sub-plans — the
per-layer ``ForBlock`` body, shared program prefixes, identical candidates'
common blocks — are costed once and replayed afterwards.  Cache keys are
(structural node signature, symbol-table read-set fingerprint, cluster
fingerprint), so a hit is *exact*: same cost, same symbol-table effects,
same peak-HBM excursion, same work totals.

Alongside the time breakdown, the same walk accumulates
:class:`ProgramTotals` — the charged per-device MXU FLOPs (by dtype), VPU
FLOPs, HBM bytes, and collective wire volume by link class (ICI vs DCN) —
aggregated with exactly the Eq (1) weights the costs use.  Consumers that
need the *work* a program does (the resource optimizer's sound cluster
floors, roofline reports) read it off the costed result instead of
re-walking the plan with hand-mirrored semantics; see
``docs/COST_MODEL.md``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import linalg_ops
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.linalg_ops import (collective_phases, collective_wire,
                                         p2p_cost, p2p_wire)
from repro_torch.core.npvec import (as_payload, dim_int, fmt, is_vec, lane,
                                    lane_count, pmax, uniform_bool)
from repro_torch.core.plan import (
          Block, Call, Collective, Compute, CpVar, CreateVar, DataGen, ForBlock,
          FunctionBlock, GenericBlock, IfBlock, Instruction, IO, JitCall, P2P,
          ParForBlock, PipelinedLoopBlock, Program, RmVar, WhileBlock,
          node_signature,
      )
from repro_torch.core.symbols import MemState, SymbolTable, TensorStat

TINY = 4.7e-9            # bookkeeping-instruction cost (paper Fig. 4 shows 4.7E-9s)
VPU_FRACTION = 0.10      # VPU throughput as a fraction of fp32 MXU peak


class ProgramTotals:
    """Charged work totals of one (sub-)walk — the estimator-native
    counterpart of :class:`CostBreakdown`.

    Where the breakdown holds *time*, the totals hold the quantities the
    time was computed from, aggregated with the same control-flow weights:

      * ``mxu_flops``   — per-device MXU FLOPs by input dtype (after the
                          shard division each Compute was charged with),
      * ``vpu_flops``   — per-device VPU FLOPs,
      * ``hbm_bytes``   — per-device HBM bytes on the compute roofline
                          (op reads+writes and datagen materialization;
                          first-use staging IO is *not* included — it is an
                          IO-term cost, not roofline work),
      * ``ici_bytes`` / ``dcn_bytes`` — collective wire volume per device
                          by link class, *before* the overlap discount.

    Instances are immutable by convention (``__add__``/``scaled`` return
    new objects; :data:`ZERO_TOTALS` is shared), which is what lets
    :class:`PlanCostCache` replay a cached sub-walk's totals bit-exact.
    """

    __slots__ = ("mxu_flops", "vpu_flops", "hbm_bytes", "ici_bytes",
                 "dcn_bytes")

    def __init__(self, mxu_flops: Optional[Dict[str, float]] = None,
                 vpu_flops: float = 0.0, hbm_bytes: float = 0.0,
                 ici_bytes: float = 0.0, dcn_bytes: float = 0.0):
        self.mxu_flops = mxu_flops if mxu_flops is not None else {}
        self.vpu_flops = vpu_flops
        self.hbm_bytes = hbm_bytes
        self.ici_bytes = ici_bytes
        self.dcn_bytes = dcn_bytes

    @property
    def collective_bytes(self) -> float:
        """Total collective wire volume per device (ICI + DCN)."""
        return self.ici_bytes + self.dcn_bytes

    def __add__(self, o: "ProgramTotals") -> "ProgramTotals":
        if self is ZERO_TOTALS:
            return o
        if o is ZERO_TOTALS:
            return self
        mxu = dict(self.mxu_flops)
        for dt, f in o.mxu_flops.items():
            mxu[dt] = mxu.get(dt, 0.0) + f
        return ProgramTotals(mxu, self.vpu_flops + o.vpu_flops,
                             self.hbm_bytes + o.hbm_bytes,
                             self.ici_bytes + o.ici_bytes,
                             self.dcn_bytes + o.dcn_bytes)

    def scaled(self, w: float) -> "ProgramTotals":
        if self is ZERO_TOTALS or (not is_vec(w) and w == 1.0):
            return self
        return ProgramTotals({dt: f * w for dt, f in self.mxu_flops.items()},
                             self.vpu_flops * w, self.hbm_bytes * w,
                             self.ici_bytes * w, self.dcn_bytes * w)

    def as_tuple(self) -> Tuple:
        """Hashable snapshot (sorted dtype pairs) for tests/fingerprints."""
        return (tuple(sorted(self.mxu_flops.items())), self.vpu_flops,
                self.hbm_bytes, self.ici_bytes, self.dcn_bytes)

    def __eq__(self, o) -> bool:
        return isinstance(o, ProgramTotals) and self.as_tuple() == o.as_tuple()

    def __hash__(self) -> int:
        return hash(self.as_tuple())

    def __repr__(self) -> str:
        mxu = sum(self.mxu_flops.values())
        return (f"ProgramTotals(mxu={mxu:.4g}F, vpu={self.vpu_flops:.4g}F, "
                f"hbm={self.hbm_bytes:.4g}B, ici={self.ici_bytes:.4g}B, "
                f"dcn={self.dcn_bytes:.4g}B)")


ZERO_TOTALS = ProgramTotals()


@dataclasses.dataclass
class CostBreakdown:
    """The linearized cost factors (R2): IO, compute, collectives, latency."""

    io: float = 0.0
    compute: float = 0.0
    collective: float = 0.0
    latency: float = 0.0

    @property
    def total(self) -> float:
        return self.io + self.compute + self.collective + self.latency

    def __add__(self, o: "CostBreakdown") -> "CostBreakdown":
        return CostBreakdown(self.io + o.io, self.compute + o.compute,
                             self.collective + o.collective, self.latency + o.latency)

    def scaled(self, w: float) -> "CostBreakdown":
        return CostBreakdown(self.io * w, self.compute * w,
                             self.collective * w, self.latency * w)


@dataclasses.dataclass
class CostedNode:
    """One plan node with its (aggregated) cost — feeds EXPLAIN output.

    ``totals`` carries the subtree's :class:`ProgramTotals`, aggregated with
    the same weights as ``cost`` (loops scale, branches weight, blocks sum),
    so a cached replay of the node reproduces both bit-exact.
    """

    label: str
    cost: CostBreakdown
    children: List["CostedNode"] = dataclasses.field(default_factory=list)
    note: str = ""
    totals: ProgramTotals = ZERO_TOTALS


@dataclasses.dataclass
class CostedProgram:
    """The result of :func:`estimate`: the annotated cost tree, the
    linearized scalar (R2), its four-way breakdown, the peak per-device
    HBM excursion, and the program's charged work totals."""

    root: CostedNode
    total: float
    breakdown: CostBreakdown
    peak_hbm_per_device: float
    totals: ProgramTotals = ZERO_TOTALS

    def __repr__(self) -> str:
        return (f"CostedProgram(total={self.total:.4g}s, io={self.breakdown.io:.4g}, "
                f"compute={self.breakdown.compute:.4g}, coll={self.breakdown.collective:.4g}, "
                f"lat={self.breakdown.latency:.4g}, peak_hbm={self.peak_hbm_per_device/1e9:.3g}GB)")


@dataclasses.dataclass(frozen=True)
class CacheStats:
    hits: int
    misses: int
    entries: int
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def __add__(self, other: "CacheStats") -> "CacheStats":
        """Aggregate lookup traffic across caches (driver + workers).

        hits/misses/evictions sum exactly; ``entries`` sums the reporting
        caches' sizes, which double-counts entries present in several
        worker caches — treat the aggregate's ``entries`` as an upper
        bound on the merged cache's size, or read the merged cache's own
        :meth:`PlanCostCache.stats` for the true count.
        """
        return CacheStats(self.hits + other.hits,
                          self.misses + other.misses,
                          self.entries + other.entries,
                          self.evictions + other.evictions)


class _CacheEntry:
    __slots__ = ("reads", "net", "hbm_delta", "max_rel_hbm", "node",
                 "seq", "ref")

    def __init__(self, reads, net, hbm_delta, max_rel_hbm, node):
        self.reads = reads           # name -> stat sig at first read (or None)
        self.net = net               # name -> final stat (None == removed)
        self.hbm_delta = hbm_delta   # net live-HBM change of the walk
        self.max_rel_hbm = max_rel_hbm
        self.node = node             # the CostedNode produced by the walk
        self.seq = 0                 # insertion tick (delta export watermark)
        self.ref = False             # clock-hand reference bit

    def __getstate__(self):
        # ``ref`` is replacement-policy state, not payload: a freshly
        # loaded entry starts cold.  ``seq`` is reassigned on insert.
        #
        # The wire form is deliberately lean: a parallel driver pays
        # deserialization *serially* for every worker delta, so entry
        # decode cost is on the speedup-critical path.  Two transforms:
        #
        #   * the node's subtree is elided — replay applies the recorded
        #     read/write deltas and the root's cost/totals, never the
        #     children, so costs stay bit-exact; only EXPLAIN depth of
        #     walks replayed from a snapshot shrinks (the root's note
        #     says so);
        #   * payload objects travel as primitive tuples (a TensorStat
        #     as its ``sig``, node cost/totals as field tuples) instead
        #     of pickled class instances — rebuilding from tuples in
        #     ``__setstate__`` is ~2x faster than generic object
        #     unpickling.
        node = self.node
        note = node.note
        if node.children:
            note = ((note + " " if note else "")
                    + "[subtree elided in snapshot]")
        t = node.totals
        tot = (None if t is ZERO_TOTALS else
               (t.mxu_flops, t.vpu_flops, t.hbm_bytes, t.ici_bytes,
                t.dcn_bytes))
        c = node.cost
        return (self.reads,
                {k: (None if v is None else v.sig)
                 for k, v in self.net.items()},
                self.hbm_delta, self.max_rel_hbm,
                (node.label, (c.io, c.compute, c.collective, c.latency),
                 note, tot))

    def __setstate__(self, state):
        reads, net_enc, hbm_delta, max_rel_hbm, node_enc = state
        net = {}
        for k, sig in net_enc.items():
            if sig is None:
                net[k] = None
            else:
                shape, dtype, sparsity, mem, shards = sig
                net[k] = TensorStat(shape, dtype, sparsity,
                                    MemState(mem), shards)
        label, (io, comp, coll, lat), note, tot = node_enc
        totals = (ZERO_TOTALS if tot is None else
                  ProgramTotals(tot[0], tot[1], tot[2], tot[3], tot[4]))
        node = CostedNode(label, CostBreakdown(io, comp, coll, lat), [],
                          note, totals)
        self.__init__(reads, net, hbm_delta, max_rel_hbm, node)

    def payload_sig(self):
        """Everything a hit replays, in comparable form.  Two entries
        under the same (key, read-set) must agree on this — the merge
        debug assert checks it."""
        net = tuple(sorted((k, None if v is None else v.sig)
                           for k, v in self.net.items()))
        cost = self.node.cost
        return (net, self.hbm_delta, self.max_rel_hbm,
                (cost.io, cost.compute, cost.collective, cost.latency))


#: On-disk container version — bump when CacheDelta's layout changes.
CACHE_FORMAT = 1

_COST_MODEL_FP: Optional[str] = None


def cost_model_fingerprint() -> str:
    """Version fingerprint of the *pricing semantics*: a hash over the
    source of every module whose code determines what a cached entry
    replays (cost formulas, op profiles, symbol-table effects, plan node
    signatures, cluster fingerprints, calibration application).  Persisted
    caches carry it, and :meth:`PlanCostCache.load_from` silently drops a
    snapshot whose fingerprint differs — a stale cache self-invalidates
    instead of replaying old economics.  Planner/search modules are
    deliberately excluded: program structure is already in the key.
    """
    global _COST_MODEL_FP
    if _COST_MODEL_FP is None:
        from repro_torch.core import calibration as _m_cal
        from repro_torch.core import cluster as _m_cluster
        from repro_torch.core import linalg_ops as _m_lo
        from repro_torch.core import npvec as _m_npvec
        from repro_torch.core import plan as _m_plan
        from repro_torch.core import symbols as _m_sym
        h = hashlib.sha256()
        for path in sorted(m.__file__ for m in
                           (_m_cal, _m_cluster, _m_lo, _m_npvec, _m_plan,
                            _m_sym)) + [__file__]:
            with open(path, "rb") as f:
                h.update(f.read())

        _COST_MODEL_FP = h.hexdigest()[:16]
    return _COST_MODEL_FP


@dataclasses.dataclass
class CacheDelta:
    """A portable slice of a :class:`PlanCostCache`: the serialized form
    both of a worker's freshly-recorded entries (:meth:`export_delta`) and
    of a full persisted snapshot (:meth:`save`).  ``stats`` carries the
    producing cache's lookup traffic so drivers can aggregate honest
    per-worker numbers via :meth:`CacheStats.__add__`."""

    fingerprint: str
    buckets: Dict[Tuple, List[_CacheEntry]]
    stats: CacheStats
    format: int = CACHE_FORMAT

    @property
    def entries(self) -> int:
        return sum(len(b) for b in self.buckets.values())


class PlanCostCache:
    """Sub-plan cost memoization, shared across :func:`estimate` calls.

    Maps (node signature, cluster/functions fingerprint, call stack) to a
    small list of entries, each guarded by the symbol-table read-set
    fingerprint its walk observed (the same block is typically seen in a
    handful of states: cold first iteration, warm iterations, ...).  One
    cache serves any number of programs and cluster configs — keys embed
    both — which is what lets a plan-enumerating optimizer or a scenario
    sweep share work across candidates.

    Because every input to a walk is embedded in (key, read-set), caches
    are *mergeable*: :meth:`export_delta` captures entries recorded since
    the last :meth:`mark`, :meth:`merge` folds a delta in (idempotent and
    order-independent — a collision can only carry an identical payload),
    and :meth:`save`/:meth:`load` persist snapshots across processes and
    runs, versioned by :func:`cost_model_fingerprint`.

    ``max_entries`` optionally bounds the cache with cheap clock-hand
    (second-chance) eviction; a bounded cache stays bit-exact — eviction
    only costs extra misses.
    """

    def __init__(self, max_entries: Optional[int] = None) -> None:
        if max_entries is not None and max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self._buckets: Dict[Tuple, List[_CacheEntry]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.max_entries = max_entries
        self._n = 0          # live entry count (kept incrementally)
        self._seq = 0        # monotone insertion tick
        self._mark_seq = 0   # export_delta watermark
        self._hand: List[Tuple] = []   # clock hand: pending bucket keys

    @property
    def entries(self) -> int:
        return self._n

    def stats(self) -> CacheStats:
        return CacheStats(self.hits, self.misses, self._n, self.evictions)

    def clear(self) -> None:
        self._buckets.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._n = 0
        self._seq = 0
        self._mark_seq = 0
        self._hand = []

    # ------------------------------------------------- insertion/eviction
    def _insert(self, key: Tuple, entry: _CacheEntry) -> None:
        self._seq += 1
        entry.seq = self._seq
        entry.ref = False
        self._buckets.setdefault(key, []).append(entry)
        self._n += 1
        if self.max_entries is not None:
            while self._n > self.max_entries:
                self._evict_one()

    def _evict_one(self) -> None:
        """Clock-hand (second-chance) eviction: cycle bucket keys; a
        bucket whose tail entry was hit since the hand last passed gets
        its reference bit cleared and a second chance, otherwise the tail
        — the bucket's coldest entry, by move-to-front — is dropped."""
        while True:
            if not self._hand:
                self._hand = list(self._buckets.keys())
                self._hand.reverse()   # pop() scans in insertion order
            key = self._hand.pop()
            bucket = self._buckets.get(key)
            if not bucket:
                continue
            victim = bucket[-1]
            if victim.ref:
                victim.ref = False
                continue
            bucket.pop()
            if not bucket:
                del self._buckets[key]
            self._n -= 1
            self.evictions += 1
            return

    # --------------------------------------------------- delta export/merge
    def mark(self) -> None:
        """Set the :meth:`export_delta` watermark: only entries recorded
        *after* this call are exported.  Workers call it right after
        seeding from a snapshot so the delta excludes the seed."""
        self._mark_seq = self._seq

    def export_delta(self, lean: bool = False) -> CacheDelta:
        """Entries recorded since the last :meth:`mark` (or ever, if no
        mark), plus this cache's full lookup-traffic stats.

        ``lean=True`` keeps only *block* entries (walks with children) —
        the form pool workers ship back to a parallel driver.  Walks
        replay top-down, so an outer block hit absorbs every leaf lookup
        beneath it and a blocks-only delta replays an identical grid with
        a 100% hit rate; leaves are ~80% of a delta's entries but only
        matter on near-misses (a changed read fingerprint), where the
        consumer re-walks the cheap leaves and re-records them locally.
        Deserialization is the *serial* part of a parallel run, so the
        5-6x smaller wire delta is what the speedup gate buys with this.
        """
        buckets: Dict[Tuple, List[_CacheEntry]] = {}
        for key, bucket in self._buckets.items():
            fresh = [e for e in bucket
                     if e.seq > self._mark_seq
                     and (not lean or e.node.children)]
            if fresh:
                buckets[key] = fresh
        return CacheDelta(cost_model_fingerprint(), buckets, self.stats())

    def merge(self, delta: CacheDelta) -> int:
        """Fold a delta's entries in; returns the number actually added.

        Idempotent and order-independent: keys embed the node signature,
        cluster/functions fingerprint and call stack, and each entry is
        guarded by its read-set fingerprint — so when two caches both
        hold an (key, read-set) pair, both recorded the same deterministic
        walk and the payloads are identical (assert-checked in debug);
        the duplicate is simply skipped.
        """
        if delta.fingerprint != cost_model_fingerprint():
            raise ValueError(
                "cache delta was produced by a different cost-model "
                f"version ({delta.fingerprint} != {cost_model_fingerprint()})")
        added = 0
        for key, entries in delta.buckets.items():
            bucket = self._buckets.get(key)
            for e in entries:
                dup = None
                if bucket is not None:
                    for have in bucket:
                        if have.reads == e.reads:
                            dup = have
                            break
                if dup is not None:
                    assert dup.payload_sig() == e.payload_sig(), (
                        "cache merge collision with differing payloads — "
                        "key fingerprints no longer cover every walk input")
                    continue
                # Copy the shell so seq/ref stay local to this cache; the
                # payload objects themselves are immutable-by-convention.
                self._insert(key, _CacheEntry(e.reads, e.net, e.hbm_delta,
                                              e.max_rel_hbm, e.node))
                added += 1
                bucket = self._buckets.get(key)
        return added

    # ------------------------------------------------------- persistence
    def save(self, path: str) -> int:
        """Atomically snapshot every entry to ``path``; returns the entry
        count written.  The snapshot embeds the cost-model fingerprint."""
        delta = CacheDelta(cost_model_fingerprint(),
                           {k: list(b) for k, b in self._buckets.items()},
                           self.stats())
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(delta, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return self._n

    def load_from(self, path: str) -> int:
        """Merge a saved snapshot into this cache; returns entries added.
        Missing, unreadable, wrong-format or stale-fingerprint files all
        load as 0 entries — a stale cache self-invalidates, it never
        raises and never replays old economics."""
        try:
            with open(path, "rb") as f:
                delta = pickle.load(f)
        except Exception:
            return 0
        if not isinstance(delta, CacheDelta) or delta.format != CACHE_FORMAT:
            return 0
        if delta.fingerprint != cost_model_fingerprint():
            return 0
        if self._n == 0 and self.max_entries is None:
            # Fast adopt: freshly unpickled entries are exclusively ours
            # (no other cache aliases their seq/ref), and an empty cache
            # has no duplicates to guard against.
            added = 0
            for key, entries in delta.buckets.items():
                for e in entries:
                    self._seq += 1
                    e.seq = self._seq
                self._buckets[key] = entries
                added += len(entries)
            self._n = added
            return added
        return self.merge(delta)

    @classmethod
    def load(cls, path: str,
             max_entries: Optional[int] = None) -> "PlanCostCache":
        """A fresh cache seeded from ``path`` (empty if missing/stale)."""
        cache = cls(max_entries=max_entries)
        cache.load_from(path)
        return cache


# Node kinds worth memoizing: blocks (arbitrarily large sub-walks) and the
# instructions with non-trivial math (op profiling / collective formulas).
# Meta instructions (createvar & co) are cheaper to execute than to probe.
_CACHEABLE = (GenericBlock, ForBlock, WhileBlock, ParForBlock,
              PipelinedLoopBlock, Compute, Collective, P2P, JitCall)


class CostEstimator:
    """Walks a :class:`Program` and produces a :class:`CostedProgram`."""

    def __init__(self, cc: ClusterConfig, verbose: bool = False,
                 cache: Optional[PlanCostCache] = None,
                 terse_labels: bool = False):
        self.cc = cc
        self.verbose = verbose
        self.cache = cache
        # The batched (lane-vector) walk discards every label below the
        # root when the lanes are split back out, and formatting a lane
        # array into a node label costs more than costing the node —
        # terse_labels swaps describe() for the bare instruction kind.
        self.terse_labels = terse_labels

    # ------------------------------------------------------------------ API
    def estimate(self, program: Program) -> CostedProgram:
        """Walk ``program`` once and return its :class:`CostedProgram`
        (cost tree + scalar + breakdown + peak HBM + work totals)."""
        symtab = SymbolTable()
        for name, stat in program.inputs.items():
            symtab.createvar(name, stat)
        self._peak_hbm = symtab.live_hbm_bytes()
        self._functions = program.functions
        if self.cache is not None:
            self._ctx_fp = (self.cc.fingerprint(),
                            program.functions_signature())
        root = CostedNode(f"PROGRAM {program.name}", CostBreakdown())
        total = CostBreakdown()
        totals = ZERO_TOTALS
        for node in program.blocks:
            cn = self._cost_node(node, symtab, stack=())
            root.children.append(cn)
            total = total + cn.cost
            totals = totals + cn.totals
        root.cost = total
        root.totals = totals
        return CostedProgram(root, total.total, total, self._peak_hbm, totals)

    # ------------------------------------------------------- block walkers
    def _cost_node(self, node: Union[Instruction, Block], symtab: SymbolTable,
                   stack: Tuple[str, ...]) -> CostedNode:
        if self.cache is not None and isinstance(node, _CACHEABLE):
            return self._cost_cached(node, symtab, stack)
        return self._cost_node_direct(node, symtab, stack)

    def _cost_cached(self, node, symtab: SymbolTable,
                     stack: Tuple[str, ...]) -> CostedNode:
        cache = self.cache
        key = (node_signature(node), self._ctx_fp, stack)
        bucket = cache._buckets.get(key)
        if bucket is not None:
            for i, entry in enumerate(bucket):
                if symtab.matches(entry.reads):
                    cache.hits += 1
                    entry.ref = True     # second chance vs the clock hand
                    if i:            # move-to-front: states recur in runs
                        del bucket[i]
                        bucket.insert(0, entry)
                    peak = symtab.replay(entry.reads, entry.net,
                                         entry.hbm_delta, entry.max_rel_hbm)
                    if peak > self._peak_hbm:
                        self._peak_hbm = peak
                    return entry.node
        cache.misses += 1
        rec = symtab.begin_record()
        try:
            cn = self._cost_node_direct(node, symtab, stack)
            net = symtab.net_delta(rec)
            hbm_delta = symtab.live_hbm_bytes() - rec.start_hbm
        finally:
            symtab.end_record(rec)
        if not rec.poisoned:
            cache._insert(key, _CacheEntry(rec.reads, net, hbm_delta,
                                           rec.max_rel_hbm, cn))
        return cn

    def _cost_node_direct(self, node: Union[Instruction, Block],
                          symtab: SymbolTable,
                          stack: Tuple[str, ...]) -> CostedNode:
        if isinstance(node, Instruction):
            return self._cost_instruction(node, symtab, stack)
        if isinstance(node, GenericBlock):
            return self._sum_children(node.label, node.children, symtab, stack)
        if isinstance(node, (ForBlock, WhileBlock)):
            return self._cost_loop(node, symtab, stack)
        if isinstance(node, ParForBlock):
            return self._cost_parfor(node, symtab, stack)
        if isinstance(node, PipelinedLoopBlock):
            return self._cost_pipelined(node, symtab, stack)
        if isinstance(node, IfBlock):
            return self._cost_if(node, symtab, stack)
        if isinstance(node, FunctionBlock):
            return self._sum_children(f"FUNCTION {node.name}", node.body, symtab, stack)
        raise TypeError(f"unknown plan node {type(node)}")

    def _sum_children(self, label: str, children, symtab, stack) -> CostedNode:
        out = CostedNode(label, CostBreakdown())
        agg = CostBreakdown()
        totals = ZERO_TOTALS
        for c in children:
            cn = self._cost_node(c, symtab, stack)
            out.children.append(cn)
            agg = agg + cn.cost
            totals = totals + cn.totals
        out.cost = agg
        out.totals = totals
        return out

    def _cost_loop(self, node, symtab, stack) -> CostedNode:
        """T = N * T_pred + T_first + (N-1) * T_warm.

        The warm pass re-costs the body with the post-first-iteration symbol
        table — the paper's correction for "overestimated read costs in
        loops, where only the first iteration reads persistent inputs".
        """
        n = node.iterations if node.iterations is not None else self.cc.default_loop_iterations
        n = pmax(dim_int(n), 1)
        pred = self._sum_children("predicate", node.predicate, symtab, stack)
        first = self._sum_children("body[first]", node.body, symtab, stack)
        # lane vectors must agree on the warm-branch shape (uniform_bool
        # raises to the batched driver's scalar fallback otherwise)
        if uniform_bool(n > 1):
            warm = self._sum_children("body[warm]", node.body, symtab, stack)
            agg = pred.cost.scaled(n) + first.cost + warm.cost.scaled(n - 1)
            totals = (pred.totals.scaled(n) + first.totals
                      + warm.totals.scaled(n - 1))
        else:
            warm = None
            agg = pred.cost + first.cost
            totals = pred.totals + first.totals
        kind = "FOR" if isinstance(node, ForBlock) else "WHILE"
        label = f"{kind} {node.label} (N={n}{'' if node.iterations is not None else ' est'})"
        children = [pred, first] + ([warm] if warm else [])
        return CostedNode(label, agg, children, totals=totals)

    def _cost_parfor(self, node: ParForBlock, symtab, stack) -> CostedNode:
        n = node.iterations if node.iterations is not None else self.cc.default_loop_iterations
        k = max(int(node.parallelism), 1)
        w = math.ceil(max(int(n), 1) / k)
        first = self._sum_children("body[first]", node.body, symtab, stack)
        if w > 1:
            warm = self._sum_children("body[warm]", node.body, symtab, stack)
            agg = first.cost + warm.cost.scaled(w - 1)
            totals = first.totals + warm.totals.scaled(w - 1)
            children = [first, warm]
        else:
            agg = first.cost
            totals = first.totals
            children = [first]
        return CostedNode(f"PARFOR {node.label} (N={n}, k={k}, w={w})", agg,
                          children, totals=totals)

    def _cost_pipelined(self, node: PipelinedLoopBlock, symtab,
                        stack) -> CostedNode:
        """GPipe-style schedule: T = fill/drain + steady state.

        The cold pass (microbatch 1 rippling through every stage, paying
        first-use IO) sums the stages; every further microbatch hides
        behind the slowest *warm* stage:

            T = sum_s T_s[first] + (M - 1) * max_s T_s[warm]

        Work totals take the sequential weights — every microbatch still
        executes every stage — so ``totals = sum_s first_s +
        (M-1) * sum_s warm_s``: pipelining overlaps time, it never deletes
        work (this is what keeps the resource optimizer's floors honest).
        At S=1 both formulas reduce bit-exactly to the sequential loop's
        ``T_first + (N-1) * T_warm``.
        """
        m = pmax(dim_int(node.microbatches), 1)
        s = len(node.stages)
        if not s:      # no stages: an empty loop body, nothing to charge
            return CostedNode(f"PIPELINE {node.label} (S=0, M={m})",
                              CostBreakdown())
        firsts = [self._sum_children(f"stage[{i}][first]", body, symtab,
                                     stack)
                  for i, body in enumerate(node.stages)]
        fill = CostBreakdown()
        totals = ZERO_TOTALS
        for fn in firsts:
            fill = fill + fn.cost
            totals = totals + fn.totals
        children: List[CostedNode] = list(firsts)
        note = ""
        if uniform_bool(m > 1):
            warms = [self._sum_children(f"stage[{i}][warm]", body, symtab,
                                        stack)
                     for i, body in enumerate(node.stages)]
            children.extend(warms)
            crit, crit_cost = self._critical_stage(warms)
            warm_totals = ZERO_TOTALS
            for wn in warms:
                warm_totals = warm_totals + wn.totals
            agg = fill + crit_cost.scaled(m - 1)
            totals = totals + warm_totals.scaled(m - 1)
            note = (f"critical stage={fmt(crit)} "
                    f"bubble~(S-1)/M={fmt((s - 1) / m, '.3f')}")
        else:
            agg = fill
        label = f"PIPELINE {node.label} (S={s}, M={m})"
        return CostedNode(label, agg, children, note=note, totals=totals)

    @staticmethod
    def _critical_stage(warms: List[CostedNode]):
        """The slowest warm stage: ``argmax`` over stage totals, first max
        on ties (the builtin-max tie rule the scalar walk has always used;
        ``np.argmax`` matches it, asserted by the property suite).

        With lane-vector stage costs the critical stage is selected *per
        lane* and every :class:`CostBreakdown` field gathered along the
        winning stage, so one batched walk reproduces each lane's scalar
        pipeline time bit-exact even when lanes disagree on which stage
        dominates."""
        tots = [w.cost.total for w in warms]
        try:
            crit = max(range(len(warms)), key=lambda i: tots[i])
            return crit, warms[crit].cost
        except ValueError:   # truth-value ambiguity: lane vectors
            k = lane_count(*tots)
            stacked = np.stack(
                [np.broadcast_to(np.asarray(t, dtype=np.float64), (k,))
                 for t in tots])
            crit_lanes = np.argmax(stacked, axis=0)     # first max per lane

            def gather(field: str):
                vals = np.stack(
                    [np.broadcast_to(
                        np.asarray(getattr(w.cost, field), dtype=np.float64),
                        (k,)) for w in warms])
                return np.take_along_axis(vals, crit_lanes[None, :], axis=0)[0]

            cost = CostBreakdown(gather("io"), gather("compute"),
                                 gather("collective"), gather("latency"))
            return crit_lanes, cost

    def _cost_if(self, node: IfBlock, symtab, stack) -> CostedNode:
        pred = self._sum_children("predicate", node.predicate, symtab, stack)
        nb = max(len(node.branches), 1)
        weights = list(node.weights) if node.weights else [1.0 / nb] * nb
        branch_nodes, branch_tabs = [], []
        base = symtab.snapshot()
        agg = pred.cost
        totals = pred.totals
        for i, br in enumerate(node.branches):
            symtab.restore(base)
            bn = self._sum_children(f"branch[{i}] w={weights[i]:.2f}", br, symtab, stack)
            branch_nodes.append(bn)
            branch_tabs.append(symtab.snapshot())
            agg = agg + bn.cost.scaled(weights[i])
            totals = totals + bn.totals.scaled(weights[i])
        # pessimistic merge: a var is HBM-resident only if resident in every
        # branch that defines it; otherwise keep the colder state.
        merged = branch_tabs[0] if branch_tabs else base
        for tab in branch_tabs[1:]:
            for name, st in list(merged.items()):
                other = tab.get(name)
                if other is None:
                    del merged[name]
                elif other.state != st.state:
                    colder = st if st.state != MemState.HBM else other
                    merged[name] = dataclasses.replace(st, state=colder.state)
        symtab.restore(merged)
        return CostedNode(f"IF {node.label}", agg, [pred] + branch_nodes,
                          totals=totals)

    # ------------------------------------------------------- instructions
    def _cost_instruction(self, inst: Instruction, symtab: SymbolTable,
                          stack: Tuple[str, ...]) -> CostedNode:
        cc = self.cc
        if isinstance(inst, CreateVar):
            symtab.createvar(inst.name, dataclasses.replace(inst.stat))
            return self._leaf(inst, CostBreakdown(latency=TINY), symtab)
        if isinstance(inst, CpVar):
            symtab.cpvar(inst.src, inst.dst)
            return self._leaf(inst, CostBreakdown(latency=TINY), symtab)
        if isinstance(inst, RmVar):
            symtab.rmvar(*inst.names)
            return self._leaf(inst, CostBreakdown(latency=TINY), symtab)
        if isinstance(inst, DataGen):
            stat = dataclasses.replace(inst.stat, state=MemState.HBM)
            symtab.createvar(inst.output, stat)
            bytes_gen = stat.bytes_per_device()
            t = bytes_gen / cc.hbm_bw_eff
            return self._leaf(inst, CostBreakdown(compute=t), symtab,
                              totals=ProgramTotals(hbm_bytes=bytes_gen))
        if isinstance(inst, Compute):
            return self._cost_compute(inst, symtab)
        if isinstance(inst, IO):
            return self._cost_io(inst, symtab)
        if isinstance(inst, Collective):
            return self._cost_collective(inst, symtab)
        if isinstance(inst, P2P):
            return self._cost_p2p(inst, symtab)
        if isinstance(inst, JitCall):
            return self._cost_jitcall(inst, symtab)
        if isinstance(inst, Call):
            return self._cost_call(inst, symtab, stack)
        raise TypeError(f"unknown instruction {type(inst)}")

    def _leaf(self, inst: Instruction, cost: CostBreakdown,
              symtab: SymbolTable, note: str = "",
              totals: ProgramTotals = ZERO_TOTALS) -> CostedNode:
        self._peak_hbm = pmax(self._peak_hbm, symtab.live_hbm_bytes())
        label = (inst.__class__.__name__ if self.terse_labels
                 else inst.describe())
        return CostedNode(label, cost, note=note, totals=totals)

    # -- first-use IO (the "pays the read" rule) --------------------------
    def _stage_in(self, name: str, symtab: SymbolTable) -> float:
        st = symtab.get(name)
        if st is None or st.state == MemState.HBM:
            return 0.0
        t = 0.0
        per_dev = st.bytes_serialized() / pmax(1, st.shards)
        if st.state == MemState.DISK:
            t += per_dev / self.cc.chip.disk_bw
            t += per_dev / self.cc.chip.pcie_bw
        elif st.state == MemState.HOST:
            t += per_dev / self.cc.chip.pcie_bw
        symtab.touch_hbm(name)
        return t

    def _cost_compute(self, inst: Compute, symtab: SymbolTable) -> CostedNode:
        cc = self.cc
        io_t = sum(self._stage_in(n, symtab) for n in inst.inputs)
        stats = []
        for n in inst.inputs:
            st = symtab.get(n)
            if st is None:
                raise KeyError(f"compute '{inst.opcode}' reads undefined var '{n}'")
            stats.append(st)
        prof = linalg_ops.profile(inst.opcode, stats, **inst.attrs)

        n_shards = 1
        for ax in inst.shard_axes:
            n_shards *= cc.axis_size(ax)
        if inst.exec_type == "CP":
            n_shards = 1

        flops = prof.flops / n_shards
        bytes_moved = prof.bytes / n_shards
        dtype = stats[0].dtype if stats else "bfloat16"
        if prof.util == "mxu":
            util = cc.mxu_util(dtype, prof.flops)
            peak = cc.chip.peak(dtype) * util
        else:
            peak = cc.chip.peak("float32") * VPU_FRACTION
        t_flops = flops / peak
        t_mem = bytes_moved / cc.hbm_bw_eff
        compute_t = pmax(t_flops, t_mem)

        out_stat = dataclasses.replace(prof.out, shards=n_shards, state=MemState.HBM)
        symtab.createvar(inst.output, out_stat)
        note = ""
        if self.verbose:
            note = (f"flops={prof.flops:.3g}/shard{n_shards} "
                    f"t_flops={t_flops:.3g} t_mem={t_mem:.3g}")
        if prof.util == "mxu":
            totals = ProgramTotals(mxu_flops={dtype: flops},
                                   hbm_bytes=bytes_moved)
        else:
            totals = ProgramTotals(vpu_flops=flops, hbm_bytes=bytes_moved)
        return self._leaf(inst, CostBreakdown(io=io_t, compute=compute_t,
                                              latency=TINY), symtab, note,
                          totals=totals)

    def _cost_io(self, inst: IO, symtab: SymbolTable) -> CostedNode:
        st = symtab.get(inst.var)
        if st is None:
            raise KeyError(f"io on undefined var '{inst.var}'")
        per_dev = (st.bytes_serialized() if inst.serialized else st.bytes_in_memory())
        # not //=: per_dev may be an int64 lane vector, and in-place true
        # division cannot widen it to float64
        per_dev = per_dev / pmax(1, st.shards)
        t = 0.0
        legs = _path_legs(inst.src, inst.dst)
        for leg in legs:
            bw = {"disk": self.cc.chip.disk_bw, "pcie": self.cc.chip.pcie_bw,
                  "dram": self.cc.chip.host_dram_bw}[leg]
            t += per_dev / bw
        symtab.set_state(inst.var, inst.dst)
        return self._leaf(inst, CostBreakdown(io=t), symtab)

    def _cost_collective(self, inst: Collective, symtab: SymbolTable) -> CostedNode:
        cc = self.cc
        st = symtab.get(inst.var)
        if inst.bytes_override is not None:
            payload = as_payload(inst.bytes_override)
        elif st is not None:
            payload = st.bytes_per_device()
        else:
            raise KeyError(f"collective on undefined var '{inst.var}'")
        t = 0.0
        wire = {"ici": 0.0, "dcn": 0.0}
        t_fab = {"ici": 0.0, "dcn": 0.0}
        phases = collective_phases(inst.kind, payload,
                                   [cc.axis_size(ax) for ax in inst.axes])
        for ax, (w, hops) in zip(inst.axes, phases):
            # axis_bandwidth folds in the torus link count (2 per axis on a
            # 3D-torus mesh, 1 on the calibrated flat model)
            dt = w / cc.axis_bandwidth(ax) + hops * cc.collective_phase_latency
            t += dt
            cls = cc.link_class(ax)
            t_fab[cls] += dt
            wire[cls] += w
        o_ici, o_dcn = cc.overlap("ici"), cc.overlap("dcn")
        if o_ici == o_dcn:
            # one discount (always the uncalibrated case): keep the exact
            # pre-calibration accumulation order, bit-identical
            t *= (1.0 - o_ici)
        else:
            # calibrated per-fabric overlap: discount each fabric's share
            t = t_fab["ici"] * (1.0 - o_ici) + t_fab["dcn"] * (1.0 - o_dcn)
        if inst.output and st is not None:
            symtab.createvar(inst.output, dataclasses.replace(st))
        return self._leaf(inst, CostBreakdown(collective=t), symtab,
                          totals=ProgramTotals(ici_bytes=wire["ici"],
                                               dcn_bytes=wire["dcn"]))

    def _cost_p2p(self, inst: P2P, symtab: SymbolTable) -> CostedNode:
        """One stage-boundary send/recv: priced at the *single-link* p2p
        rate of the axis fabric (``cc.p2p_bw``), never at the torus-doubled
        ``axis_bandwidth`` a ring collective earns.  Size-1 axes are
        no-ops; wire volume lands in the same ICI/DCN totals the floors
        read, and the overlap discount applies exactly as for collectives
        (a pipeline hides its sends under the adjacent stage's compute)."""
        cc = self.cc
        st = symtab.get(inst.var)
        if inst.bytes_override is not None:
            payload = as_payload(inst.bytes_override)
        elif st is not None:
            payload = st.bytes_per_device()
        else:
            raise KeyError(f"p2p on undefined var '{inst.var}'")
        n = cc.axis_size(inst.axis)
        wire, _ = p2p_wire(payload, n)
        cls = cc.link_class(inst.axis)
        t = p2p_cost(payload, n, cc.p2p_bw(inst.axis),
                     cc.collective_phase_latency) * (1.0 - cc.overlap(cls))
        return self._leaf(inst, CostBreakdown(collective=t), symtab,
                          totals=ProgramTotals(
                              ici_bytes=wire if cls == "ici" else 0.0,
                              dcn_bytes=wire if cls == "dcn" else 0.0))

    def _cost_jitcall(self, inst: JitCall, symtab: SymbolTable) -> CostedNode:
        io_t = sum(self._stage_in(n, symtab) for n in inst.reads)
        cost_rec = inst.compiled_cost
        bd = cost_rec.time_breakdown(self.cc)
        for w in inst.writes:
            if w in symtab:
                symtab.touch_hbm(w)
        # Compiled HLO does not name mesh axes: collectives are attributed
        # to a fabric by group size (CollectiveStat.attribute_axis), and a
        # collective that demonstrably crossed the DCN pod axis takes the
        # DCN overlap discount; everything else rides ICI.
        cc = self.cc
        t_fab = {"ici": 0.0, "dcn": 0.0}
        wire = {"ici": 0.0, "dcn": 0.0}
        for c in getattr(cost_rec, "collectives", ()):
            ax = c.attribute_axis(cc)
            cls = cc.link_class(ax) if ax is not None else "ici"
            t_fab[cls] += c.time(cc, axis=ax)
            wire[cls] += collective_wire(c.kind, c.operand_bytes,
                                         c.group_size)[0]
        coll_t = (t_fab["ici"] * (1.0 - cc.overlap("ici"))
                  + t_fab["dcn"] * (1.0 - cc.overlap("dcn")))
        cost = CostBreakdown(io=io_t + bd.io, compute=bd.compute,
                             collective=coll_t,
                             latency=bd.latency + self.cc.dispatch_latency)
        # Compiled modules report bf16-dominated MXU work.
        totals = ProgramTotals(
            mxu_flops={"bfloat16": getattr(cost_rec, "flops_per_device", 0.0)},
            hbm_bytes=getattr(cost_rec, "bytes_per_device", 0.0),
            ici_bytes=wire["ici"], dcn_bytes=wire["dcn"])
        return self._leaf(inst, cost, symtab, totals=totals,
                          note=f"from compiled HLO: {cost_rec.summary()}")

    def _cost_call(self, inst: Call, symtab: SymbolTable,
                   stack: Tuple[str, ...]) -> CostedNode:
        if inst.func in stack:   # recursion guard (paper §3.2)
            return self._leaf(inst, CostBreakdown(latency=TINY), symtab,
                              note="recursive call — cycle cut")
        fn = self._functions.get(inst.func)
        if fn is None:
            raise KeyError(f"call to undefined function '{inst.func}'")
        node = self._sum_children(f"call {inst.func}", fn.body, symtab,
                                  stack + (inst.func,))
        node.cost = node.cost + CostBreakdown(latency=self.cc.dispatch_latency)
        return node


def _mxu_util(cc: ClusterConfig, flops: float,
              dtype: str = "bfloat16") -> float:
    """Achievable MXU fraction — delegates to ``cc.mxu_util`` (the ramp
    lives on :class:`ClusterConfig` now so calibration profiles can
    replace it per dtype and shape class)."""
    return cc.mxu_util(dtype, flops)


def _path_legs(src: MemState, dst: MemState) -> List[str]:
    order = {MemState.DISK: 0, MemState.HOST: 1, MemState.HBM: 2}
    legs_up = {(0, 1): ["disk"], (1, 2): ["pcie"], (0, 2): ["disk", "pcie"]}
    a, b = order[src], order[dst]
    if a == b:
        return []
    if a < b:
        return legs_up[(a, b)]
    return list(reversed(legs_up[(b, a)]))


def estimate(program: Program, cc: ClusterConfig,
             cache: Optional[PlanCostCache] = None,
             terse_labels: bool = False) -> CostedProgram:
    """``C(P, cc)`` — cost a runtime plan under a cluster config.

    One recursive pass in execution order (no profiling, R1) returning a
    :class:`CostedProgram`: the annotated cost tree (feed it to
    :func:`repro_torch.core.explain.explain` for the paper's Fig 4/5 text form),
    the linearized scalar ``total`` (R2) with its
    io/compute/collective/latency :class:`CostBreakdown`, the peak
    per-device HBM excursion, and the charged :class:`ProgramTotals`.
    Re-cost the same plan under any other ``cc`` freely (R3).

    Pass one shared :class:`PlanCostCache` across calls to memoize
    repeated sub-plans (per-layer loop bodies, shared prefixes, common
    blocks of sibling candidates) — hits replay cost, totals, symbol-table
    effects and peak-HBM bit-exact.
    """
    return CostEstimator(cc, cache=cache,
                         terse_labels=terse_labels).estimate(program)


def split_costed_lanes(cp: CostedProgram, k: int) -> List[CostedProgram]:
    """Split a lane-vector :class:`CostedProgram` — one batched walk over a
    K-member knob grid — into K scalar results.

    Every numeric field (four breakdown terms, five work totals, peak HBM)
    is extracted per lane; fields the walk left scalar broadcast unchanged.
    Extraction is a float64 read, so each returned program carries exactly
    the numbers the scalar walk computes for that knob assignment (the
    property suite asserts this field-by-field).  The returned trees are
    root-only: the batched walk trades the per-node EXPLAIN annotations for
    throughput — cost a single candidate scalar when the tree matters.
    """
    outs: List[CostedProgram] = []
    bd, tt = cp.breakdown, cp.totals
    for j in range(k):
        b = CostBreakdown(lane(bd.io, j), lane(bd.compute, j),
                          lane(bd.collective, j), lane(bd.latency, j))
        t = ProgramTotals({dt: lane(f, j) for dt, f in tt.mxu_flops.items()},
                          lane(tt.vpu_flops, j), lane(tt.hbm_bytes, j),
                          lane(tt.ici_bytes, j), lane(tt.dcn_bytes, j))
        root = CostedNode(cp.root.label, b, totals=t)
        outs.append(CostedProgram(root, b.total, b,
                                  lane(cp.peak_hbm_per_device, j), t))
    return outs
