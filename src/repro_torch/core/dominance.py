"""Anytime-search dominance pool: prune candidates before costing them.

The optimizers (`choose_plan`, `optimize_resources`, `optimize_serving`)
stream candidates in a fixed visit order and keep an *incumbent* — the best
fully-costed result so far.  Before paying the cost walk for the next
candidate, a cheap lower bound (the geometry floor from
`resource.cluster_floor_time` / `serving.serving_floor`) is compared
against the incumbent: if the bound already loses, the candidate is
pruned *provably* — the true cost can only be worse than its floor.

:class:`DominancePool` packages that discipline.  Two modes:

* **rank-key mode** (``rank_key=`` given): a single incumbent, ordered by
  the optimizer's ranking tuple.  ``admit(bound)`` consults a
  ``cannot_win(bound, incumbent)`` predicate — sound as long as the
  predicate only returns True when *no* completion of ``bound`` can rank
  ahead of the incumbent (the existing ``_floor_cannot_win`` contracts).
  This is exactly the incumbent logic `optimize_resources` and
  `optimize_serving` grew organically; the pool centralizes it and counts
  admissions/prunes.

* **Pareto mode** (no ``rank_key``): the pool keeps the non-dominated
  frontier of (cost, hbm, evals)-style tuples under weak Pareto dominance
  — ``a`` dominates ``b`` when ``a`` is ≤ in every coordinate and < in at
  least one.  ``admit(t)`` is True unless some frontier member dominates
  ``t``; ``offer(t)`` inserts ``t`` and evicts members it dominates.
  Ties (equal tuples) are admitted, so any ranking monotone in each
  coordinate still sees its winner: the exhaustive optimum is never
  strictly dominated, hence never pruned (tests/test_dominance.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence


def pareto_dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Weak Pareto dominance: ``a`` ≤ ``b`` everywhere and < somewhere."""
    le_all = True
    lt_any = False
    for ai, bi in zip(a, b):
        if ai > bi:
            le_all = False
            break
        if ai < bi:
            lt_any = True
    return le_all and lt_any


@dataclass
class DominancePool:
    """Streaming dominance filter with admitted/pruned counters.

    rank-key mode::

        pool = DominancePool(rank_key=key_fn, cannot_win=floor_fn)
        for cand in stream:
            if not pool.admit(bound_of(cand)):   # provably loses
                continue                          # -> pool.pruned += 1
            result = cost(cand)                   # the expensive walk
            pool.offer(result)                    # maybe new incumbent

    Pareto mode::

        pool = DominancePool()
        if pool.admit((cost_lb, hbm_lb, evals_lb)):
            pool.offer((cost, hbm, evals))
    """

    rank_key: Optional[Callable[[Any], Any]] = None
    cannot_win: Optional[Callable[[Any, Any], bool]] = None
    dominates: Callable[[Sequence[float], Sequence[float]], bool] = pareto_dominates
    admitted: int = 0
    pruned: int = 0
    best: Any = None
    frontier: List[Any] = field(default_factory=list)

    def admit(self, bound: Any) -> bool:
        """True when ``bound`` might still win and must be costed.

        In rank-key mode the verdict comes from ``cannot_win(bound, best)``
        (never prunes while there is no incumbent).  In Pareto mode the
        bound tuple is checked against the frontier; only *strict*
        dominance prunes, so exact ties survive to be costed and ranked.
        """
        if self.rank_key is not None:
            ok = self.best is None or self.cannot_win is None or not self.cannot_win(bound, self.best)
        else:
            ok = not any(self.dominates(m, bound) for m in self.frontier)
        if ok:
            self.admitted += 1
        else:
            self.pruned += 1
        return ok

    def offer(self, result: Any) -> bool:
        """Insert a fully-costed result; True if it entered the pool.

        Rank-key mode replaces the incumbent when the new key ranks
        strictly ahead.  Pareto mode drops ``result`` if dominated, else
        inserts it and evicts now-dominated members.
        """
        if self.rank_key is not None:
            if self.best is None or self.rank_key(result) < self.rank_key(self.best):
                self.best = result
                return True
            return False
        if any(self.dominates(m, result) for m in self.frontier):
            return False
        self.frontier = [m for m in self.frontier if not self.dominates(result, m)]
        self.frontier.append(result)
        return True

    def __len__(self) -> int:
        if self.rank_key is not None:
            return 0 if self.best is None else 1
        return len(self.frontier)
