"""The comparisons that decide ``correct``, each number beside its limit.

Training: each checked step's loss against the reference's (relative gap,
the worst step); the norm of the first step's gradient as the optimizer
takes it, leaf by leaf; the norm of each leaf's change over the checked
steps.  A norm's gap is ``|program - reference|`` over the reference's norm
of that leaf or the median leaf's norm, whichever is larger (some
gradients are all but zero), and the worst leaf is what counts.  Leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off alone under Adam; they are left out of the change.

Serving: the widest gap by which a served token's reference logit lies
below the reference's best logit at that position.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

NEGLIGIBLE_GRAD = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of the reference leaf's
    norm and the median leaf's."""
    keys = list(ref if keys is None else keys)
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        denom = max(ref[k], med)
        if not math.isfinite(prog[k]):
            out[k] = math.inf
        elif denom > 0:
            out[k] = abs(prog[k] - ref[k]) / denom
        else:
            out[k] = 0.0 if prog[k] == ref[k] else math.inf
    return out


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap of norms, and that leaf."""
    gaps = leaf_gaps(prog, ref, keys)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moved_leaves(ref_grad1: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad1.values())
    return [k for k, g in ref_grad1.items() if g >= NEGLIGIBLE_GRAD * med]


def train_numbers(losses: List[float], grad1: Dict[str, float],
                  change: Dict[str, float], ref: dict) -> Dict[str, dict]:
    """The worst leaf's gaps, and the median leaf's gradient gap: a small
    leaf's gradient, reduced in the program's bf16 (``D``, ``dt_bias``), is
    the noisiest, while a lower precision of the products moves every
    weight matrix's."""
    loss_rel = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
                   for a, b in zip(losses, ref["losses"]))
    g = leaf_gaps(grad1, ref["grad1"])
    c = leaf_gaps(change, ref["change"], moved_leaves(ref["grad1"]))
    g_leaf, c_leaf = max(g, key=g.get), max(c, key=c.get)
    return {"loss_rel": {"value": loss_rel},
            "grad1_gap": {"value": g[g_leaf], "leaf": g_leaf},
            "change_gap": {"value": c[c_leaf], "leaf": c_leaf},
            "grad1_median": {"value": statistics.median(g.values())}}


def served_gap(logits, token: int) -> float:
    """How far the served token's reference logit lies below the best."""
    return float(logits.max() - logits[token])


def judge(numbers: Dict[str, dict], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each number beside its limit; correct when every number that has a
    limit is finite and within it.  A number the cell's checks give no
    limit is reported and not compared."""
    out, ok = {}, True
    for name, entry in numbers.items():
        limit = limits.get(name)
        value = entry["value"]
        out[name] = {"value": value, "limit": limit,
                     **{k: v for k, v in entry.items() if k != "value"}}
        if limit is not None and not (math.isfinite(value)
                                      and value <= limit):
            ok = False
    return ok, out
