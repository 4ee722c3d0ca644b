"""Scalar-preserving numpy polymorphism for the vectorized cost walk.

The batched costing engine (docs/COST_MODEL.md §Vectorized evaluation)
threads numpy arrays — one lane per knob-grid member — through the same
closed-form cost expressions the scalar walk evaluates.  Most of those
expressions (``+ - * / //`` chains) are array-polymorphic for free; the
helpers here cover the handful of spots where Python builtins are not:

  * ``max``/``min`` raise on arrays (truth-value ambiguity) — :func:`pmax`
    and :func:`pmin` substitute ``np.maximum``/``np.minimum`` only when an
    operand is an ndarray, so every scalar call site keeps the builtin
    bit-for-bit (the golden-sweep byte-identity gate rides on this);
  * ``int(x)``/``float(x)`` casts on shape dims and payloads —
    :func:`dim_int` / :func:`as_payload` skip the cast for array lanes;
  * branchy predicates (``if n > 1``) need one answer for the whole lane
    vector — :func:`uniform_bool` requires the predicate to agree across
    lanes and raises :class:`HeterogeneousLanes` otherwise, which the
    batched driver catches to split the group back to scalar costing.

Elementwise float64 numpy arithmetic uses the same IEEE-754 double
operations as Python floats, so a vectorized expression evaluated over K
lanes is bit-identical to K scalar evaluations of the same expression —
the property the batched engine's bit-exactness proofs rest on
(tests/test_properties.py).
"""
from __future__ import annotations

import numpy as np

ndarray = np.ndarray


class HeterogeneousLanes(Exception):
    """A lane vector straddles a structural branch (e.g. some lanes have
    ``n > 1`` and some ``n == 1``): the group shares no single program
    structure and must be costed scalar."""


def is_vec(x) -> bool:
    return isinstance(x, np.ndarray)


def pmax(a, b):
    """``max(a, b)`` that is ``np.maximum`` when either side is an array.

    Scalar calls take the builtin path untouched — identical objects out,
    identical tie behavior — so pre-batching cost paths stay bit-exact.
    """
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.maximum(a, b)
    return max(a, b)


def pmin(a, b):
    """``min(a, b)`` with the same scalar-preserving contract as :func:`pmax`."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.minimum(a, b)
    return min(a, b)


def dim_int(x):
    """``int(x)`` for scalar tensor dims; array dims pass through.

    Array lanes keep integer dtype when they already are integral (the
    ``//`` chains that produce them yield int64), so downstream byte math
    matches the scalar ``int`` path value-for-value.
    """
    if isinstance(x, np.ndarray):
        return x
    return int(x)


def dim_ceil(x):
    """``int(x + 0.999)`` (the resident-bytes dim rounding) for scalars;
    the truncating ``astype(int64)`` — same value for positive lanes —
    when ``x`` is an array."""
    if isinstance(x, np.ndarray):
        return (x + 0.999).astype(np.int64)
    return int(x + 0.999)


def as_payload(x):
    """``float(x)`` for scalar byte payloads; float64 lanes pass through."""
    if isinstance(x, np.ndarray):
        return x.astype(np.float64) if x.dtype != np.float64 else x
    return float(x)


def uniform_bool(pred) -> bool:
    """Collapse an elementwise predicate to one bool, requiring every lane
    to agree.  Scalar bools pass through; a straddling vector raises
    :class:`HeterogeneousLanes` (the batched driver then falls back to
    scalar costing for the group, keeping the engine sound by construction
    rather than by hope)."""
    if isinstance(pred, np.ndarray):
        if pred.size == 0:
            return False
        first = bool(pred.flat[0])
        if not (pred == first).all():
            raise HeterogeneousLanes("lanes disagree on a structural branch")
        return first
    return bool(pred)


def lane_count(*xs) -> int:
    """Number of lanes across a set of possibly-vector values (1 if all
    scalar).  Raises on mismatched vector lengths — vectors built from one
    knob grid always agree."""
    k = 1
    for x in xs:
        if isinstance(x, np.ndarray):
            if k != 1 and x.shape[0] != k:
                raise ValueError(f"lane mismatch: {x.shape[0]} vs {k}")
            k = x.shape[0]
    return k


def lane(x, j: int) -> float:
    """Extract lane ``j`` of a possibly-vector value as a Python float.
    Scalars broadcast (every lane sees the same value) — exactly how the
    scalar walk would have charged them."""
    if isinstance(x, np.ndarray):
        return float(x[j])
    return float(x)


def fmt(x, spec: str = "") -> str:
    """Format a possibly-vector value for labels/notes: scalars honor the
    format spec, vectors render as their compact repr (display only — the
    cost fields themselves stay numeric)."""
    if isinstance(x, np.ndarray):
        return np.array2string(x, separator=",", threshold=8)
    return format(x, spec)
