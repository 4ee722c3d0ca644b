"""Fitted calibration profiles — closing the estimate↔reality loop.

The estimator's efficiency constants (``ClusterConfig.matmul_util``,
``hbm_eff``, ``ici_eff``, ``dcn_eff``, the plan-gated overlap fraction)
are hand-set analogues of the paper's MMD_corr corrections.  This module
retrofits *fitted* values onto the same analytical model — the approach of
"Cost Models for Big Data Query Processing: Learning, Retrofitting"
(arXiv:2002.12393): a small set of interpretable factors, least-squared
from measured runtimes, with the bit-exact uncalibrated model as the
default (``ClusterConfig.calibration is None`` changes nothing).

A :class:`CalibrationProfile` describes ONE chip type:

* ``mxu[dtype][shape_class]`` — achieved fraction of MXU peak per dtype
  and matmul shape class (``small``/``medium``/``large``, the same
  1e8/1e10-FLOP breakpoints as the estimator's log-linear util ramp).
* ``hbm_fraction`` / ``ici_fraction`` / ``dcn_fraction`` — achieved
  fraction of peak HBM / per-link ICI / DCN bandwidth, replacing
  ``hbm_eff`` / ``ici_eff`` / ``dcn_eff`` when present.
* ``overlap_ici`` / ``overlap_dcn`` — achieved per-fabric overlap when a
  plan enables compute/comm overlap, replacing the plan-gated
  ``OVERLAP_FRACTION`` constant.

Every field is optional; absent fields fall back to the hand-set
constants, so an empty profile is an exact identity.

Fitting model: each sample's runtime is linearized as

    measured ≈ fixed + Σ_k x_k / f_k        (x_k = ideal seconds at PEAK)

so with β_k = 1/f_k the problem is ordinary least squares on
``measured − fixed ≈ Σ β_k x_k``; :func:`fit_profile` solves it by
min-norm lstsq and inverts/clamps the coefficients into achieved
fractions.  The min-norm solution matters for the online path: a single
drifting workload is an underdetermined system, and min-norm distributes
the drift across terms proportionally to their feature magnitude — which
is exactly what lets a re-cost change the *ranking* of plans with
different term mixes instead of scaling every plan uniformly.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

# Matmul shape classes, aligned with the estimator's util ramp breakpoints
# (``ClusterConfig.mxu_util``: small_matmul_util below 1e8 FLOPs, matmul_util
# above 1e10, log-linear in between).
SHAPE_CLASSES = ("small", "medium", "large")
SMALL_FLOPS = 1e8
LARGE_FLOPS = 1e10

# Canonical feature keys (see :func:`features_from_totals`).
HBM_KEY = "hbm"
ICI_KEY = "ici"
DCN_KEY = "dcn"


def shape_class(flops: float) -> str:
    """Shape class of a matmul charged ``flops`` — the discretization of
    the estimator's util ramp that calibration fits per-class factors on."""
    if flops <= SMALL_FLOPS:
        return "small"
    if flops >= LARGE_FLOPS:
        return "large"
    return "medium"


def mxu_key(dtype: str, cls: str) -> str:
    """Feature key of one (dtype, shape-class) MXU term."""
    return f"mxu:{dtype}:{cls}"


def _clean_mxu(mxu: Mapping[str, Mapping[str, float]]
               ) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for dtype, by_cls in (mxu or {}).items():
        row = {cls: float(v) for cls, v in by_cls.items() if v is not None}
        if row:
            out[str(dtype)] = row
    return out


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Fitted achieved-fraction corrections for one chip type.

    All factors are *achieved fractions of peak* in (0, 1]; a field left
    ``None`` (or a missing ``mxu`` entry) falls back to the hand-set
    ``ClusterConfig`` constant, so the empty profile is an identity.
    """

    chip_name: str = ""
    # dtype -> shape_class -> achieved fraction of MXU peak
    mxu: Mapping[str, Mapping[str, float]] = dataclasses.field(
        default_factory=dict)
    hbm_fraction: Optional[float] = None
    ici_fraction: Optional[float] = None
    dcn_fraction: Optional[float] = None
    # achieved overlap per fabric, applied only when the plan enables
    # overlap (the gate stays with the plan; calibration refines the value)
    overlap_ici: Optional[float] = None
    overlap_dcn: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "mxu", _clean_mxu(self.mxu))

    # ----------------------------------------------------------- queries
    def mxu_util(self, dtype: str, flops: float) -> Optional[float]:
        """Fitted MXU fraction for one op, or ``None`` when this profile
        has no entry for the op's (dtype, shape-class)."""
        by_cls = self.mxu.get(dtype)
        if not by_cls:
            return None
        return by_cls.get(shape_class(flops))

    def mxu_ceiling(self, dtype: str, default_ceiling: float) -> float:
        """The most generous MXU fraction any op of ``dtype`` can earn
        under this profile — what a sound floor must price FLOPs at.
        When the class table is incomplete for the dtype, uncovered
        classes still fall back to the hand-set ramp, so the ceiling must
        include ``default_ceiling`` too."""
        by_cls = self.mxu.get(dtype)
        if not by_cls:
            return default_ceiling
        vals = list(by_cls.values())
        if len(by_cls) < len(SHAPE_CLASSES):
            vals.append(default_ceiling)
        return max(vals)

    def is_empty(self) -> bool:
        return (not self.mxu and self.hbm_fraction is None
                and self.ici_fraction is None and self.dcn_fraction is None
                and self.overlap_ici is None and self.overlap_dcn is None)

    # ------------------------------------------------------------ identity
    def fingerprint(self) -> Tuple:
        """Hashable identity — folded into ``ClusterConfig.fingerprint()``
        so ``PlanCostCache`` never mixes calibrated and uncalibrated
        costs."""
        return (self.chip_name,
                tuple(sorted((dt, tuple(sorted(by.items())))
                             for dt, by in self.mxu.items())),
                self.hbm_fraction, self.ici_fraction, self.dcn_fraction,
                self.overlap_ici, self.overlap_dcn)

    def describe(self) -> str:
        parts = []
        for dt in sorted(self.mxu):
            by = self.mxu[dt]
            parts.append("mxu[%s]=%s" % (
                dt, "/".join(f"{c}:{by[c]:.3f}" for c in SHAPE_CLASSES
                             if c in by)))
        for k in ("hbm_fraction", "ici_fraction", "dcn_fraction",
                  "overlap_ici", "overlap_dcn"):
            v = getattr(self, k)
            if v is not None:
                parts.append(f"{k}={v:.3f}")
        return ";".join(parts) or "identity"

    # ------------------------------------------------------------- (de)ser
    def to_json(self) -> Dict[str, Any]:
        return {
            "chip_name": self.chip_name,
            "mxu": {dt: dict(by) for dt, by in self.mxu.items()},
            "hbm_fraction": self.hbm_fraction,
            "ici_fraction": self.ici_fraction,
            "dcn_fraction": self.dcn_fraction,
            "overlap_ici": self.overlap_ici,
            "overlap_dcn": self.overlap_dcn,
        }

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "CalibrationProfile":
        return CalibrationProfile(
            chip_name=d.get("chip_name", ""),
            mxu=d.get("mxu", {}),
            hbm_fraction=d.get("hbm_fraction"),
            ici_fraction=d.get("ici_fraction"),
            dcn_fraction=d.get("dcn_fraction"),
            overlap_ici=d.get("overlap_ici"),
            overlap_dcn=d.get("overlap_dcn"),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @staticmethod
    def loads(s: str) -> "CalibrationProfile":
        return CalibrationProfile.from_json(json.loads(s))


# ---------------------------------------------------------------------------
# Samples and features
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationSample:
    """One (estimated-terms, measured-seconds) pair.

    ``features`` maps canonical term keys (``mxu:<dtype>:<class>``,
    ``hbm``, ``ici``, ``dcn``) to *ideal seconds at peak rates* — the
    estimator's time terms with every efficiency factor set to 1, so the
    fitted coefficient of a term IS its achieved fraction.
    ``fixed_seconds`` holds the non-calibratable part of the estimate
    (VPU work, dispatch/phase latency, host IO); it is subtracted from
    the measurement before fitting.  ``polluted`` marks samples whose
    measurement path is suspect (e.g. ``CompiledCost.unknown_dtypes``):
    the fitter rejects them.
    """

    features: Mapping[str, float]
    measured_seconds: float
    estimated_seconds: float = 0.0
    fixed_seconds: float = 0.0
    label: str = ""
    polluted: bool = False


def features_from_totals(totals, cc, mxu_class: Optional[str] = None,
                         flops_per_op: Optional[float] = None
                         ) -> Dict[str, float]:
    """Peak-rate feature vector of one program's charged work totals.

    ``totals`` is a :class:`repro_torch.core.costmodel.ProgramTotals`; ``cc``
    supplies peak rates only (chip peaks, link counts) — no efficiency
    factor enters a feature.  A full program aggregates many matmuls into
    one per-dtype FLOP total, so the shape class is taken from
    ``flops_per_op`` when given (else from the total — a full train step's
    MXU work is dominated by large matmuls, and the total lands in
    ``large`` exactly when they do), or pinned with ``mxu_class``.
    """
    x: Dict[str, float] = {}
    for dt, f in getattr(totals, "mxu_flops", {}).items():
        if f <= 0:
            continue
        cls = mxu_class or shape_class(
            flops_per_op if flops_per_op is not None else f)
        key = mxu_key(dt, cls)
        x[key] = x.get(key, 0.0) + f / cc.chip.peak(dt)
    hbm = getattr(totals, "hbm_bytes", 0.0)
    if hbm > 0:
        x[HBM_KEY] = hbm / cc.chip.hbm_bw
    ici = getattr(totals, "ici_bytes", 0.0)
    if ici > 0:
        x[ICI_KEY] = ici / (cc.chip.ici_bw_per_link * cc.max_ici_links)
    dcn = getattr(totals, "dcn_bytes", 0.0)
    if dcn > 0:
        x[DCN_KEY] = dcn / cc.chip.dcn_bw
    return x


# ---------------------------------------------------------------------------
# The fitter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FitResult:
    profile: CalibrationProfile
    factors: Dict[str, float]      # term key -> fitted achieved fraction
    residual: float                # RMS relative residual on accepted samples
    n_samples: int                 # samples the fit used
    n_rejected: int                # polluted / degenerate samples dropped


def fit_profile(samples: Sequence[CalibrationSample], chip_name: str = "",
                *, max_factor: float = 1.0, min_factor: float = 0.02
                ) -> FitResult:
    """Least-squares the achieved fractions from measured samples.

    Solves ``measured − fixed ≈ Σ_k β_k · x_k`` for β (min-norm lstsq),
    then inverts ``f_k = 1/β_k`` and clamps into ``[min_factor,
    max_factor]`` — a term the fit says ran *faster than peak* (β below
    1/max_factor: noise, or work the measurement overlapped away) clamps
    to ``max_factor`` so a profile can never promise super-peak rates,
    keeping every calibrated floor sound (factors ≤ 1 only slow terms
    down).  Terms with no feature mass in any accepted sample are left
    out of the profile (they fall back to the hand-set constants).
    """
    import numpy as np

    accepted = []
    rejected = 0
    for s in samples:
        y = s.measured_seconds - s.fixed_seconds
        if s.polluted or not s.features or y <= 0:
            rejected += 1
            continue
        accepted.append((s, y))
    keys = sorted({k for s, _ in accepted for k, v in s.features.items()
                   if v > 0})
    if not accepted or not keys:
        return FitResult(CalibrationProfile(chip_name=chip_name), {},
                         float("nan"), 0, rejected)

    X = np.array([[s.features.get(k, 0.0) for k in keys]
                  for s, _ in accepted], dtype=float)
    y = np.array([t for _, t in accepted], dtype=float)
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)

    factors: Dict[str, float] = {}
    for k, b in zip(keys, beta):
        if b <= 0:
            # lstsq drove the term negative (collinear features): treat as
            # unobserved rather than inventing a super-peak rate
            continue
        factors[k] = min(max_factor, max(min_factor, 1.0 / float(b)))

    pred = X @ np.array([1.0 / factors[k] if k in factors else 0.0
                         for k in keys])
    rel = (pred - y) / np.maximum(y, 1e-30)
    residual = float(np.sqrt(np.mean(rel * rel)))

    mxu: Dict[str, Dict[str, float]] = {}
    hbm = ici = dcn = None
    for k, f in factors.items():
        if k.startswith("mxu:"):
            _, dt, cls = k.split(":")
            mxu.setdefault(dt, {})[cls] = f
        elif k == HBM_KEY:
            hbm = f
        elif k == ICI_KEY:
            ici = f
        elif k == DCN_KEY:
            dcn = f
    profile = CalibrationProfile(chip_name=chip_name, mxu=mxu,
                                 hbm_fraction=hbm, ici_fraction=ici,
                                 dcn_fraction=dcn)
    return FitResult(profile, factors, residual, len(accepted), rejected)
