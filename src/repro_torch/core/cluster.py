"""Cluster characteristics ``cc`` — the hardware side of ``C(P, cc)``.

The paper's cost model (R3) is parameterized by cluster characteristics:
memory budgets, degrees of parallelism k_l/k_m/k_r, IO bandwidth multipliers
(HDFS/local disk), and a CPU frequency with a 1-FLOP/cycle assumption.

The TPU analogue is a white-box table of per-chip peak compute, the memory
hierarchy bandwidths (HBM / VMEM / host DRAM / PCIe / disk), the ICI fabric,
and fixed latency constants (dispatch, collective phase setup).  All values
are *constants*, not profiles — preserving the paper's R1 (analytical model,
no profiling runs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.core.calibration import CalibrationProfile

# ---------------------------------------------------------------------------
# Per-chip hardware descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A single accelerator chip (the unit the mesh is built from)."""

    name: str
    # Peak dense matmul throughput by dtype (FLOP/s).
    peak_flops: Dict[str, float]
    # HBM capacity (bytes) and bandwidth (bytes/s).
    hbm_bytes: float
    hbm_bw: float
    # Fast on-chip memory (VMEM) — relevant for Pallas BlockSpec budgeting.
    vmem_bytes: float
    # Per-link ICI bandwidth (bytes/s, one direction) and number of links
    # usable per mesh axis (a 2D torus exposes 1 link per axis direction
    # here; the planner multiplies by axis count when both axes carry the
    # same collective).
    ici_bw_per_link: float
    ici_links_per_axis: int = 1
    # How many torus dimensions this chip generation's ICI fabric builds.
    # v5e/v6e slices are 2D tori; v5p slices are 3D tori (each chip has six
    # ICI ports, two per axis).  Mapping a *3D* logical mesh onto a 3D torus
    # gives every mesh axis a wrapped physical ring with both link
    # directions usable — 2 links per axis — while the flat 2D model (one
    # effective link per axis, the calibrated behavior every existing mesh
    # uses) is kept for 2D meshes on any chip.  The resource optimizer only
    # emits 3D mesh candidates when ``ici_torus_dims >= 3``.
    ici_torus_dims: int = 2
    # Side length of the building-block cube the fabric is assembled from
    # (v4/v5p slices compose 4x4x4 cubes behind optical switches).  An axis
    # of a 3D slice only closes into a wrapped ring — earning the 2-link
    # torus rate — when its extent is a whole number of cube faces, i.e. a
    # multiple of this; any other extent is an open line (1 link).
    ici_cube_dim: int = 4
    # Host-side paths.
    pcie_bw: float = 32e9          # host <-> device
    host_dram_bw: float = 100e9    # host memory
    disk_bw: float = 1.0e9         # persistent storage (checkpoints, data)
    # Data-center network between pods (bytes/s per host NIC).
    dcn_bw: float = 25e9 / 8 * 8   # 25 GB/s effective per pod-slice edge
    # Largest single ICI-connected slice this chip generation builds; beyond
    # it, scaling crosses DCN (the resource optimizer enumerates both).
    ici_domain: int = 256
    # On-demand $/chip-hour — the resource optimizer's $-cost proxy
    # (device-seconds weighted by price).  Analytical constant like the
    # rest of the table; 0.0 means "free" and disables cost ranking.
    cost_per_chip_hour: float = 0.0

    def peak(self, dtype: str) -> float:
        key = _canon_dtype(dtype)
        if key in self.peak_flops:
            return self.peak_flops[key]
        # Unknown dtype: fall back to fp32 rate.
        return self.peak_flops.get("float32", min(self.peak_flops.values()))


def _canon_dtype(dtype) -> str:
    s = str(dtype)
    for k in ("bfloat16", "float32", "float16", "int8", "float64", "float8"):
        if k in s:
            return k
    return s


# TPU v5e — the assignment's target numbers: 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s per ICI link.
TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops={
        "bfloat16": 197e12,
        "float16": 197e12,
        "int8": 394e12,
        "float8": 394e12,
        "float32": 49.25e12,   # 1/4 rate through the MXU
        "float64": 2.0e12,     # emulated; effectively "don't"
    },
    hbm_bytes=16e9,
    hbm_bw=819e9,
    vmem_bytes=128 * 2 ** 20,
    ici_bw_per_link=50e9,
    ici_links_per_axis=1,
    ici_domain=256,
    cost_per_chip_hour=1.20,
)

# TPU v5p — the training-class sibling: ~2.3x the bf16 rate, ~6x the HBM,
# bigger ICI domain, at a materially higher price point.  The interesting
# resource decisions (is a smaller count of fat chips cheaper than a pod of
# thin ones?) need exactly this contrast in the table.
TPU_V5P = ChipSpec(
    name="tpu_v5p",
    peak_flops={
        "bfloat16": 459e12,
        "float16": 459e12,
        "int8": 918e12,
        "float8": 918e12,
        "float32": 114.75e12,
        "float64": 4.0e12,
    },
    hbm_bytes=95e9,
    hbm_bw=2765e9,
    vmem_bytes=128 * 2 ** 20,
    ici_bw_per_link=90e9,
    ici_links_per_axis=1,
    ici_domain=1024,           # v5p slices scale far further over ICI (3D torus)
    ici_torus_dims=3,          # six ICI ports per chip: 2 per torus axis
    cost_per_chip_hour=4.20,
)

# TPU v6e (Trillium) — ~4.7x the v5e bf16 rate and 2x its HBM bandwidth at
# ~2.2x the price: usually the fastest *and* the cheapest per step, unless
# the workload is HBM-capacity bound (32 GB/chip).
TPU_V6E = ChipSpec(
    name="tpu_v6e",
    peak_flops={
        "bfloat16": 918e12,
        "float16": 918e12,
        "int8": 1836e12,
        "float8": 1836e12,
        "float32": 229.5e12,
        "float64": 4.0e12,
    },
    hbm_bytes=32e9,
    hbm_bw=1640e9,
    vmem_bytes=128 * 2 ** 20,
    ici_bw_per_link=90e9,
    ici_links_per_axis=1,
    ici_domain=256,
    cost_per_chip_hour=2.70,
)

# A CPU "chip" used ONLY by the accuracy benchmark (paper §3.4): the cost
# model's fidelity is validated against wall time on the machine we actually
# have.  Single core (the container), DGEMM-ish peak, DRAM bandwidth.
CPU_HOST = ChipSpec(
    name="cpu_host",
    peak_flops={
        "float32": 5.0e10,     # ~2.5GHz x 8-wide FMA x 2 on one core, derated
        "float64": 2.5e10,
        "bfloat16": 5.0e10,
    },
    hbm_bytes=32e9,
    hbm_bw=1.2e10,             # effective single-core stream bandwidth
    vmem_bytes=32 * 2 ** 20,   # L2-ish
    ici_bw_per_link=1e10,
    pcie_bw=1e12,              # host==device: transfers are memcpy-free-ish
    disk_bw=0.5e9,
    ici_domain=1,
    cost_per_chip_hour=0.10,
)

# One NVIDIA H100 SXM5 80GB, the card the port runs on.  Like CPU_HOST it is
# kept out of CHIPS: it exists to hold estimates against the runs on that
# card (paper §3.4), so the resource optimizer never enumerates it (one card
# can check no multi-card cluster) and no sweep cell moves.  Every figure is
# from NVIDIA's H100 Tensor Core GPU datasheet (SXM5 column, dense rates
# without sparsity, at the 700 W power limit); none is fitted to a run.
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops={
        "bfloat16": 989e12,    # BF16 tensor core
        "float16": 989e12,     # FP16 tensor core
        "int8": 1979e12,       # INT8 tensor core
        "float8": 1979e12,     # FP8 tensor core
        "float32": 67e12,      # FP32 outside the tensor cores
        "float64": 67e12,      # FP64 tensor core (what DGEMM runs on)
    },
    hbm_bytes=80e9,            # 80 GB HBM3
    hbm_bw=3.35e12,            # 3.35 TB/s
    vmem_bytes=50 * 2 ** 20,   # 50 MB L2 (only the fingerprint reads it)
    ici_bw_per_link=450e9,     # NVLink4: 900 GB/s both directions together
    ici_domain=8,              # eight cards on one NVLink/NVSwitch baseboard
    pcie_bw=64e9,              # PCIe Gen5 x16: 128 GB/s both directions
    cost_per_chip_hour=0.0,    # no price is assumed
)

# The chip table the resource optimizer enumerates over (cpu_host excluded:
# it exists for the accuracy benchmark, not as a serving/training target).
CHIPS: Dict[str, ChipSpec] = {
    "tpu_v5e": TPU_V5E,
    "tpu_v5p": TPU_V5P,
    "tpu_v6e": TPU_V6E,
}


# ---------------------------------------------------------------------------
# Cluster config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Everything the cost model may consult about the execution substrate.

    ``mesh_shape``/``mesh_axes`` describe the device mesh the plan targets
    (e.g. (16, 16) x ("data", "model") for one v5e pod, (2, 16, 16) x
    ("pod", "data", "model") for the multi-pod config).  The "pod" axis is
    assumed to cross DCN, all other axes ride ICI.
    """

    chip: ChipSpec = TPU_V5E
    mesh_shape: Tuple[int, ...] = (16, 16)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    # Per-mesh-axis ICI link counts, aligned with ``mesh_axes``.  Empty
    # (the default) means one effective link per axis — the flat model
    # every pre-torus mesh was calibrated with, kept bit-identical.  A 3D
    # logical mesh laid out on a 3D torus (v5p) sets 2 for each ICI axis:
    # the wrapped physical ring exposes both link directions, doubling the
    # per-axis bandwidth.  DCN ("pod") axes ignore the link count.
    torus_links: Tuple[int, ...] = ()

    # --- latency constants (the paper's job/task-latency analogues) ---
    dispatch_latency: float = 35e-6        # per jit-call launch
    collective_phase_latency: float = 1e-6  # per hop of a phased collective
    host_callback_latency: float = 1e-3

    # --- efficiency corrections (the paper's MMD_corr analogues) ---
    matmul_util: float = 0.75      # achievable fraction of MXU peak, large mms
    small_matmul_util: float = 0.30
    vpu_util: float = 0.80         # elementwise ops vs HBM roofline
    hbm_eff: float = 0.85          # achievable fraction of peak HBM bw
    ici_eff: float = 0.90
    dcn_eff: float = 0.80

    # fraction of collective time that can hide under compute when the plan
    # enables overlap (microbatched accumulation / async collectives).
    overlap_fraction: float = 0.0

    # Fitted corrections for this chip type (repro_torch.core.calibration) —
    # achieved fractions measured by benchmarks/bench_calibrate.py.  None
    # (the default) keeps the hand-set constants above bit-identical;
    # every consulting property below checks ``calibration is None``
    # first, so the uncalibrated path never changes.
    calibration: Optional[CalibrationProfile] = None

    # --- memory budgets (the paper's memory-budget analogue) ---
    hbm_budget_fraction: float = 0.9   # usable HBM fraction (runtime reserve)

    # --- control-flow defaults (paper §3.2) ---
    default_loop_iterations: int = 16   # N-hat for unknown while/for bounds
    default_branch_weights: Tuple[float, ...] = ()  # empty => uniform

    # --- job-level pricing constants (resource optimizer, $/job) ---
    # Analytical constants like everything else in this table (R1): they
    # never touch the per-step cost walk, only the job-level amortization
    # in ``repro_torch.core.resource.job_seconds`` / ``job_dollars``.
    job_startup_seconds: float = 180.0     # provision + weight load + compile
    # Constant override for the checkpoint-restore term of job pricing.
    # ``None`` (the default) derives restore time from the architecture's
    # checkpoint bytes over the disk+PCIe path, sharded across chips
    # (:func:`repro_torch.core.resource.checkpoint_restore_seconds`); callers
    # with no architecture in hand fall back to
    # :data:`DEFAULT_CHECKPOINT_RESTORE_SECONDS`.  Set a float to pin the
    # old constant-seconds behavior.
    checkpoint_restore_seconds: Optional[float] = None
    # Expected preemptions per chip-hour (large slices are preempted more
    # often in absolute terms: the rate scales with chip count).
    preemption_rate_per_chip_hour: float = 1e-4
    checkpoint_interval_steps: int = 1000  # work at risk between checkpoints

    # ----- derived -----
    @property
    def num_chips(self) -> int:
        return int(math.prod(self.mesh_shape))

    def axis_size(self, axis: str) -> int:
        try:
            return self.mesh_shape[self.mesh_axes.index(axis)]
        except ValueError:
            return 1

    @property
    def hbm_budget(self) -> float:
        return self.chip.hbm_bytes * self.hbm_budget_fraction

    def peak_flops_total(self, dtype: str = "bfloat16") -> float:
        return self.chip.peak(dtype) * self.num_chips

    # Effective bandwidths -------------------------------------------------
    @property
    def hbm_bw_eff(self) -> float:
        cal = self.calibration
        if cal is not None and cal.hbm_fraction is not None:
            return self.chip.hbm_bw * cal.hbm_fraction
        return self.chip.hbm_bw * self.hbm_eff

    @property
    def ici_bw_eff(self) -> float:
        cal = self.calibration
        if cal is not None and cal.ici_fraction is not None:
            return self.chip.ici_bw_per_link * cal.ici_fraction
        return self.chip.ici_bw_per_link * self.ici_eff

    @property
    def dcn_bw_eff(self) -> float:
        cal = self.calibration
        if cal is not None and cal.dcn_fraction is not None:
            return self.chip.dcn_bw * cal.dcn_fraction
        return self.chip.dcn_bw * self.dcn_eff

    # MXU efficiency -------------------------------------------------------
    def mxu_util(self, dtype: str, flops: float) -> float:
        """Achievable MXU fraction for one matmul of ``flops`` in
        ``dtype``.  Uncalibrated: the log-linear ramp from
        ``small_matmul_util`` (<=1e8 FLOPs) to ``matmul_util`` (>=1e10) —
        smooth, so estimated time stays monotone in problem size (a step
        function made bigger ops 'faster').  A calibration profile with a
        fitted (dtype, shape-class) entry replaces the ramp value for
        that class; uncovered classes keep the ramp.

        ``flops`` may be a knob-grid lane vector (the batched cost walk):
        the ramp is then evaluated per lane with the same float64 ops the
        scalar branch uses; a calibration profile classifies per lane, so
        calibrated vectors fall back to elementwise scalar calls."""
        import numpy as np
        if isinstance(flops, np.ndarray):
            if self.calibration is not None:
                return np.array([self.mxu_util(dtype, float(f))
                                 for f in flops], dtype=np.float64)
            lo, hi = 1e8, 1e10
            frac = (np.log10(flops) - 8.0) / 2.0
            ramp = self.small_matmul_util + frac * (self.matmul_util
                                                    - self.small_matmul_util)
            return np.where(flops <= lo, self.small_matmul_util,
                            np.where(flops >= hi, self.matmul_util, ramp))
        cal = self.calibration
        if cal is not None:
            f = cal.mxu_util(dtype, flops)
            if f is not None:
                return f
        lo, hi = 1e8, 1e10
        if flops <= lo:
            return self.small_matmul_util
        if flops >= hi:
            return self.matmul_util
        frac = (math.log10(flops) - 8.0) / 2.0
        return self.small_matmul_util + frac * (self.matmul_util
                                                - self.small_matmul_util)

    def mxu_util_ceiling(self, dtype: str) -> float:
        """The most generous MXU fraction ANY op of ``dtype`` can earn —
        what a sound cluster floor must price FLOPs at.  Uncalibrated this
        is ``max(matmul_util, small_matmul_util)`` (the ramp's endpoints
        bound it); a calibrated profile's per-class table raises or lowers
        it, but classes the table does not cover still fall back to the
        ramp, so the uncalibrated ceiling stays folded in."""
        ceiling = max(self.matmul_util, self.small_matmul_util)
        cal = self.calibration
        if cal is not None:
            return cal.mxu_ceiling(dtype, ceiling)
        return ceiling

    def overlap(self, fabric: str) -> float:
        """Effective overlap fraction for one fabric (``"ici"``/``"dcn"``).
        The *gate* stays with the plan: ``overlap_fraction == 0`` (plan
        did not enable overlap) always yields 0.  When the plan enables
        overlap, a calibrated per-fabric achieved overlap replaces the
        enabled value; uncalibrated both fabrics get ``overlap_fraction``
        unchanged."""
        if self.overlap_fraction == 0.0:
            return 0.0
        cal = self.calibration
        if cal is not None:
            o = cal.overlap_ici if fabric == "ici" else cal.overlap_dcn
            if o is not None:
                return o
        return self.overlap_fraction

    def link_class(self, axis: str) -> str:
        """``"dcn"`` for the pod axis (crosses the data-center network),
        ``"ici"`` for every other mesh axis.  The single source of truth
        for axis->fabric mapping: :meth:`link_bw` and the cost estimator's
        collective-volume accounting both route through it."""
        return "dcn" if axis == "pod" else "ici"

    def link_bw(self, axis: str) -> float:
        """Per-device *single-link* interconnect bandwidth along a mesh
        axis (fabric selection only; see :meth:`axis_bandwidth` for the
        topology-aware rate collectives are actually priced at)."""
        return (self.dcn_bw_eff if self.link_class(axis) == "dcn"
                else self.ici_bw_eff)

    def axis_links(self, axis: str) -> int:
        """ICI links usable along a mesh axis: the ``torus_links`` entry
        aligned with ``mesh_axes`` (1 when unset — the flat model).  DCN
        axes always report 1 (link counts describe the torus fabric)."""
        if self.link_class(axis) == "dcn" or not self.torus_links:
            return 1
        try:
            return max(int(self.torus_links[self.mesh_axes.index(axis)]), 1)
        except (ValueError, IndexError):
            return 1

    def axis_bandwidth(self, axis: str) -> float:
        """Per-device interconnect bandwidth along a mesh axis, link count
        included: ``link_bw(axis) * axis_links(axis)``.  On a 3D-torus mesh
        each ICI axis rides a wrapped physical ring with both directions
        usable (2 links), doubling the flat per-axis rate; every 2D mesh
        keeps the calibrated 1-link rate bit-identical."""
        return self.link_bw(axis) * self.axis_links(axis)

    def p2p_bw(self, axis: str) -> float:
        """Point-to-point path: per-device bandwidth of ONE link along a
        mesh axis — what a pipeline stage boundary's send/recv rides.  A
        neighbor transfer uses a single directed link, so the wrapped-ring
        doubling of :meth:`axis_bandwidth` (a ring-collective property)
        never applies; on a DCN ("pod") axis this is the inter-slice
        network path, which is exactly what makes pipeline-over-DCN the
        interesting plan family (one activation hop per microbatch instead
        of a ring collective's phased volume)."""
        return self.link_bw(axis)

    @property
    def max_ici_links(self) -> int:
        """The most links any ICI mesh axis exposes — the *most generous*
        per-axis rate, which is what the resource optimizer's cluster
        floors must price ICI wire at to stay sound."""
        return max((self.axis_links(a) for a in self.mesh_axes
                    if self.link_class(a) == "ici"), default=1)

    def with_mesh(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                  torus_links: Optional[Tuple[int, ...]] = None
                  ) -> "ClusterConfig":
        """Re-mesh, resetting ``torus_links`` unless new ones are given —
        link counts describe a specific axis layout and must never leak
        onto a differently-shaped mesh."""
        return dataclasses.replace(
            self, mesh_shape=tuple(shape), mesh_axes=tuple(axes),
            torus_links=tuple(torus_links) if torus_links else ())

    def with_overlap(self, fraction: float) -> "ClusterConfig":
        # The calibration profile rides along (dataclasses.replace keeps
        # every other field), so an overlap-enabled copy of a calibrated
        # config still consults the fitted per-fabric overlap values.
        return dataclasses.replace(self, overlap_fraction=float(fraction))

    def with_calibration(self, profile: Optional[CalibrationProfile]
                         ) -> "ClusterConfig":
        """Attach (or with ``None`` detach) a fitted calibration profile."""
        return dataclasses.replace(self, calibration=profile)

    def fingerprint(self) -> Tuple:
        """Hashable identity over every field the cost model may consult —
        part of the sub-plan memoization key.  Cached on the instance (the
        dataclass is frozen, so the fields can never drift)."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            chip = self.chip
            fp = (chip.name, tuple(sorted(chip.peak_flops.items())),
                  chip.hbm_bytes, chip.hbm_bw, chip.vmem_bytes,
                  chip.ici_bw_per_link, chip.ici_links_per_axis, chip.pcie_bw,
                  chip.host_dram_bw, chip.disk_bw, chip.dcn_bw,
                  chip.ici_domain, chip.ici_torus_dims, chip.ici_cube_dim,
                  chip.cost_per_chip_hour,
                  self.mesh_shape, self.mesh_axes, self.torus_links,
                  self.dispatch_latency,
                  self.collective_phase_latency, self.host_callback_latency,
                  self.matmul_util, self.small_matmul_util, self.vpu_util,
                  self.hbm_eff, self.ici_eff, self.dcn_eff,
                  self.overlap_fraction, self.hbm_budget_fraction,
                  self.default_loop_iterations,
                  tuple(self.default_branch_weights),
                  self.job_startup_seconds, self.checkpoint_restore_seconds,
                  self.preemption_rate_per_chip_hour,
                  self.checkpoint_interval_steps,
                  # calibrated and uncalibrated costs must never share a
                  # PlanCostCache entry
                  None if self.calibration is None
                  else self.calibration.fingerprint())
            object.__setattr__(self, "_fp", fp)
        return fp


# Fallback for job pricing when neither a constant override nor an
# architecture (to derive checkpoint bytes from) is available.
DEFAULT_CHECKPOINT_RESTORE_SECONDS = 60.0


# Canonical configs used throughout the repo ---------------------------------

def single_pod_config(**kw) -> ClusterConfig:
    return ClusterConfig(mesh_shape=(16, 16), mesh_axes=("data", "model"), **kw)


def torus_3d_config(mesh_shape: Tuple[int, int, int] = (4, 4, 4),
                    chip: ChipSpec = TPU_V5P, **kw) -> ClusterConfig:
    """A 3D-torus mesh cell: three ICI axes ("data", "model", "depth"),
    each a wrapped ring with both link directions usable (2 links/axis).
    Defaults to one v5p pod slice as a 4x4x4 cube."""
    if len(mesh_shape) != 3:
        raise ValueError(f"3D torus needs a 3-axis mesh, got {mesh_shape}")
    if chip.ici_torus_dims < 3:
        raise ValueError(f"{chip.name} builds {chip.ici_torus_dims}D tori; "
                         "a 3D mesh needs ici_torus_dims >= 3")
    return ClusterConfig(chip=chip, mesh_shape=tuple(mesh_shape),
                         mesh_axes=("data", "model", "depth"),
                         torus_links=(2, 2, 2), **kw)


def multi_pod_config(**kw) -> ClusterConfig:
    return ClusterConfig(
        mesh_shape=(2, 16, 16), mesh_axes=("pod", "data", "model"), **kw
    )


def single_chip_config(**kw) -> ClusterConfig:
    """The 'CP' execution-type analogue: one chip, no collectives."""
    return ClusterConfig(mesh_shape=(1,), mesh_axes=("data",), **kw)


def cpu_host_config(**kw) -> ClusterConfig:
    """For the paper-§3.4 accuracy benchmark on this container."""
    return ClusterConfig(
        chip=CPU_HOST,
        mesh_shape=(1,),
        mesh_axes=("data",),
        dispatch_latency=50e-6,
        matmul_util=0.60,
        **kw,
    )


def h100_single_config(**kw) -> ClusterConfig:
    """One H100 SXM (:data:`H100_SXM`): the port's card, no collectives.
    Every other field keeps the :class:`ClusterConfig` default (R1: no
    constant is fitted to a run on the card)."""
    return ClusterConfig(chip=H100_SXM, mesh_shape=(1,), mesh_axes=("data",),
                         **kw)


def h100_node_config(**kw) -> ClusterConfig:
    """One H100 SXM node: mesh ``(1, 8)`` over ``("data", "model")``, the
    eight cards of one NVLink/NVSwitch baseboard (:data:`H100_SXM`'s
    ``ici_bw_per_link`` and ``ici_domain``); both axes ride NVLink."""
    return ClusterConfig(chip=H100_SXM, mesh_shape=(1, 8),
                         mesh_axes=("data", "model"), **kw)


def h100_multi_node_config(**kw) -> ClusterConfig:
    """Two H100 SXM nodes: mesh ``(2, 1, 8)`` over ``("pod", "data",
    "model")``, the ``pod`` axis on the network between the nodes.  The
    network rate is a DGX H100's per node, from NVIDIA's DGX H100 datasheet:
    eight ConnectX-7 ports of 400 Gb/s each (the compute fabric), 8 x 400e9
    / 8 = 400e9 bytes/s, in place of the chip default's TPU figure."""
    chip = dataclasses.replace(H100_SXM, dcn_bw=8 * 400e9 / 8)
    return ClusterConfig(chip=chip, mesh_shape=(2, 1, 8),
                         mesh_axes=("pod", "data", "model"), **kw)


DTYPE_BYTES = {
    "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
    "int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8,
    "uint32": 4, "bool": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
}


_DTYPE_BYTES_CACHE: dict = {}


def dtype_bytes(dtype) -> int:
    s = str(dtype)
    hit = _DTYPE_BYTES_CACHE.get(s)
    if hit is not None:
        return hit
    out = 4
    for k, v in DTYPE_BYTES.items():
        if k in s:
            out = v
            break
    _DTYPE_BYTES_CACHE[s] = out
    return out
