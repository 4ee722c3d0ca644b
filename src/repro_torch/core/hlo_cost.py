"""Costing the *generated* plan: the data side (the port's copy).

SystemML costs runtime plans *after* all compilation phases so every
optimizer decision is automatically reflected.  The reference lowers and
compiles its jitted step with XLA and reads FLOPs, bytes, collectives and
memory back out of the compiled module; that lowering is not part of this
copy (its PyTorch counterpart is a later ``graph_cost`` module).  What is
here is the pure-data side it produces:

  * :func:`parse_collectives` — per-collective payloads from optimized HLO
    text,
  * :class:`CompiledCost` / :class:`CollectiveStat` — a pure-data artifact
    that can be costed under any :class:`ClusterConfig` (R3), serialized to
    JSON, and embedded into a runtime plan as a ``JitCall``.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.linalg_ops import collective_cost

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_HLO_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    # sub-byte
    "s4": 0.5, "u4": 0.5, "s2": 0.25, "u2": 0.25, "f4e2m1fn": 0.5,
    # fp8 family (incl. the fnuz/b11 variants and the scale dtype)
    "f8e4m3": 1, "f8e4m3fn": 1, "f8e4m3fnuz": 1, "f8e4m3b11fnuz": 1,
    "f8e5m2": 1, "f8e5m2fnuz": 1, "f8e3m4": 1, "f8e8m0fnu": 1,
    # zero-size control types
    "token": 0,
}

# dtype token: letters+digits with an optional exponent/mantissa suffix
# tail ("fn", "fnuz", "b11fnuz", ...), immediately followed by [dims]
_SHAPE_RE = re.compile(r"([a-z]+[0-9]*(?:e[0-9]+m[0-9]+[a-z0-9]*)?)\[([0-9,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^)]*\)|[^ ]+)\s+([\w\-]+)")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_EXPLICIT_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _shape_bytes(sig: str, unknown: Optional[set] = None) -> float:
    """Sum byte sizes of every dtype[dims] token in a type signature.

    A dtype missing from the table used to be *silently skipped*, which
    undercounted collective payloads and corrupted any calibration profile
    fitted from them.  Unknowns now take a conservative 4-byte estimate
    and are reported through ``unknown`` (a set the caller may pass) so
    downstream consumers — :attr:`CompiledCost.unknown_dtypes` — can
    reject polluted samples instead of fitting garbage.
    """
    total = 0.0
    for dtype, dims in _SHAPE_RE.findall(sig):
        nbytes = _HLO_DTYPE_BYTES.get(dtype)
        if nbytes is None:
            nbytes = 4
            if unknown is not None:
                unknown.add(dtype)
        cells = 1
        if dims:
            for d in dims.split(","):
                cells *= int(d)
        total += cells * nbytes
    return total


@dataclasses.dataclass
class CollectiveStat:
    kind: str                  # canonical: all_gather, all_reduce, ...
    operand_bytes: float       # per-device input payload
    result_bytes: float
    group_size: int
    hlo_name: str = ""

    def attribute_axis(self, cc: ClusterConfig) -> Optional[str]:
        """Best-effort mesh-axis attribution of an unnamed collective by
        its replica-group size.  Compiled HLO never names mesh axes, but
        the group size constrains which fabric the payload rode:

        * a group exactly the size of one ICI axis is priced on that axis
          (the most generous one when several match — consistent with the
          best-case default);
        * a group exactly the size of a DCN ("pod") axis crossed DCN;
        * a group spanning MORE chips than all ICI axes combined cannot
          have stayed on the torus — it crossed the pod axis, and pricing
          it at torus-doubled ICI rates flatters every DCN-bound cell;
        * anything else (a multi-axis ICI group) stays unattributed
          (``None`` — callers fall back to best-case ICI).
        """
        g = self.group_size
        if g <= 1:
            return None
        ici_axes = [a for a in cc.mesh_axes if cc.link_class(a) == "ici"]
        dcn_axes = [a for a in cc.mesh_axes if cc.link_class(a) == "dcn"]
        exact_ici = [a for a in ici_axes if cc.axis_size(a) == g]
        if exact_ici:
            return max(exact_ici, key=cc.axis_links)
        exact_dcn = [a for a in dcn_axes if cc.axis_size(a) == g]
        if exact_dcn:
            return exact_dcn[0]
        ici_chips = 1
        for a in ici_axes:
            ici_chips *= cc.axis_size(a)
        if g > ici_chips and dcn_axes:
            return dcn_axes[0]
        return None

    def time(self, cc: ClusterConfig, axis: Optional[str] = None) -> float:
        # Topology-aware rate via the links= form (2 links/axis on a
        # 3D-torus mesh) — the same rate the analytical estimator charges,
        # so JitCall-embedded and native plans stay commensurable on torus
        # meshes.  Unnamed collectives are attributed by group size
        # (attribute_axis); only genuinely ambiguous multi-axis ICI groups
        # keep the best-case ICI assumption at max_ici_links.
        if axis is None:
            axis = self.attribute_axis(cc)
        if axis is not None:
            bw, links = cc.link_bw(axis), cc.axis_links(axis)
        else:
            bw, links = cc.ici_bw_eff, cc.max_ici_links
        return collective_cost(self.kind, self.operand_bytes, self.group_size,
                               bw, cc.collective_phase_latency, links=links)


def parse_collectives(hlo_text: str,
                      unknown_out: Optional[set] = None
                      ) -> List[CollectiveStat]:
    """Extract every collective op's payload from optimized HLO text.

    Operand shapes are not inline in modern HLO dumps, so we first build a
    name -> result-type map over all instruction definitions, then resolve
    each collective's operand list against it.  ``*-done`` ops are skipped
    (their payload was counted at ``*-start``).  Dtypes missing from the
    byte table are counted at a conservative 4 bytes and collected into
    ``unknown_out`` (when given) so callers can flag polluted payloads.
    """
    shapes: Dict[str, str] = {}
    coll_lines: List[Tuple[str, str, str, str]] = []  # (name, sig, opcode, line)
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, sig, opcode = m.groups()
        shapes[name] = sig
        base = opcode
        for c in COLLECTIVE_OPS:
            if opcode == c or opcode == c + "-start":
                coll_lines.append((name, sig, c, line))
                break

    out: List[CollectiveStat] = []
    for name, sig, kind, line in coll_lines:
        # operands: %names inside the first (...) after the opcode
        try:
            args_str = line.split(kind, 1)[1]
            args_str = args_str[args_str.index("("): args_str.index(")") + 1]
        except (ValueError, IndexError):
            args_str = ""
        operand_bytes = 0.0
        for op_name in _OPERAND_RE.findall(args_str):
            operand_bytes += _shape_bytes(shapes.get(op_name, ""),
                                          unknown=unknown_out)
        result_bytes = _shape_bytes(sig, unknown=unknown_out)
        if operand_bytes == 0.0:
            # parameter-less forms: fall back to result size
            operand_bytes = result_bytes
        gm = _IOTA_GROUPS_RE.search(line)
        if gm:
            group_size = int(gm.group(2))
        else:
            ge = _EXPLICIT_GROUPS_RE.search(line)
            group_size = len(ge.group(1).split(",")) if ge else 1
        out.append(CollectiveStat(kind.replace("-", "_"), operand_bytes,
                                  result_bytes, group_size, name))
    return out


@dataclasses.dataclass
class CompiledCost:
    """Pure-data cost record of one compiled executable (per-device view)."""

    name: str
    flops_per_device: float
    bytes_per_device: float          # HBM bytes accessed
    collectives: List[CollectiveStat]
    num_devices: int
    # memory_analysis (per device, bytes)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    peak_memory_bytes: float = 0.0
    dispatch_count: int = 1          # jit calls represented (for latency)
    # dtype tokens the HLO walk could not size (counted at a conservative
    # 4 bytes each) — non-empty means collective payloads are estimates,
    # and calibration fitting must reject this record as polluted.
    unknown_dtypes: List[str] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------- derive
    @property
    def total_flops(self) -> float:
        return self.flops_per_device * self.num_devices

    @property
    def collective_bytes(self) -> float:
        return sum(c.operand_bytes for c in self.collectives)

    def collective_bytes_by_kind(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        for c in self.collectives:
            agg[c.kind] = agg.get(c.kind, 0.0) + c.operand_bytes
        return agg

    def fits(self, cc: ClusterConfig) -> bool:
        used = self.peak_memory_bytes or (self.argument_bytes + self.output_bytes
                                          + self.temp_bytes)
        return used <= cc.hbm_budget

    # The three roofline terms (assignment §Roofline) -------------------
    def roofline(self, cc: ClusterConfig, dtype: str = "bfloat16") -> Dict[str, Any]:
        compute_s = self.flops_per_device / cc.chip.peak(dtype)
        memory_s = self.bytes_per_device / cc.chip.hbm_bw
        collective_s = sum(
            collective_cost(c.kind, c.operand_bytes, c.group_size,
                            cc.chip.ici_bw_per_link, cc.collective_phase_latency)
            for c in self.collectives)
        terms = {"compute_s": compute_s, "memory_s": memory_s,
                 "collective_s": collective_s}
        dominant = max(terms, key=terms.get)
        bound = max(terms.values())
        total = sum(terms.values())
        return {
            **terms,
            "dominant": dominant,
            "roofline_bound_s": bound,
            "roofline_fraction": bound / total if total > 0 else 1.0,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
        }

    def time_breakdown(self, cc: ClusterConfig):
        """Estimated wall time of one call under ``cc`` (for JitCall)."""
        from repro_torch.core.costmodel import CostBreakdown  # local: avoid cycle
        r = self.roofline(cc)
        # achievable (not peak) rates for the time estimate; compiled
        # modules report bf16-dominated MXU work, and cc.mxu_util routes
        # through the shape-class ramp / fitted calibration profile
        compute = max(self.flops_per_device
                      / (cc.chip.peak("bfloat16")
                         * cc.mxu_util("bfloat16", self.flops_per_device)),
                      self.bytes_per_device / cc.hbm_bw_eff)
        # Compiled HLO does not name mesh axes; CollectiveStat.time
        # attributes each collective to a fabric by replica-group size
        # (exact ICI-axis matches ride that axis's torus-aware rate, a
        # group spanning more chips than the whole torus is priced at DCN
        # rates, ambiguous multi-axis ICI groups keep the best-case ICI
        # assumption) — a single-axis 2D/3D ICI mesh prices exactly as
        # the analytical estimator would.
        collective = sum(c.time(cc) for c in self.collectives)
        return CostBreakdown(io=0.0, compute=compute, collective=collective,
                             latency=cc.dispatch_latency * self.dispatch_count)

    def summary(self) -> str:
        return (f"{self.flops_per_device:.3g} flops/dev, "
                f"{self.bytes_per_device:.3g} B/dev, "
                f"{self.collective_bytes:.3g} coll B/dev x{len(self.collectives)}")

    # --------------------------------------------------------------- (de)ser
    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "CompiledCost":
        d = dict(d)
        d["collectives"] = [CollectiveStat(**c) for c in d.get("collectives", [])]
        return CompiledCost(**d)
