"""White-box per-op FLOP/byte formulas (paper §3.3).

SystemML's cost model "consists of dozens of these white-box cost functions
for all existing instructions" — e.g.::

    FLOP(tsmm_left) = MMD_corr * m * n^2 * s        (dense)

Each formula here maps input :class:`TensorStat` s + attributes to an
:class:`OpProfile`: floating point ops, HBM read/write traffic, the output's
TensorStat, and a utilization class ("mxu" for matmul-shaped work, "vpu" for
elementwise/reduction work).  The cost model turns a profile into time via
the roofline ``max(flops/peak·util, bytes/hbm_bw)`` — the paper's
"maximum of main-memory IO and instruction-specific floating point
operations", with MXU/VPU taking the role of the 1-FLOP/cycle CPU.

Formulas count *multiply-add as 2 FLOPs* to stay commensurable with XLA's
``cost_analysis()`` (which counts fused multiply-add as 2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cluster import dtype_bytes
from repro_torch.core.npvec import HeterogeneousLanes, as_payload, dim_int, pmax
from repro_torch.core.symbols import MemState, TensorStat

# Operation-specific corrections (the paper's MMD_corr / MMS_corr analogues).
TSMM_CORR = 0.5          # symmetric output: half the computation
SOLVE_CHOL_CORR = 1.0 / 3.0

# Fused-epilogue flop charges per output cell — MUST stay equal to the
# standalone elementwise ops they replace (``silu``/``gelu``/``layernorm``
# below), so folding an epilogue into its producing matmul changes HBM
# traffic and *nothing else*: the fused-vs-materialized cost delta is
# exactly the intermediate's round trip (see docs/COST_MODEL.md
# §Costing fusion plans).
EPILOGUE_FLOPS_PER_CELL = {"bias": 1.0, "silu": 6.0, "gelu": 8.0,
                           "layernorm": 6.0}

# Materialized attention scores and the softmax over them run in fp32
# (XLA upcasts bf16 logits before the reduction), so the unfused score
# round trip is priced at accumulator width.
ATTN_SCORE_ACC_BYTES = 4.0


@dataclasses.dataclass
class OpProfile:
    flops: float
    read_bytes: float
    write_bytes: float
    out: TensorStat
    util: str = "mxu"            # "mxu" | "vpu"

    @property
    def bytes(self) -> float:
        return self.read_bytes + self.write_bytes


OpFn = Callable[..., OpProfile]
REGISTRY: Dict[str, OpFn] = {}


def register(name: str):
    def deco(fn: OpFn) -> OpFn:
        REGISTRY[name] = fn
        return fn
    return deco


def profile(opcode: str, inputs: Sequence[TensorStat], **attrs) -> OpProfile:
    if opcode not in REGISTRY:
        raise KeyError(f"no cost function registered for opcode '{opcode}'")
    return REGISTRY[opcode](*inputs, **attrs)


def _bytes(st: TensorStat) -> float:
    return st.bytes_in_memory()


def _out(shape, like: TensorStat, dtype=None, sparsity=1.0) -> TensorStat:
    # dim_int keeps knob-grid lane vectors (batched cost walk) intact.
    return TensorStat(tuple(dim_int(x) for x in shape), dtype or like.dtype,
                      sparsity=sparsity, state=MemState.HBM, shards=like.shards)


# ---------------------------------------------------------------------------
# Matrix multiplication family (the paper's ba+*, tsmm, mapmm, cpmm)
# ---------------------------------------------------------------------------


@register("matmul")
def _matmul(a: TensorStat, b: TensorStat, **attrs) -> OpProfile:
    """General (batched) matmul: [..., m, k] x [..., k, n].

    Fusion variants (the costed plan dimension — see docs/COST_MODEL.md
    §Costing fusion plans):

      * ``epilogue="bias"|"silu"|"gelu"|"layernorm"`` folds the named
        elementwise tail into the matmul flush: its flops ride the matmul
        (same per-cell charge as the standalone op) but the intermediate
        never round-trips HBM — the caller simply does not emit the
        separate op.  ``epi_cols`` narrows the epilogue to the first
        ``epi_cols`` output columns (a gated MLP applies the activation to
        d_ff of its 3*d_ff fused projection).
      * ``sink_cast_bytes=<width>`` sinks a dtype cast into the output
        write: the result leaves the MXU accumulator at ``width`` bytes
        per cell instead of the input dtype's, replacing a materialized
        read-modify-write ``cast`` op downstream.
    """
    *ba, m, k = a.shape
    *bb, k2, n = b.shape
    assert k == k2, f"matmul contraction mismatch {a.shape} x {b.shape}"
    batch = pmax(math.prod(ba) if ba else 1, math.prod(bb) if bb else 1)
    # sparse inputs scale flops by sparsity (paper's s / s^2 terms)
    s = a.sparsity * b.sparsity
    flops = 2.0 * batch * m * n * k * s
    out = _out(tuple(ba or bb) + (m, n), a)
    reads = _bytes(a) + _bytes(b)
    writes = _bytes(out)
    epi = attrs.get("epilogue")
    if epi:
        cols = attrs.get("epi_cols", n)
        flops = flops + EPILOGUE_FLOPS_PER_CELL[epi] * batch * m * cols
        if epi == "bias":
            reads = reads + n * dtype_bytes(a.dtype)
    sink = attrs.get("sink_cast_bytes")
    if sink is not None:
        writes = out.cells * as_payload(sink)
    return OpProfile(flops, reads, writes, out, "mxu")


@register("tsmm")
def _tsmm(x: TensorStat, **attrs) -> OpProfile:
    """Transpose-self matmul X^T X — symmetric output, half the compute.

    FLOP(tsmm_left) = TSMM_CORR * 2 * m * n^2 * s   (dense; paper Eq (2),
    doubled because we count mul+add separately like XLA does).
    """
    m, n = x.shape
    flops = TSMM_CORR * 2.0 * m * n * n * (x.sparsity if x.sparsity >= 0.4 else x.sparsity ** 2)
    out = _out((n, n), x)
    # read X once; write only the upper triangle then mirror (~n^2 writes)
    return OpProfile(flops, _bytes(x), _bytes(out), out, "mxu")


@register("transpose")
def _transpose(x: TensorStat, **attrs) -> OpProfile:
    out = _out(tuple(reversed(x.shape)), x, sparsity=x.sparsity)
    return OpProfile(0.0, _bytes(x), _bytes(out), out, "vpu")


@register("solve")
def _solve(a: TensorStat, b: TensorStat, **attrs) -> OpProfile:
    """Dense SPD solve via Cholesky: n^3/3 + 2 n^2 rhs."""
    n = a.shape[0]
    rhs = b.shape[1] if len(b.shape) > 1 else 1
    flops = SOLVE_CHOL_CORR * 2.0 * n ** 3 + 2.0 * 2.0 * n * n * rhs
    out = _out((n, rhs), b)
    return OpProfile(flops, _bytes(a) + _bytes(b), _bytes(out), out, "mxu")


# ---------------------------------------------------------------------------
# Elementwise / reduction / data movement
# ---------------------------------------------------------------------------


def _pick_big(ins: Sequence[TensorStat]) -> TensorStat:
    """The largest input by cells — ``max(ins, key=cells)`` made lane-safe.

    When some cell counts are knob-grid lane vectors, replay the builtin
    max's first-of-ties scan per lane; every lane must elect the same input
    (else the group's programs differ structurally per lane and the batched
    driver must fall back to scalar costing)."""
    if len(ins) == 1:
        return ins[0]
    try:
        return max(ins, key=lambda s: s.cells)
    except ValueError:  # truth-value ambiguity: at least one lane vector
        cells = [np.asarray(s.cells, dtype=np.float64) for s in ins]
        best = np.array(np.broadcast_to(cells[0], np.broadcast(*cells).shape))
        sel = np.zeros(best.shape, dtype=np.int64)
        for i in range(1, len(cells)):
            gt = cells[i] > best
            sel = np.where(gt, i, sel)
            best = np.maximum(best, cells[i])
        first = int(sel.flat[0])
        if not (sel == first).all():
            raise HeterogeneousLanes("lanes elect different elementwise "
                                     "broadcast shapes")
        return ins[first]


def _ew(arity: int, flops_per_cell: float = 1.0):
    def fn(*ins: TensorStat, **attrs) -> OpProfile:
        big = _pick_big(ins)
        out = _out(big.shape, big)
        reads = sum(_bytes(i) for i in ins)
        return OpProfile(flops_per_cell * big.cells, reads, _bytes(out), out, "vpu")
    return fn


REGISTRY["add"] = _ew(2)
REGISTRY["sub"] = _ew(2)
REGISTRY["mul"] = _ew(2)
REGISTRY["div"] = _ew(2, 4.0)
REGISTRY["unary"] = _ew(1)          # exp/tanh/gelu etc (approx 1 "flop"/cell
REGISTRY["gelu"] = _ew(1, 8.0)      # transcendental-heavy
REGISTRY["silu"] = _ew(1, 6.0)


@register("reduce")
def _reduce(x: TensorStat, **attrs) -> OpProfile:
    axes = attrs.get("axes")
    if axes is None:
        out_shape: Tuple[int, ...] = ()
    else:
        out_shape = tuple(d for i, d in enumerate(x.shape) if i not in set(axes))
    out = _out(out_shape, x)
    return OpProfile(as_payload(x.cells), _bytes(x), _bytes(out), out, "vpu")


@register("rdiag")
def _rdiag(v: TensorStat, **attrs) -> OpProfile:
    n = v.shape[0]
    out = _out((n, n), v, sparsity=1.0 / max(n, 1))
    return OpProfile(0.0, _bytes(v), out.bytes_serialized(), out, "vpu")


@register("concat")
def _concat(*ins: TensorStat, **attrs) -> OpProfile:
    axis = attrs.get("axis", -1)
    shape = list(ins[0].shape)
    shape[axis] = sum(i.shape[axis] for i in ins)
    out = _out(shape, ins[0])
    reads = sum(_bytes(i) for i in ins)
    return OpProfile(0.0, reads, _bytes(out), out, "vpu")


@register("softmax")
def _softmax(x: TensorStat, **attrs) -> OpProfile:
    out = _out(x.shape, x)
    return OpProfile(5.0 * x.cells, _bytes(x), _bytes(out), out, "vpu")


@register("layernorm")
def _layernorm(x: TensorStat, **attrs) -> OpProfile:
    out = _out(x.shape, x)
    return OpProfile(6.0 * x.cells, _bytes(x), _bytes(out), out, "vpu")


@register("embedding")
def _embedding(ids: TensorStat, table: TensorStat, **attrs) -> OpProfile:
    d = table.shape[-1]
    out = _out(tuple(ids.shape) + (d,), table)
    # gather reads only the selected rows
    reads = _bytes(ids) + out.bytes_in_memory()
    return OpProfile(0.0, reads, _bytes(out), out, "vpu")


# ---------------------------------------------------------------------------
# Attention / MoE / SSM composite ops (white-box composites used by the
# analytical planner; the generated-plan path gets exact numbers from HLO)
# ---------------------------------------------------------------------------


def avg_keys_per_query(sq: int, skv: int, window, causal: bool) -> float:
    """Exact average number of keys each query attends to.

    Queries occupy the last ``sq`` positions of a ``skv``-long context
    (decode/suffix convention): query i sees ``min(skv - sq + i + 1, w)``
    keys under a causal mask with window ``w`` (``w = skv`` when
    unwindowed).  The closed-form average prices windowed *and* causal
    attention correctly where the window overhangs the sequence start —
    the legacy profile's all-or-nothing ``frac=0.5`` granted no causal
    discount there at all.
    """
    w = min(window, skv) if window else skv
    if not causal:
        return float(w)
    lo, hi = skv - sq + 1, skv          # visible-key counts, pre-clamp
    if w >= hi:
        return (lo + hi) / 2.0
    if w <= lo:
        return float(w)
    # queries with <= w visible keys average (lo+w)/2; the rest clamp at w
    return ((w - lo + 1) * (lo + w) / 2.0 + (hi - w) * w) / sq


@register("attention")
def _attention(q: TensorStat, k: TensorStat, v: TensorStat, **attrs) -> OpProfile:
    """Scaled dot-product attention, optionally windowed/causal.

    q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D].  ``window`` limits keys per
    query (sliding window); causal halves the score work.

    The ``fused`` attr selects the fusion variant (the costed plan
    dimension).  Absent — the legacy profile: flash-style fusion assumed
    unconditionally (reads only q+k+v) and the coarse all-or-nothing
    causal discount; every pre-fusion baseline rides on this path
    bit-identically.  ``fused=True`` — the flash plan, priced with the
    exact averaged keys-per-query discount.  ``fused=False`` — the
    *materialized* plan: same flops, plus the B*Hq*Sq*Skv score matrix's
    HBM round trip (fp32 scores written + read by softmax, probs written
    + read by the AV matmul at input width).
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    window = attrs.get("window")
    eff_kv = min(skv, window) if window else skv
    causal = attrs.get("causal", False)
    out = _out((b, hq, sq, d), q)
    reads = _bytes(q) + _bytes(k) + _bytes(v)
    if "fused" not in attrs:
        frac = 0.5 if (causal and eff_kv == skv and sq == skv) else 1.0
        score_flops = 2.0 * b * hq * sq * eff_kv * d * frac
        av_flops = 2.0 * b * hq * sq * eff_kv * d * frac
        softmax_flops = 5.0 * b * hq * sq * eff_kv * frac
        return OpProfile(score_flops + av_flops + softmax_flops, reads,
                         _bytes(out), out, "mxu")
    avg = avg_keys_per_query(sq, skv, window, causal)
    score_flops = 2.0 * b * hq * sq * avg * d
    av_flops = 2.0 * b * hq * sq * avg * d
    softmax_flops = 5.0 * b * hq * sq * avg
    writes = _bytes(out)
    if not attrs["fused"]:
        # The materialized plan pays the full rectangular score matrix
        # (masked entries are computed-and-discarded, not skipped).
        score_cells = b * hq * sq * skv
        bpe = dtype_bytes(q.dtype)
        reads = reads + score_cells * (ATTN_SCORE_ACC_BYTES + bpe)
        writes = writes + score_cells * (ATTN_SCORE_ACC_BYTES + bpe)
    return OpProfile(score_flops + av_flops + softmax_flops, reads,
                     writes, out, "mxu")


@register("moe_ffn")
def _moe_ffn(x: TensorStat, w_up: TensorStat, **attrs) -> OpProfile:
    """Routed expert FFN: tokens x d -> top-k of E experts, gated MLP.

    w_up: [E, d, ff].  Expected compute scales with k/E "sparsity" — the
    paper's sparse-size math reused for expert load.
    """
    tokens = math.prod(x.shape[:-1])
    d = x.shape[-1]
    e, _, ff = w_up.shape
    k = attrs.get("top_k", 2)
    gated = 3.0 if attrs.get("gated", True) else 2.0
    flops = gated * 2.0 * tokens * k * d * ff
    out = _out(x.shape, x)
    reads = _bytes(x) + e * d * ff * gated * dtype_bytes(w_up.dtype)
    return OpProfile(flops, reads, _bytes(out), out, "mxu")


@register("ssd_scan")
def _ssd_scan(x: TensorStat, **attrs) -> OpProfile:
    """Mamba2 SSD chunked scan: [B, S, H, P] with state size N per head.

    Chunked dual form: intra-chunk (quadratic in chunk), inter-chunk state
    passing — flops ≈ 2*B*S*H*P*(chunk + 2N).
    """
    b, s, h, p = x.shape
    n = attrs.get("state", 128)
    chunk = attrs.get("chunk", 256)
    flops = 2.0 * b * s * h * p * (chunk + 2 * n)
    out = _out(x.shape, x)
    # ceil, not floor: a sequence shorter than one chunk still carries its
    # state once (floor costed s < chunk at ZERO state bytes).  Written as
    # -(-s // chunk) to stay lane-vector safe.
    n_chunks = -(-s // max(chunk, 1))
    state_bytes = b * h * p * n * dtype_bytes(x.dtype) * n_chunks
    return OpProfile(flops, _bytes(x) + state_bytes, _bytes(out), out, "mxu")


@register("cast")
def _cast(x: TensorStat, **attrs) -> OpProfile:
    """Materialized dtype cast: one read-modify-write over the buffer.

    ``from_bytes``/``to_bytes`` override the element widths (the input
    stat may stand in for a buffer of another dtype — e.g. the fp32
    gradient accumulator addressed through the ``params`` variable).  The
    fused alternative is no instruction at all: ``sink_cast_bytes`` on the
    producing matmul writes the target width straight out of the
    accumulator, so this op's whole profile IS the fusion delta.
    """
    cells = as_payload(x.cells)
    from_b = attrs.get("from_bytes", dtype_bytes(x.dtype))
    to_b = attrs.get("to_bytes", dtype_bytes(x.dtype))
    out = _out(x.shape, x)
    return OpProfile(1.0 * cells, cells * from_b, cells * to_b, out, "vpu")


@register("cross_entropy")
def _xent(logits: TensorStat, **attrs) -> OpProfile:
    out = _out((), logits)
    return OpProfile(8.0 * logits.cells, _bytes(logits), 4.0, out, "vpu")


@register("adamw_update")
def _adamw(p: TensorStat, **attrs) -> OpProfile:
    # read p, g, m, v; write p, m, v — ~14 flops/param
    out = _out(p.shape, p)
    b = _bytes(p)
    return OpProfile(14.0 * p.cells, 4 * b, 3 * b, out, "vpu")


# ---------------------------------------------------------------------------
# Collective payload/time formulas (ring algorithms on a torus axis)
# ---------------------------------------------------------------------------


def collective_wire(kind: str, bytes_per_device: float,
                    axis_size: Union[int, Sequence[int]]
                    ) -> Tuple[float, int]:
    """(wire bytes per device, hop count) for one collective over a mesh
    axis — or, given a tuple of sizes, over several axes of a torus mesh
    phased hierarchically (the 3D-mesh form).

    Ring formulas (bytes are the *per-device* payload B):
      all_gather / reduce_scatter: (n-1)/n * B_total_or_shard semantics —
        we take B as the per-device INPUT payload:
          all_gather:      each device ends with n*B; wire bytes (n-1)*B
          reduce_scatter:  input n*B-ish handled by caller; here B is the
                           per-device input, wire bytes (n-1)/n * B
      all_reduce = reduce_scatter + all_gather = 2*(n-1)/n * B
      all_to_all: (n-1)/n * B
      permute: B, 1 hop

    Multi-axis semantics mirror the cost estimator's per-axis phasing: the
    wire volumes and hops of each axis add, and a hierarchical all_gather
    grows the payload by each axis it crosses.  A size-1 axis contributes
    nothing, so the 3D form degenerates *bit-exactly* to the 2D answer
    when the third axis has size 1 (property-tested in
    ``tests/test_torus3d.py``).

    The wire volume is the bandwidth-bound part of the collective's cost
    (time = wire/link_bw + hops*phase_latency); the cost estimator also
    accumulates it into :class:`repro_torch.core.costmodel.ProgramTotals`, where
    it feeds the resource optimizer's sound collective floors.
    """
    if not isinstance(axis_size, (int, float)):
        wire, hops = 0.0, 0
        for w, h in collective_phases(kind, bytes_per_device, axis_size):
            wire += w
            hops += h
        return wire, hops
    n = max(int(axis_size), 1)
    if n == 1:
        return 0.0, 0
    b = as_payload(bytes_per_device)
    if kind == "all_reduce":
        return 2.0 * (n - 1) / n * b, 2 * (n - 1)
    if kind == "all_gather":
        return (n - 1) * b, n - 1
    if kind == "reduce_scatter":
        return (n - 1) / n * b, n - 1
    if kind == "all_to_all":
        return (n - 1) / n * b, n - 1
    if kind in ("permute", "collective_permute"):
        return b, 1
    raise KeyError(f"unknown collective kind '{kind}'")


def collective_phases(kind: str, bytes_per_device: float,
                      axis_sizes: Sequence[int]):
    """Yield ``(wire bytes, hops)`` for each axis phase of a multi-axis
    collective, applying the hierarchical payload-growth rule between
    phases (an all_gather's payload multiplies by every axis it crosses).

    The single source of the phasing semantics: the cost estimator's
    per-axis pricing loop (``CostEstimator._cost_collective``, which needs
    each phase separately because axes carry different bandwidths) and the
    tuple form of :func:`collective_wire` both consume it, so the two can
    never drift apart."""
    payload = as_payload(bytes_per_device)
    for n in axis_sizes:
        yield collective_wire(kind, payload, int(n))
        if kind == "all_gather":
            # rebind, never *=: a lane-vector payload aliases the caller's
            # array (bytes_override / a TensorStat's cached bytes), and an
            # in-place multiply would corrupt it for every later walk
            payload = payload * max(int(n), 1)


def p2p_wire(bytes_per_device: float, axis_size: int) -> Tuple[float, int]:
    """(wire bytes per device, hop count) for a neighbor-to-neighbor
    send/recv along a mesh axis — the pipeline stage-boundary primitive.

    The payload crosses exactly one link once (no ring phases, no payload
    growth), so the wire volume is the payload itself and the hop count is
    1.  A size-1 axis has no neighbor: the transfer is a no-op (0 bytes,
    0 hops), which is what makes an S=1 "pipeline" degenerate bit-exactly
    to the sequential loop.
    """
    if int(axis_size) <= 1:
        return 0.0, 0
    return as_payload(bytes_per_device), 1


def p2p_cost(bytes_per_device: float, axis_size: int,
             link_bw: float, phase_latency: float) -> float:
    """Time for one stage-boundary send/recv: ``payload / link_bw +
    phase_latency`` across one link.

    Unlike :func:`collective_cost` there is no ``links`` parameter: a p2p
    transfer rides a single directed link of the fabric, so the wrapped-
    ring doubling a 3D torus grants collectives (both ring directions
    usable) never applies — price it at the *single-link* rate
    (``ClusterConfig.p2p_bw``), not ``axis_bandwidth``.
    """
    wire, hops = p2p_wire(bytes_per_device, axis_size)
    if not hops:
        return 0.0
    return wire / link_bw + hops * phase_latency


def collective_cost(kind: str, bytes_per_device: float,
                    axis_size: Union[int, Sequence[int]],
                    link_bw: float, phase_latency: float,
                    links: int = 1) -> float:
    """Time for one collective over an axis of ``axis_size`` devices:
    ``wire_bytes / (link_bw * links) + hops * phase_latency`` with the
    ring-algorithm wire volumes of :func:`collective_wire`.  ``links`` is
    the per-axis link count of the torus geometry (2 on a 3D-torus axis,
    1 on the flat model — see ``ClusterConfig.axis_bandwidth``)."""
    wire, hops = collective_wire(kind, bytes_per_device, axis_size)
    if not hops:
        return 0.0
    return wire / (link_bw * max(int(links), 1)) + hops * phase_latency
