"""Cost-based plan selection (the optimizers the paper's model serves).

SystemML's compiler makes *execution-type* decisions (CP vs MR), *physical
operator* choices (tsmm / mapmm / cpmm), and *resource* decisions, all
evaluated through C(P, cc).  The TPU analogue optimizes a **sharding plan**
for each (architecture x input shape x mesh):

  * role of the mesh axes: tensor-parallel, expert-parallel, FSDP,
    pipeline-parallel (the layer stack split into stages along an axis —
    over ICI on a "depth" axis, or across DCN slices on the "pod" axis),
    or pure extra data-parallelism,
  * remat (activation checkpointing) policy: none / selective / full,
  * microbatch count (gradient accumulation — reinterpreted as the
    pipeline's M for pipelined roles),
  * gradient-reduction dtype (compression),
  * collective/compute overlap.

For every candidate plan we *generate* an analytical runtime plan — a
:class:`Program` of per-layer instructions and collectives, with the layer
stack expressed as a ForBlock exactly like the paper costs loops — and rank
by ``C(P, cc)`` subject to the HBM budget.  The winner is then validated by
compiling the real jitted step and costing the generated HLO
(:mod:`repro_torch.core.hlo_cost`) — cost the *generated* plan, per the paper.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.cluster import ClusterConfig, dtype_bytes
from repro_torch.core.costmodel import (CacheStats, CostedProgram, PlanCostCache,
                                        estimate, split_costed_lanes)
from repro_torch.core.dominance import DominancePool
from repro_torch.core.npvec import (HeterogeneousLanes, dim_ceil, dim_int, is_vec,
                                    pmax, pmin, uniform_bool)
from repro_torch.core.plan import (Collective, Compute, CreateVar, DataGen, ForBlock,
                                   GenericBlock, IO, P2P, PipelinedLoopBlock,
                                   Program)
from repro_torch.core.symbols import MemState, TensorStat

# Fraction of collective time hidden under compute when a plan enables
# overlap (all enumerated plans do).  Candidate costing applies it via
# ``cc.with_overlap``; the resource optimizer's collective floors discount
# by the same constant, so a drift here cannot silently unsound the floors.
OVERLAP_FRACTION = 0.7

# The enumerated microbatch knob (train mode).  For pipelined roles the
# knob is reinterpreted as the schedule's M; its ceiling bounds how far a
# pipeline can amortize its (S-1) fill/drain bubbles, which is what the
# resource optimizer's pipeline-aware floor divides by
# (``cluster_floor_time``: time >= roofline/S * (1 + (S-1)/M)).
MICRO_OPTS = (1, 2, 4, 8)
MAX_MICROBATCHES = MICRO_OPTS[-1]

# The operator-fusion plan dimension (PAPERS.md arXiv 1801.00829 — fusion
# plans as a costed compiler decision).  "off" emits the legacy fusion-
# blind profiles bit-identically (every pre-fusion baseline rides on it);
# "none" is the honest *materialized* plan (unfused attention pays its
# score-matrix round trip, casts are explicit instructions); "full" is the
# fused plan (flash attention, act/norm epilogues folded into their
# producing matmuls, casts sunk into the output write).  The value of the
# knob is exactly the HBM-traffic delta ProgramTotals already tracks.
FUSION_OPTS = ("off", "none", "full")


def _fusion_space(fusion: str) -> List[str]:
    """The enumerated fusion settings: ``"search"`` opens the full knob,
    any single setting pins it (default ``"off"`` — the legacy space)."""
    if fusion == "search":
        return list(FUSION_OPTS)
    if fusion in FUSION_OPTS:
        return [fusion]
    raise ValueError(f"unknown fusion setting {fusion!r}; "
                     f"one of {FUSION_OPTS + ('search',)}")


# ---------------------------------------------------------------------------
# Sharding plan: the searchable decision vector
# ---------------------------------------------------------------------------


class VecKnob:
    """A per-lane knob vector standing in for one scalar ShardingPlan field
    during a batched build (``cost_candidates_batched``): lane ``j`` holds
    group member ``j``'s knob value.  ``microbatches`` lanes carry the
    counts themselves; ``grad_reduce_dtype`` lanes carry the *byte widths*
    (the only thing the program builder reads off the dtype)."""

    __slots__ = ("values", "display")

    def __init__(self, values, display: str = "vec"):
        self.values = np.asarray(values)
        self.display = display

    def __str__(self) -> str:
        return f"<{self.display}x{self.values.shape[0]}>"

    __repr__ = __str__


def _kv(x):
    """Unwrap a possibly-:class:`VecKnob` knob to its numeric value(s)."""
    return x.values if isinstance(x, VecKnob) else x


def _gd_bytes(gd) -> int:
    """Byte width of the grad-reduce dtype knob (per-lane when batched)."""
    return gd.values if isinstance(gd, VecKnob) else dtype_bytes(gd)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    name: str = "dp"
    batch_axes: Tuple[str, ...] = ("data",)
    tp_axes: Tuple[str, ...] = ()          # heads / ff sharding
    fsdp_axes: Tuple[str, ...] = ()        # ZeRO-3 param sharding
    ep_axes: Tuple[str, ...] = ()          # MoE expert sharding
    seq_axes: Tuple[str, ...] = ()         # sequence-parallel (long prefill)
    pp_axes: Tuple[str, ...] = ()          # pipeline stages over this axis
    remat: str = "none"                    # none | selective | full
    microbatches: int = 1
    grad_reduce_dtype: str = "float32"
    overlap: bool = True
    zero1: bool = True                     # shard optimizer state over data
    fusion: str = "off"                    # off | none | full (FUSION_OPTS)

    def degree(self, cc: ClusterConfig, axes: Tuple[str, ...]) -> int:
        d = 1
        for a in axes:
            d *= cc.axis_size(a)
        return d

    def eff_degree(self, cc: ClusterConfig, axes: Tuple[str, ...],
                   units: int) -> int:
        """Effective parallelism: the axes product only divides the work
        when it divides the unit count — otherwise GSPMD (and our sharding
        rules) replicate, and the honest degree is 1.  (A dp-pure plan
        'sharding' batch=32 over 256 chips actually replicates the whole
        model on every chip — caught by the generated-plan costing, see
        EXPERIMENTS.md §Perf cell 2.)"""
        d = self.degree(cc, axes)
        if is_vec(units):   # per-lane unit counts (batched build)
            if d <= 0:
                return np.ones_like(units)
            return np.where(units % d == 0, d, 1)
        return d if (d > 0 and units % d == 0) else 1

    def describe(self) -> str:
        bits = [f"batch={'x'.join(self.batch_axes) or '-'}"]
        if self.tp_axes:
            bits.append(f"tp={'x'.join(self.tp_axes)}")
        if self.fsdp_axes:
            bits.append(f"fsdp={'x'.join(self.fsdp_axes)}")
        if self.ep_axes:
            bits.append(f"ep={'x'.join(self.ep_axes)}")
        if self.seq_axes:
            bits.append(f"seq={'x'.join(self.seq_axes)}")
        if self.pp_axes:
            bits.append(f"pp={'x'.join(self.pp_axes)}")
        bits.append(f"remat={self.remat}")
        if isinstance(self.microbatches, VecKnob) or self.microbatches > 1:
            bits.append(f"ubatch={self.microbatches}")
        if (isinstance(self.grad_reduce_dtype, VecKnob)
                or self.grad_reduce_dtype != "float32"):
            bits.append(f"gdtype={self.grad_reduce_dtype}")
        if self.fusion != "off":           # "off" keeps legacy strings
            bits.append(f"fusion={self.fusion}")
        return f"{self.name}[{','.join(bits)}]"


# ---------------------------------------------------------------------------
# Analytical step-program generation (white-box, per layer, ForBlock)
# ---------------------------------------------------------------------------


def _ts(shape, dtype="bfloat16", shards=1, state=MemState.HBM, sparsity=1.0):
    # dim_int/pmax keep knob-grid lane vectors (batched build) intact; the
    # scalar path is the same int()/max() it has always been.
    return TensorStat(tuple(dim_int(x) for x in shape), dtype, sparsity, state,
                      pmax(dim_int(shards), 1))


def build_step_program(arch: ArchConfig, shape: ShapeConfig, plan: ShardingPlan,
                       cc: ClusterConfig) -> Program:
    """Generate the analytical runtime plan for one train/serve step.

    All tensor shapes are GLOBAL; ``shard_axes`` on each Compute divides the
    work by the product of those axes' sizes, and each TensorStat's
    ``shards`` divides its per-device bytes — the same discipline the paper
    uses when normalizing MR task costs by the effective degree of
    parallelism.
    """
    mode = shape.mode
    micro0 = _kv(plan.microbatches) if shape.mode == "train" else 1
    mb0 = pmax(shape.global_batch // micro0, 1)
    dp = plan.eff_degree(cc, plan.batch_axes, mb0)
    tp = plan.degree(cc, plan.tp_axes)
    fsdp = plan.degree(cc, plan.fsdp_axes)
    ep = plan.degree(cc, plan.ep_axes)
    sp = plan.eff_degree(cc, plan.seq_axes,
                         1 if mode == "decode" else shape.seq_len)
    # Pipeline stages: the layer stack is partitioned into S bodies along
    # the pp axis (train only — the schedule needs a microbatch stream).
    pp_s = plan.degree(cc, plan.pp_axes) if mode == "train" else 1
    d, hd = arch.d_model, arch.head_dim_
    nh, nkv = max(arch.n_heads, 1), max(arch.n_kv_heads, 1)
    dt = arch.dtype
    bpe = dtype_bytes(dt)
    micro = _kv(plan.microbatches) if mode == "train" else 1

    batch = shape.global_batch
    q_len = 1 if mode == "decode" else shape.seq_len
    kv_len = shape.seq_len
    # The fusion plan knob.  "off" must emit EXACTLY the legacy tree (no
    # new attrs, no new instructions): the frozen pre-fusion baselines are
    # byte-identical on that path.  Otherwise every composite op names its
    # variant: attention carries fused=True/False, matmuls grow epilogue /
    # cast-sinking attrs ("full") or the materialized intermediates stay
    # separate instructions ("none", plus explicit casts).
    fus = plan.fusion
    attn_attrs = {} if fus == "off" else {"fused": fus == "full"}
    proj_epi = {"epilogue": "layernorm"} if fus == "full" else {}
    mb_batch = pmax(batch // micro, 1)         # global batch per microbatch
    tokens = mb_batch * q_len                  # global tokens per microbatch
    act_axes = plan.batch_axes + plan.seq_axes # divide token work
    mm_axes = act_axes + plan.tp_axes          # divide matmul work
    act_sh = dp * sp                           # shards of [tokens, d] acts
    head_sh = dp * sp * tp                     # shards of head-split acts
    weight_shards = max(tp * fsdp, 1)

    prog = Program(name=f"{arch.name}/{shape.name}/{plan.describe()}")
    pc = arch.param_counts()
    # Pipeline stages hold only their own layers' weights resident — the
    # per-device param bytes divide by S on top of the tp x fsdp sharding.
    prog.inputs["params"] = _ts((int(pc["total"]),), dt,
                                shards=weight_shards * pp_s)
    prog.inputs["batch_tokens"] = _ts((mb_batch, q_len), "int32",
                                      shards=act_sh, state=MemState.HOST)

    setup = GenericBlock("setup (persistent residents)")
    # Materialize the persistent HBM residents (optimizer state, activation
    # stash, KV cache, ...) as variables, so the costed walk's peak-HBM is
    # never below the estimate_hbm pre-filter that shares this formula.
    # Components the program materializes itself are not double-counted:
    # "params" is a program input (sharded by tp*fsdp, i.e. never below the
    # component, which ep-shards MoE experts too), and the logits-like
    # component is emitted only net of the logits variable the loss/lm-head
    # block creates at the very point the peak is taken.
    comps = dict(resident_components(arch, shape, plan, cc))
    logits_like = "ce_head" if mode == "train" else "logits"
    if logits_like in comps:
        logits_var = (tokens * arch.vocab_size
                      * (4 if mode == "train" else bpe) / pmax(head_sh, 1))
        comps[logits_like] = pmax(comps[logits_like] - logits_var, 0.0)
    for comp_name, comp_bytes in comps.items():
        # lane vectors must agree on which components materialize
        # (uniform_bool raises to the batched driver's scalar fallback)
        if comp_name == "params" or uniform_bool(comp_bytes < 1.0):
            continue
        setup.children.append(CreateVar(f"resident_{comp_name}",
                                        _ts((dim_ceil(comp_bytes),), "int8")))
    setup.children.append(CreateVar("embed_table",
                                    _ts((arch.vocab_size, d), dt, weight_shards)))
    prog.blocks.append(setup)

    # Batch staging + embedding run once per *microbatch* (the micro loop
    # wraps body_blocks below), so a step's total embedding work is the
    # full global batch no matter how it is microbatched — emitting them
    # once with per-microbatch tokens would under-charge ubatch>1 plans
    # (and break the within-role monotonicity the cluster floors rest on).
    stage = GenericBlock("stage batch + embed (per microbatch)")
    stage.children.append(IO("read", "batch_tokens",
                             src=MemState.HOST, dst=MemState.HBM))
    stage.children.append(Compute("embedding", ("batch_tokens", "embed_table"),
                                  "h", exec_type="DIST", shard_axes=act_axes))

    # ------------------------------------------------------------ sublayers
    def emit_attention(ops: List, prefix: str, reps: int) -> None:
        def emit(opcode, ins, out, axes, **attrs):
            for r in range(reps):
                ops.append(Compute(opcode, ins, f"{prefix}{out}_{r}",
                                   exec_type="DIST", shard_axes=axes,
                                   attrs=attrs))

        ops.append(CreateVar(f"{prefix}x2d", _ts((tokens, d), dt, act_sh)))
        if arch.mla is not None:
            m = arch.mla
            ops.append(CreateVar(f"{prefix}w_dq", _ts((d, m.q_lora_rank), dt, weight_shards)))
            emit("matmul", (f"{prefix}x2d", f"{prefix}w_dq"), "cq", act_axes)
            ops.append(CreateVar(f"{prefix}cq", _ts((tokens, m.q_lora_rank), dt, act_sh)))
            ops.append(CreateVar(f"{prefix}w_uq",
                                 _ts((m.q_lora_rank, nh * m.qk_head_dim), dt, weight_shards)))
            emit("matmul", (f"{prefix}cq", f"{prefix}w_uq"), "q", mm_axes)
            ops.append(CreateVar(f"{prefix}w_dkv", _ts((d, m.cache_dim), dt, weight_shards)))
            emit("matmul", (f"{prefix}x2d", f"{prefix}w_dkv"), "ckv", act_axes)
            if mode == "decode":
                # absorbed MLA: q heads attend over the shared latent cache
                # (MQA-like: 1 kv "head" of width cache_dim)
                ops.append(CreateVar(f"{prefix}q4", _ts((mb_batch, nh, q_len, m.cache_dim), dt, head_sh)))
                ops.append(CreateVar(f"{prefix}kc", _ts((mb_batch, 1, kv_len, m.cache_dim), dt, dp)))
                ops.append(CreateVar(f"{prefix}vc", _ts((mb_batch, 1, kv_len, m.kv_lora_rank), dt, dp)))
                emit("attention", (f"{prefix}q4", f"{prefix}kc", f"{prefix}vc"),
                     "attn", mm_axes, causal=False, **attn_attrs)
                v_dim = m.kv_lora_rank
            else:
                kv_tokens = mb_batch * kv_len
                ops.append(CreateVar(f"{prefix}ckv_all", _ts((kv_tokens, m.kv_lora_rank), dt, act_sh)))
                ops.append(CreateVar(f"{prefix}w_ukv",
                                     _ts((m.kv_lora_rank, nh * (m.qk_nope_head_dim + m.v_head_dim)),
                                         dt, weight_shards)))
                emit("matmul", (f"{prefix}ckv_all", f"{prefix}w_ukv"), "kv", mm_axes)
                ops.append(CreateVar(f"{prefix}q4", _ts((mb_batch, nh, q_len, m.qk_head_dim), dt, head_sh)))
                ops.append(CreateVar(f"{prefix}k4", _ts((mb_batch, nh, kv_len, m.qk_head_dim), dt, head_sh)))
                ops.append(CreateVar(f"{prefix}v4", _ts((mb_batch, nh, kv_len, m.v_head_dim), dt, head_sh)))
                emit("attention", (f"{prefix}q4", f"{prefix}k4", f"{prefix}v4"),
                     "attn", mm_axes, causal=True, **attn_attrs)
                v_dim = m.v_head_dim
            ops.append(CreateVar(f"{prefix}ao", _ts((tokens, nh * v_dim), dt, head_sh)))
            ops.append(CreateVar(f"{prefix}w_o", _ts((nh * v_dim, d), dt, weight_shards)))
            emit("matmul", (f"{prefix}ao", f"{prefix}w_o"), "proj", mm_axes,
                 **proj_epi)
        else:
            ops.append(CreateVar(f"{prefix}w_qkv",
                                 _ts((d, (nh + 2 * nkv) * hd), dt, weight_shards)))
            emit("matmul", (f"{prefix}x2d", f"{prefix}w_qkv"), "qkv", mm_axes)
            window = arch.layer_window(0, kv_len) if arch.window_pattern else None
            ops.append(CreateVar(f"{prefix}q4", _ts((mb_batch, nh, q_len, hd), dt, head_sh)))
            kv_sh = dp * min(tp, nkv) if tp > 1 else dp
            ops.append(CreateVar(f"{prefix}k4", _ts((mb_batch, nkv, kv_len, hd), dt, kv_sh)))
            ops.append(CreateVar(f"{prefix}v4", _ts((mb_batch, nkv, kv_len, hd), dt, kv_sh)))
            emit("attention", (f"{prefix}q4", f"{prefix}k4", f"{prefix}v4"),
                 "attn", mm_axes, causal=(mode != "decode"), window=window,
                 **attn_attrs)
            ops.append(CreateVar(f"{prefix}ao", _ts((tokens, nh * hd), dt, head_sh)))
            ops.append(CreateVar(f"{prefix}w_o", _ts((nh * hd, d), dt, weight_shards)))
            emit("matmul", (f"{prefix}ao", f"{prefix}w_o"), "proj", mm_axes,
                 **proj_epi)
        if tp > 1:
            # TP output reduction (Megatron g-op): payload = local act slice
            ops.append(Collective("all_reduce", f"{prefix}proj_0", plan.tp_axes,
                                  bytes_override=tokens * d * bpe / act_sh))
        if fus != "full":
            # materialized post-attention norm: its own HBM round trip
            # ("full" folded it into the proj matmul's epilogue above)
            ops.append(CreateVar(f"{prefix}hn", _ts((tokens, d), dt, act_sh)))
            for r in range(reps):
                ops.append(Compute("layernorm", (f"{prefix}hn",),
                                   f"{prefix}n_{r}", exec_type="DIST",
                                   shard_axes=act_axes))

    def emit_ffn(ops: List, prefix: str, reps: int) -> None:
        def emit(opcode, ins, out, axes, **attrs):
            for r in range(reps):
                ops.append(Compute(opcode, ins, f"{prefix}{out}_{r}",
                                   exec_type="DIST", shard_axes=axes,
                                   attrs=attrs))

        if f"{prefix}x2d" not in [c.name for c in ops if isinstance(c, CreateVar)]:
            ops.append(CreateVar(f"{prefix}x2d", _ts((tokens, d), dt, act_sh)))
        if arch.moe is not None:
            mcfg = arch.moe
            ops.append(CreateVar(f"{prefix}w_router", _ts((d, mcfg.n_experts), dt, 1)))
            emit("matmul", (f"{prefix}x2d", f"{prefix}w_router"), "route", act_axes)
            if ep > 1:
                a2a = tokens * d * bpe * mcfg.top_k / (act_sh * max(tp, 1))
                ops.append(Collective("all_to_all", f"{prefix}x2d", plan.ep_axes,
                                      bytes_override=a2a))
            ops.append(CreateVar(f"{prefix}w_up",
                                 _ts((mcfg.n_experts, d, mcfg.d_ff_expert), dt,
                                     max(ep * tp, 1) * max(fsdp, 1))))
            emit("moe_ffn", (f"{prefix}x2d", f"{prefix}w_up"), "moe",
                 act_axes + plan.ep_axes + plan.tp_axes,
                 top_k=mcfg.top_k, gated=arch.gated_mlp)
            if mcfg.n_shared_experts:
                ops.append(CreateVar(f"{prefix}w_sh",
                                     _ts((d, (3 if arch.gated_mlp else 2)
                                          * mcfg.n_shared_experts * mcfg.d_ff_expert),
                                         dt, weight_shards)))
                emit("matmul", (f"{prefix}x2d", f"{prefix}w_sh"), "shex", mm_axes)
            if ep > 1:
                a2a = tokens * d * bpe * mcfg.top_k / (act_sh * max(tp, 1))
                ops.append(Collective("all_to_all", f"{prefix}moe_0", plan.ep_axes,
                                      bytes_override=a2a))
        elif arch.d_ff:
            width = (3 if arch.gated_mlp else 2) * arch.d_ff
            act = "silu" if arch.gated_mlp else "gelu"
            ops.append(CreateVar(f"{prefix}w_ff", _ts((d, width), dt, weight_shards)))
            if fus == "full":
                # activation folded into the up-projection's flush — the
                # (tokens, d_ff) intermediate never round-trips HBM
                emit("matmul", (f"{prefix}x2d", f"{prefix}w_ff"), "ffn",
                     mm_axes, epilogue=act, epi_cols=arch.d_ff)
                ops.append(CreateVar(f"{prefix}ffh",
                                     _ts((tokens, arch.d_ff), dt, head_sh)))
            else:
                emit("matmul", (f"{prefix}x2d", f"{prefix}w_ff"), "ffn", mm_axes)
                ops.append(CreateVar(f"{prefix}ffh",
                                     _ts((tokens, arch.d_ff), dt, head_sh)))
                emit(act, (f"{prefix}ffh",), "act", mm_axes)
            ops.append(CreateVar(f"{prefix}w_down", _ts((arch.d_ff, d), dt, weight_shards)))
            emit("matmul", (f"{prefix}ffh", f"{prefix}w_down"), "ffo", mm_axes)
            if tp > 1:
                ops.append(Collective("all_reduce", f"{prefix}ffo_0", plan.tp_axes,
                                      bytes_override=tokens * d * bpe / act_sh))

    def emit_ssm(ops: List, prefix: str, reps: int) -> None:
        def emit(opcode, ins, out, axes, **attrs):
            for r in range(reps):
                ops.append(Compute(opcode, ins, f"{prefix}{out}_{r}",
                                   exec_type="DIST", shard_axes=axes,
                                   attrs=attrs))

        s = arch.ssm
        di = s.d_inner(d)
        ops.append(CreateVar(f"{prefix}x2d", _ts((tokens, d), dt, act_sh)))
        ops.append(CreateVar(f"{prefix}w_in",
                             _ts((d, 2 * di + 2 * s.n_groups * s.state_size
                                  + s.n_heads(d)), dt, weight_shards)))
        emit("matmul", (f"{prefix}x2d", f"{prefix}w_in"), "xin", mm_axes)
        ops.append(CreateVar(f"{prefix}x4",
                             _ts((mb_batch, q_len, s.n_heads(d), s.head_dim), dt, head_sh)))
        # decode: single-step state update (memory bound), else chunked scan
        chunk = 1 if mode == "decode" else s.chunk_size
        emit("ssd_scan", (f"{prefix}x4",), "ssd", mm_axes,
             state=s.state_size, chunk=chunk)
        ops.append(CreateVar(f"{prefix}xdi", _ts((tokens, di), dt, head_sh)))
        ops.append(CreateVar(f"{prefix}w_out", _ts((di, d), dt, weight_shards)))
        emit("matmul", (f"{prefix}xdi", f"{prefix}w_out"), "out", mm_axes)
        if tp > 1:
            ops.append(Collective("all_reduce", f"{prefix}out_0", plan.tp_axes,
                                  bytes_override=tokens * d * bpe / act_sh))

    def layer_body(prefix: str, backward: bool, kind: str) -> List:
        """kind: 'attn+ffn' | 'ssm' | 'attn-shared'."""
        ops: List = []
        reps = 2 if backward else 1           # dgrad + wgrad ~= 2x fwd
        if kind == "ssm":
            emit_ssm(ops, prefix, reps)
        else:
            emit_attention(ops, prefix, reps)
            emit_ffn(ops, prefix, reps)
        if fsdp > 1:
            # gathered params are reused across microbatches (prefetch +
            # persist for the step), so amortize the payload by micro
            per_layer = (pc["layers"] / arch.n_layers * bpe / weight_shards
                         / pmax(micro, 1))
            ops.insert(0, Collective("all_gather", "params", plan.fsdp_axes,
                                     bytes_override=per_layer))
            if backward:
                ops.append(Collective("reduce_scatter", "params", plan.fsdp_axes,
                                      bytes_override=per_layer * fsdp))
        return ops

    main_kind = "ssm" if arch.family in ("ssm", "hybrid") else "attn+ffn"
    body_blocks: List = [stage]
    fwd = ForBlock(f"fwd layers x{arch.n_layers}", arch.n_layers,
                   body=layer_body("L_", False, main_kind))
    body_blocks.append(fwd)
    shared_fwd = None
    if arch.hybrid is not None:
        n_app = arch.n_layers // arch.hybrid.attn_every
        shared_fwd = ForBlock(f"shared attn blocks x{n_app}", n_app,
                              body=layer_body("A_", False, "attn-shared"))
        body_blocks.append(shared_fwd)
    enc_block = None
    if arch.enc_dec is not None:
        # encoder runs once per step over frontend_seq frames
        enc_tokens = mb_batch * arch.enc_dec.encoder_seq
        enc_block = ForBlock(
            f"encoder layers x{arch.enc_dec.n_encoder_layers}",
            arch.enc_dec.n_encoder_layers,
            body=[Compute("matmul", ("enc_x", "enc_w"), f"enc_{i}",
                          exec_type="DIST", shard_axes=mm_axes)
                  for i in range(2)])
        body_blocks.append(enc_block)
        prog.inputs["enc_x"] = _ts((enc_tokens, d), dt, act_sh)
        prog.inputs["enc_w"] = _ts((d, 4 * d + (3 if arch.gated_mlp else 2) * arch.d_ff),
                                   dt, weight_shards)

    if mode == "train":
        recompute = {"none": 0.0, "selective": 0.35, "full": 1.0}[plan.remat]
        # Per-microbatch loss: like staging/embedding, the loss head runs
        # once per microbatch, so its work scales with the full batch.
        loss = GenericBlock("loss (per microbatch)")
        loss.children.append(CreateVar("logits",
                                       _ts((tokens, arch.vocab_size), "float32", head_sh)))
        loss.children.append(Compute("cross_entropy", ("logits",), "loss",
                                     exec_type="DIST", shard_axes=mm_axes))
        body_blocks.append(loss)
        bwd_body = layer_body("B_", True, main_kind)
        if recompute > 0:
            extra = layer_body("R_", False, main_kind)
            bwd_body = extra[: int(len(extra) * recompute)] + bwd_body
        body_blocks.append(ForBlock(f"bwd layers x{arch.n_layers}",
                                    arch.n_layers, body=bwd_body))
        if arch.hybrid is not None:
            n_app = arch.n_layers // arch.hybrid.attn_every
            body_blocks.append(ForBlock(f"bwd shared attn x{n_app}", n_app,
                                        body=layer_body("AB_", True, "attn-shared")))

        tail = GenericBlock("grad reduce + update")
        grad_bytes = (pc["total"] * _gd_bytes(plan.grad_reduce_dtype)
                      / (weight_shards * pp_s))
        if arch.moe is not None and ep > 1:
            grad_bytes /= ep
        reduce_axes = tuple(a for a in plan.batch_axes if a not in plan.fsdp_axes)
        if fus == "none" and plan.degree(cc, reduce_axes) > 1:
            # Materialized grad-dtype cast: the fp32 accumulator (global
            # param count, addressed through the params variable) is read
            # and re-written at wire width before the reduce.  "full"
            # sinks this into the producing wgrad writes (no instruction,
            # no traffic — the fused matmul's sink_cast_bytes semantics);
            # "off" is the legacy tree, which never priced the cast.
            tail.children.append(Compute(
                "cast", ("params",), "grad_wire", exec_type="DIST",
                shard_axes=plan.fsdp_axes + plan.tp_axes + plan.pp_axes,
                attrs={"from_bytes": 4,
                       "to_bytes": _gd_bytes(plan.grad_reduce_dtype)}))
        if plan.degree(cc, reduce_axes) > 1 and fsdp == 1:
            tail.children.append(Collective("all_reduce", "params", reduce_axes,
                                            bytes_override=grad_bytes))
        elif fsdp > 1 and plan.degree(cc, reduce_axes) > 1:
            tail.children.append(Collective("reduce_scatter", "params", reduce_axes,
                                            bytes_override=grad_bytes))
        upd_shards = weight_shards * (dp if fsdp > 1 else 1)
        tail.children.append(Compute("adamw_update", ("params",), "params2",
                                     exec_type="DIST",
                                     shard_axes=plan.fsdp_axes + plan.tp_axes
                                     + plan.pp_axes + plan.batch_axes))
        if pp_s > 1:
            prog.blocks.append(_pipelined_stages(
                arch, plan, pp_s, micro, stage, loss, enc_block, shared_fwd,
                layer_body, main_kind, recompute,
                act_payload=tokens * d * bpe / act_sh))
        elif uniform_bool(micro > 1):
            prog.blocks.append(ForBlock(f"microbatches x{micro}", micro,
                                        body=body_blocks))
        else:
            prog.blocks.extend(body_blocks)
        prog.blocks.append(tail)
    else:
        prog.blocks.extend(body_blocks)
        head = GenericBlock("lm head")
        head.children.append(CreateVar("hout", _ts((tokens, d), dt, act_sh)))
        head.children.append(CreateVar("w_head", _ts((d, arch.vocab_size), dt, weight_shards)))
        # Serving logits leave the head in fp32 (sampling runs there — the
        # resident "logits" component is 4 B/cell).  "full" sinks the cast
        # into the matmul's output write; "none" materializes it as its
        # own round trip; "off" keeps the legacy tree, which never priced
        # the upcast at all.
        head_attrs = {"sink_cast_bytes": 4} if fus == "full" else {}
        head.children.append(Compute("matmul", ("hout", "w_head"), "logits",
                                     exec_type="DIST", shard_axes=mm_axes,
                                     attrs=head_attrs))
        if fus == "none":
            head.children.append(Compute("cast", ("logits",), "logits32",
                                         exec_type="DIST", shard_axes=mm_axes,
                                         attrs={"to_bytes": 4}))
        if tp > 1:
            head.children.append(Collective("all_gather", "logits", plan.tp_axes,
                                            bytes_override=tokens * arch.vocab_size
                                            * bpe / (act_sh * tp)))
        prog.blocks.append(head)
    return prog


def _pipelined_stages(arch: ArchConfig, plan: ShardingPlan, pp_s: int,
                      micro: int, stage: GenericBlock, loss: GenericBlock,
                      enc_block, shared_fwd, layer_body, main_kind: str,
                      recompute: float, act_payload: float
                      ) -> PipelinedLoopBlock:
    """Partition the train step's layer stack into S pipeline-stage bodies.

    Stage 0 owns batch staging + embedding (and the encoder, when one
    exists); the last stage owns the loss head (and any shared-attention
    blocks).  Every stage runs ``n_layers / S`` of the per-layer fwd + bwd
    work (remainder layers land on the earliest stages) and hands its
    boundary activations to the next stage — and, on the backward path,
    the activation gradients to the previous stage — as :class:`P2P`
    transfers over one link of the pp axis.  Identical interior stages
    share one structural signature, so the sub-plan cache costs them once.
    """
    pp_axis = plan.pp_axes[0]
    base_l, rem = divmod(arch.n_layers, pp_s)
    stages: List[List] = []
    for si in range(pp_s):
        layers_s = base_l + (1 if si < rem else 0)
        body: List = []
        if si == 0:
            body.append(stage)
            if enc_block is not None:
                body.append(enc_block)
        body.append(ForBlock(f"fwd layers x{layers_s}", layers_s,
                             body=layer_body("L_", False, main_kind)))
        if si < pp_s - 1:
            body.append(P2P("pp_fwd_act", pp_axis,
                            bytes_override=act_payload))
        else:
            if shared_fwd is not None:
                body.append(shared_fwd)
            body.append(loss)
        bwd_body = layer_body("B_", True, main_kind)
        if recompute > 0:
            extra = layer_body("R_", False, main_kind)
            bwd_body = extra[: int(len(extra) * recompute)] + bwd_body
        if si == pp_s - 1 and shared_fwd is not None:
            n_app = arch.n_layers // arch.hybrid.attn_every
            body.append(ForBlock(f"bwd shared attn x{n_app}", n_app,
                                 body=layer_body("AB_", True, "attn-shared")))
        body.append(ForBlock(f"bwd layers x{layers_s}", layers_s,
                             body=bwd_body))
        if si > 0:
            body.append(P2P("pp_bwd_grad", pp_axis,
                            bytes_override=act_payload))
        stages.append(body)
    return PipelinedLoopBlock(f"ubatch x{micro} over {pp_s} stages", micro,
                              stages)


# ---------------------------------------------------------------------------
# Memory estimate (white-box HBM budget check, pre-compile)
# ---------------------------------------------------------------------------


def resident_components(arch: ArchConfig, shape: ShapeConfig,
                        plan: ShardingPlan, cc: ClusterConfig
                        ) -> Dict[str, float]:
    """Persistent per-device HBM residents (bytes) for one step, by name.

    This is the single source of truth for the HBM-feasibility pre-filter
    (:func:`estimate_hbm` sums it) AND for the generated plan itself:
    :func:`build_step_program` materializes every non-params component as a
    resident variable, so the cost walk's ``peak_hbm_per_device`` is always
    at least ``estimate_hbm`` — the pre-filter can never reject a plan whose
    costed peak-HBM excursion fits (asserted by tests/test_planner.py).
    """
    pc = arch.param_counts()
    mb0 = pmax(shape.global_batch
               // (_kv(plan.microbatches) if shape.mode == "train" else 1), 1)
    dp = plan.eff_degree(cc, plan.batch_axes, mb0)
    tp = plan.degree(cc, plan.tp_axes)
    fsdp = plan.degree(cc, plan.fsdp_axes)
    ep = plan.degree(cc, plan.ep_axes)
    sp = plan.eff_degree(cc, plan.seq_axes,
                         1 if shape.mode == "decode" else shape.seq_len)
    # Pipeline stages are resident-state shards: a stage holds only its
    # own n_layers/S slice of weights, gradients and optimizer state —
    # the ~S-fold HBM drop that opens cells where no 2D role fits.
    pp = plan.degree(cc, plan.pp_axes) if shape.mode == "train" else 1
    bpe = dtype_bytes(arch.dtype)
    wsh = max(tp * fsdp * (ep if arch.moe else 1), 1)
    comp: Dict[str, float] = {"params": pc["total"] * bpe / (wsh * pp)}
    if shape.mode == "train":
        # adam m,v (fp32) + fp32 transients during the update, sharded like
        # params (+dp if fsdp); calibrated against compiled memory_analysis
        opt_shards = wsh * (dp if (fsdp > 1 or plan.zero1) else 1)
        comp["opt_state"] = 4 * pc["total"] * 4 / (pmax(opt_shards, wsh) * pp)
        # gradients: resident fp32 accumulator regardless of microbatching
        # (grad_reduce_dtype only changes the wire payload, not the buffer;
        # calibrated against compiled memory_analysis)
        comp["grads"] = pc["total"] * 4 / (wsh * pp)
        # activations saved for backward, per token per layer:
        #   replicated residual-stream parts (~d) + head/ff-sharded parts
        d = arch.d_model
        hd_total = max(arch.n_heads, 1) * arch.head_dim_
        if arch.moe is not None:
            ff_eff = arch.moe.top_k * arch.moe.d_ff_expert \
                + arch.moe.n_shared_experts * arch.moe.d_ff_expert
        elif arch.family in ("ssm", "hybrid"):
            ff_eff = arch.ssm.expand * d
        else:
            ff_eff = arch.d_ff
        fac = {"none": (5.0, 3.0), "selective": (2.0, 1.0),
               "full": (2.0, 0.0)}[plan.remat]
        per_tok = (fac[0] * d * bpe
                   + fac[1] * (hd_total + ff_eff) * bpe / max(tp, 1))
        tokens_dev = shape.tokens / pmax(dp * sp * _kv(plan.microbatches), 1)
        if pp > 1:
            # 1F1B-style schedule memory: a stage stashes activations for
            # its own n_layers/S layers, but keeps min(M, S) microbatches
            # in flight — for M >= S that is exactly the sequential
            # microbatched stash (the stage's S-fold layer cut times the
            # S in-flight microbatches cancel); weights/optimizer state
            # above still drop S-fold.
            comp["act_stash"] = (tokens_dev * (arch.n_layers / pp) * per_tok
                                 * pmin(_kv(plan.microbatches), pp))
        else:
            comp["act_stash"] = tokens_dev * arch.n_layers * per_tok
        # chunked-CE head: [ce_chunk, vocab] fp32 (+bwd copy), tp-sharded
        comp["ce_head"] = 2 * 2048 * arch.vocab_size * 4 / max(tp, 1)
    else:
        tokens_dev = shape.tokens / max(dp * sp, 1)
        if shape.mode == "decode":
            # KV cache dominates
            def kv_at(kv_len: float) -> float:
                """Per-layer cache residents at context ``kv_len`` (the SSM
                state is sequence-independent; hybrids scale only the
                attention share)."""
                if arch.mla:
                    return shape.global_batch / dp * kv_len * arch.mla.cache_dim
                if arch.family == "ssm":
                    s = arch.ssm
                    return (shape.global_batch / dp * s.n_heads(arch.d_model)
                            * s.head_dim * s.state_size)
                if arch.family == "hybrid":
                    s = arch.ssm
                    ssm_state = (shape.global_batch / dp
                                 * s.n_heads(arch.d_model) * s.head_dim
                                 * s.state_size)
                    n_attn = arch.n_layers // arch.hybrid.attn_every
                    kv = (shape.global_batch / dp * kv_len
                          * 2 * arch.n_kv_heads * arch.head_dim_
                          / max(tp, 1)) * n_attn / arch.n_layers
                    return ssm_state + kv
                kv_len_eff = kv_len
                if arch.window_pattern:
                    # local layers cache only the window
                    n_pat = len(arch.window_pattern)
                    w_sum = sum(min(w, kv_len) if w else kv_len
                                for w in arch.window_pattern) / n_pat
                    kv_len_eff = w_sum
                return (shape.global_batch / dp * kv_len_eff
                        * 2 * arch.n_kv_heads * arch.head_dim_ / max(tp, 1))

            cache = kv_at(shape.seq_len)
            comp["kv_cache"] = cache * arch.n_layers * bpe
            # Paged-KV allocator pressure (serving decode shapes only): each
            # slot reserves whole pages out to its p99 context, so the pool
            # must keep the page-rounded tail resident, not the mean.  Plain
            # decode shapes carry neither field and the term vanishes (and a
            # zero-byte component emits no resident variable — bit-exact).
            page = getattr(shape, "kv_page_tokens", 0)
            max_ctx = getattr(shape, "max_context", 0)
            if page and max_ctx:
                paged_len = math.ceil(max(max_ctx, shape.seq_len)
                                      / page) * page
                comp["kv_paging"] = (max(kv_at(paged_len) - cache, 0.0)
                                     * arch.n_layers * bpe)
            live_tokens = shape.global_batch / max(dp, 1)   # one token/seq
            comp["live_acts"] = live_tokens * arch.d_model * bpe * 4
            comp["logits"] = live_tokens * arch.vocab_size * 4 / max(tp, 1)
        else:
            comp["act_workspace"] = tokens_dev * arch.d_model * bpe * 8 / max(tp, 1)
    return comp


def estimate_hbm(arch: ArchConfig, shape: ShapeConfig, plan: ShardingPlan,
                 cc: ClusterConfig) -> float:
    """Per-device resident HBM (bytes): the feasibility pre-filter's bound."""
    return sum(resident_components(arch, shape, plan, cc).values())


# ---------------------------------------------------------------------------
# Enumeration + selection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanDecision:
    plan: ShardingPlan
    cost: CostedProgram
    hbm_est: float
    feasible: bool

    @property
    def time(self) -> float:
        return self.cost.total


@dataclasses.dataclass
class SearchStats:
    """Observability for one plan search: how many candidates were actually
    costed vs. pruned, and how well the sub-plan cache worked."""

    costed: int = 0
    pruned_infeasible: int = 0   # skipped: cannot fit HBM even when frugal
    pruned_dominated: int = 0    # skipped: a strictly better sibling exists
    cache: Optional[CacheStats] = None

    def describe(self) -> str:
        bits = [f"costed={self.costed}",
                f"pruned_oom={self.pruned_infeasible}",
                f"pruned_dom={self.pruned_dominated}"]
        if self.cache is not None:
            bits.append(f"cache_hits={self.cache.hits}/"
                        f"{self.cache.hits + self.cache.misses}")
        return " ".join(bits)


def _knob_space(shape: ShapeConfig) -> Tuple[List[str], List[int], List[str]]:
    """The non-role decision knobs: remat x microbatches x grad dtype.
    For pipelined roles the microbatch knob doubles as the schedule's M."""
    if shape.mode == "train":
        return (["none", "selective", "full"], list(MICRO_OPTS),
                ["float32", "bfloat16"])
    return (["none"], [1], ["float32"])


def _model_roles(arch: ArchConfig, shape: ShapeConfig,
                 cc: ClusterConfig) -> List[Dict]:
    """Role assignments for the non-batch mesh axes (search stage 1).

    On a 2D (+pod) mesh the single "model" axis carries one role.  On a 3D
    torus mesh ("data", "model", "depth") the two non-batch axes are
    assigned jointly: both tensor-parallel, tp on one with extra data /
    FSDP / expert / sequence parallelism on the other, or both folded into
    data-parallel replicas — every enumerated plan still belongs to
    exactly one role class, which is what keeps the resource optimizer's
    per-role cluster floors sound on the enlarged space.
    """
    axes = cc.mesh_axes
    has_model = "model" in axes
    has_depth = "depth" in axes

    def pp_ok(axis: str) -> bool:
        # A pipeline role needs a microbatch stream (train), at least two
        # stage positions on the axis, and enough layers to partition.
        s = cc.axis_size(axis)
        return shape.mode == "train" and s >= 2 and arch.n_layers >= s

    if has_depth:
        roles: List[Dict] = [
            dict(name="dp+tp2", tp=("model", "depth")),
            dict(name="dp+tp", tp=("model",), batch_extra=("depth",)),
            dict(name="tp+fsdp", tp=("model",), fsdp=("depth",)),
            dict(name="fsdp2", fsdp=("model", "depth")),
            dict(name="dp-pure", batch_extra=("model", "depth")),
        ]
        if arch.moe is not None:
            roles.append(dict(name="dp+ep+tp", ep=("depth",), tp=("model",)))
            roles.append(dict(name="dp+ep", ep=("model", "depth")))
        if shape.mode == "prefill":
            roles.append(dict(name="tp+seq", tp=("model",), seq=("depth",)))
        if pp_ok("depth"):
            roles.append(dict(name="pp+tp", pp=("depth",), tp=("model",)))
            roles.append(dict(name="dp+pp", pp=("depth",),
                              batch_extra=("model",)))
        if "pod" in axes and pp_ok("pod"):
            # pipeline-over-DCN across slices, 3D torus inside each stage
            roles.append(dict(name="pp-dcn+tp2", pp=("pod",),
                              tp=("model", "depth")))
        return roles
    roles = [dict(name="dp+tp", tp=("model",))]
    roles.append(dict(name="fsdp", fsdp=("model",)))
    roles.append(dict(name="dp-pure", batch_extra=("model",)))
    if arch.moe is not None and has_model:
        roles.append(dict(name="dp+ep", ep=("model",)))
        roles.append(dict(name="dp+ep+tp", ep=("model",), tp=("model",)))
    if shape.mode == "prefill":
        roles.append(dict(name="dp+seq", seq=("model",)))
    if "pod" in axes and pp_ok("pod"):
        # the headline family: pipeline-over-DCN across slices.  Stage
        # boundaries pay one p2p activation hop per microbatch instead of
        # the ring collective a pod-wide gradient reduce would phase over
        # DCN, and per-stage resident state drops S-fold.
        roles.append(dict(name="pp-dcn+tp", pp=("pod",), tp=("model",)))
        if has_model:
            roles.append(dict(name="pp-dcn+fsdp", pp=("pod",),
                              fsdp=("model",)))
    if not has_model:
        roles = [r for r in roles if r["name"] == "dp+tp"]
    return roles


def _batch_base(cc: ClusterConfig) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in cc.mesh_axes)


def _role_plan(role: Dict, cc: ClusterConfig, remat: str, micro: int,
               gd: str, fus: str = "off") -> ShardingPlan:
    has_model = "model" in cc.mesh_axes
    pp = tuple(role.get("pp", ()))
    return ShardingPlan(
        name=role["name"],
        # a pipeline axis carries stages, never batch — strip it from the
        # default (pod, data) batch base
        batch_axes=tuple(a for a in _batch_base(cc) + role.get("batch_extra", ())
                         if a not in pp),
        tp_axes=role.get("tp", ()) if has_model else (),
        fsdp_axes=role.get("fsdp", ()),
        ep_axes=role.get("ep", ()),
        seq_axes=role.get("seq", ()),
        pp_axes=pp,
        remat=remat, microbatches=micro, grad_reduce_dtype=gd, fusion=fus)


def _micro_valid(role: Dict, shape: ShapeConfig, cc: ClusterConfig,
                 micro: int) -> bool:
    if micro == 1:
        return True
    pp = role.get("pp", ())
    base = tuple(a for a in _batch_base(cc) + role.get("batch_extra", ())
                 if a not in pp)
    return shape.global_batch // (_deg(cc, base) * micro) >= 1


def _role_base_micro(role: Dict, shape: ShapeConfig, cc: ClusterConfig,
                     micro_opts: Sequence[int]) -> int:
    """The microbatch count a role's stage-1 beam representative is costed
    with.  Non-pipelined roles use 1 (the minimum-work knob); a pipelined
    role's natural operating point is the *largest* valid M — at M=1 its
    stages run back-to-back with zero overlap, which would unfairly sink
    an eventually-winning pipeline in the role beam."""
    if not role.get("pp"):
        return 1
    return max((m for m in micro_opts
                if _micro_valid(role, shape, cc, m)), default=1)


def enumerate_plans(arch: ArchConfig, shape: ShapeConfig,
                    cc: ClusterConfig,
                    fusion: str = "off") -> List[ShardingPlan]:
    """The full candidate sharding-plan space for the fixed mesh of ``cc``.

    ``fusion="search"`` widens the space by the fusion knob
    (:data:`FUSION_OPTS`); the default pins ``"off"``, keeping every
    pre-fusion candidate set (and its golden winners) unchanged."""
    remats, micro_opts, gdtypes = _knob_space(shape)
    fus_opts = _fusion_space(fusion)
    plans: List[ShardingPlan] = []
    for role in _model_roles(arch, shape, cc):
        for remat, micro, gd, fus in itertools.product(
                remats, micro_opts, gdtypes, fus_opts):
            if not _micro_valid(role, shape, cc, micro):
                continue
            plans.append(_role_plan(role, cc, remat, micro, gd, fus))
    # dedupe
    seen, out = set(), []
    for p in plans:
        key = dataclasses.astuple(p)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def _deg(cc: ClusterConfig, axes: Tuple[str, ...]) -> int:
    d = 1
    for a in axes:
        d *= cc.axis_size(a)
    return d


def reference_plans(arch: ArchConfig, shape: ShapeConfig,
                    cc: ClusterConfig,
                    fusion: str = "off") -> List[ShardingPlan]:
    """One minimum-work representative per axis-role class of
    :func:`enumerate_plans` — the basis of the resource optimizer's sound
    cluster floors (:func:`repro_torch.core.resource.cluster_floor_time`).

    Every enumerated plan belongs to exactly one role (its mesh-axis
    assignment); within a role the knobs can only *add* charged work
    relative to this representative:

      * ``remat`` heavier than ``none`` re-emits forward ops (and, under
        FSDP, their gathers) into the backward pass;
      * ``microbatches > 1`` keeps global work and total collective volume
        the same at best, and inflates both when the smaller per-microbatch
        batch stops dividing the data axes (``eff_degree`` collapses to
        replication);
      * the widest ``grad_reduce_dtype`` payload is avoided by picking the
        narrowest enumerated dtype here.

    So the representative's charged per-device totals (flops, HBM bytes,
    collective wire volume — :class:`repro_torch.core.costmodel.ProgramTotals`)
    lower-bound every plan in its role, and a minimum over roles
    lower-bounds the whole plan space.

    Pipelined roles keep micro=1 here too: the pipelined loop's *work*
    totals are microbatch-invariant (M transfers of payload/M, M loss
    heads over batch/M, ...), so M=1 stays the minimum-work member — but
    its *time* overlaps across stages, so the floor must not price the
    totals as one sequential roofline.  ``cluster_floor_time`` handles
    that with the pipeline-aware ``roofline / S * (1 + (S-1)/M)`` bound.

    **Fusion.**  With ``fusion="search"`` the knob breaks the "only adds
    work" monotonicity in one direction: ``fusion="full"`` *removes* HBM
    traffic relative to ``"off"``, so the off representative alone would
    not lower-bound fused members.  The fix is a second representative
    per role at ``fusion="full"`` — the traffic-minimal setting — and the
    floor consumer (``resource.role_floor_times``) takes the min over a
    role's representatives.  ``"none"`` only ever adds traffic on top of
    ``"off"`` (materialized intermediates, explicit casts), so the off
    rep covers it.
    """
    remats, _, gdtypes = _knob_space(shape)
    gd_min = min(gdtypes, key=dtype_bytes)
    fus_reps = ["off"]
    if "full" in _fusion_space(fusion):
        fus_reps.append("full")
    return [_role_plan(role, cc, remats[0], 1, gd_min, fus)
            for role in _model_roles(arch, shape, cc)
            for fus in fus_reps]


def _cost_candidate(arch: ArchConfig, shape: ShapeConfig, p: ShardingPlan,
                    cc: ClusterConfig, cache: Optional[PlanCostCache],
                    stats: SearchStats) -> PlanDecision:
    cc_p = cc.with_overlap(OVERLAP_FRACTION if p.overlap else 0.0)
    prog = build_step_program(arch, shape, p, cc_p)
    costed = estimate(prog, cc_p, cache=cache)
    hbm = estimate_hbm(arch, shape, p, cc_p)
    stats.costed += 1
    return PlanDecision(p, costed, hbm, hbm <= cc.hbm_budget)


def _rank_key(d: PlanDecision) -> Tuple:
    return (not d.feasible, d.time)


# ---------------------------------------------------------------------------
# Batched costing: one walk per structure signature
# ---------------------------------------------------------------------------


def _structure_key(plan: ShardingPlan, mode: str) -> Tuple:
    """The program-tree identity of a candidate: every ShardingPlan field
    that changes which nodes :func:`build_step_program` emits (axis roles,
    remat re-emission, micro>1's loop wrap, the pipelined/sequential split,
    overlap/zero1).  Candidates sharing a key differ only in the *values*
    of (microbatches, grad_reduce_dtype) — the same tree with different
    numbers — so one lane-vector walk costs them all.  The micro>1 flag is
    part of the key because it IS structure: the microbatch ForBlock (and
    the warm-branch shape of every loop walker) exists only on one side.
    ``fusion`` is structure too: each setting emits a different tree
    (separate-vs-folded epilogue ops, explicit casts, fused attrs)."""
    micro = plan.microbatches if mode == "train" else 1
    return (plan.name, plan.batch_axes, plan.tp_axes, plan.fsdp_axes,
            plan.ep_axes, plan.seq_axes, plan.pp_axes, plan.remat,
            plan.overlap, plan.zero1, micro > 1, plan.fusion)


def _cost_group_vectorized(arch: ArchConfig, shape: ShapeConfig,
                           members: Sequence[ShardingPlan],
                           cc: ClusterConfig) -> List[CostedProgram]:
    """Cost one structure group with a single lane-vector tree walk.

    The group's representative program is built once with
    :class:`VecKnob`-wrapped knob fields — lane ``j`` carries member
    ``j``'s (microbatches, grad-dtype bytes) — and costed with
    ``cache=None`` (lane vectors have no hashable read-set signatures; the
    vectorized walk IS the fast path, it does not also memoize).  Lane
    extraction then yields each member's scalar-walk numbers bit-exact
    (tests/test_properties.py asserts every field)."""
    base = members[0]
    micros = np.array([p.microbatches for p in members], dtype=np.int64)
    gdb = np.array([dtype_bytes(p.grad_reduce_dtype) for p in members],
                   dtype=np.int64)
    vec_plan = dataclasses.replace(
        base,
        microbatches=VecKnob(micros, "ubatch"),
        grad_reduce_dtype=VecKnob(gdb, "gdB"))
    cc_p = cc.with_overlap(OVERLAP_FRACTION if base.overlap else 0.0)
    prog = build_step_program(arch, shape, vec_plan, cc_p)
    costed = estimate(prog, cc_p, cache=None, terse_labels=True)
    return split_costed_lanes(costed, len(members))


def cost_candidates_batched(arch: ArchConfig, shape: ShapeConfig,
                            plans: Sequence[ShardingPlan], cc: ClusterConfig,
                            cache: Optional[PlanCostCache] = None,
                            stats: Optional[SearchStats] = None
                            ) -> List[PlanDecision]:
    """Cost ``plans`` with one tree walk per structure signature.

    Candidates are grouped by :func:`_structure_key`; each K>1 group is
    costed by one vectorized walk (:func:`_cost_group_vectorized`),
    singleton groups by the ordinary scalar walk (which still shares the
    sub-plan ``cache``).  Any group the vectorized walk cannot hold
    uniform (:class:`repro_torch.core.npvec.HeterogeneousLanes`, or an
    array-blind code path) falls back to scalar costing member by member —
    the engine is exact by construction, never by hope.  Results come back
    in input order."""
    if stats is None:
        stats = SearchStats()
    groups: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(plans):
        groups.setdefault(_structure_key(p, shape.mode), []).append(i)
    out: List[Optional[PlanDecision]] = [None] * len(plans)
    for idxs in groups.values():
        members = [plans[i] for i in idxs]
        costed = None
        if len(idxs) > 1:
            try:
                costed = _cost_group_vectorized(arch, shape, members, cc)
            except (HeterogeneousLanes, TypeError, ValueError):
                costed = None
        if costed is None:
            for i, p in zip(idxs, members):
                out[i] = _cost_candidate(arch, shape, p, cc, cache, stats)
            continue
        stats.costed += len(idxs)
        cc_p = cc.with_overlap(OVERLAP_FRACTION if members[0].overlap
                               else 0.0)
        for i, p, cp in zip(idxs, members, costed):
            hbm = estimate_hbm(arch, shape, p, cc_p)
            out[i] = PlanDecision(p, cp, hbm, hbm <= cc.hbm_budget)
    return out


class IncrementalCoster:
    """Incremental re-costing for single-knob plan mutations.

    Wraps one (arch, shape, cc) context around a shared
    :class:`PlanCostCache`: the first :meth:`cost` pays the full walk and
    populates the cache; a :meth:`recost` after mutating one knob re-walks
    only the dirty subtree — every block whose structural signature and
    read-set fingerprint survive the mutation replays from cache (e.g. a
    ``grad_reduce_dtype`` flip misses only the grad-reduce tail; a remat
    change misses the backward bodies but keeps the forward stack).  The
    result is the from-scratch answer bit-exact — the cache key semantics
    guarantee it, and tests/test_incremental.py asserts it per knob —
    ``marginal`` just reports how little was recomputed."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 cc: ClusterConfig,
                 cache: Optional[PlanCostCache] = None):
        self.arch = arch
        self.shape = shape
        self.cc = cc
        self.cache = cache if cache is not None else PlanCostCache()
        self.stats = SearchStats()
        self.marginal: Optional[CacheStats] = None

    def cost(self, plan: ShardingPlan,
             shape: Optional[ShapeConfig] = None) -> PlanDecision:
        """Cost ``plan`` (optionally under a shape override, e.g. a
        re-slotted decode shape) through the shared cache, recording the
        walk's *marginal* hits/misses in :attr:`marginal`."""
        h0, m0 = self.cache.hits, self.cache.misses
        d = _cost_candidate(self.arch, shape or self.shape, plan,
                            self.cc, self.cache, self.stats)
        self.marginal = CacheStats(self.cache.hits - h0,
                                   self.cache.misses - m0,
                                   self.cache.entries)
        return d

    def recost(self, base_plan: ShardingPlan,
               shape: Optional[ShapeConfig] = None,
               **mutation) -> PlanDecision:
        """Re-cost ``base_plan`` with the given knob fields replaced
        (``remat=...``, ``microbatches=...``, ``grad_reduce_dtype=...``)."""
        return self.cost(dataclasses.replace(base_plan, **mutation)
                         if mutation else base_plan, shape=shape)


def choose_plan(arch: ArchConfig, shape: ShapeConfig, cc: ClusterConfig,
                top_k: int = 5,
                candidates: Optional[Sequence[ShardingPlan]] = None,
                search: str = "beam", beam_width: int = 4,
                cache: Optional[PlanCostCache] = None,
                stats: Optional[SearchStats] = None,
                fusion: str = "off") -> List[PlanDecision]:
    """Pick the best sharding plans by ``C(P, cc)``; infeasible (OOM) sink.

    ``search="beam"`` (default) runs the staged beam search over the
    decision vector — axis roles, then remat/microbatch, then grad-dtype/
    overlap — pruning HBM-infeasible and dominated prefixes without costing
    them.  ``search="exhaustive"`` costs every enumerated candidate (the
    seed behavior; also used whenever an explicit ``candidates`` list is
    given with the default search).  ``search="batched"`` covers the SAME
    exhaustive space through the vectorized engine — one tree walk per
    structure signature (:func:`cost_candidates_batched`), streaming the
    structure groups through a role-floor dominance pool that, at
    ``top_k=1``, skips whole groups whose sound per-role floor already
    loses to the incumbent (the winner is provably unaffected; wider
    ``top_k`` disables the pruning so the full ranking stays exhaustive).
    Pass a shared :class:`PlanCostCache` to reuse sub-plan costs
    across calls (scenario sweeps); by default each call gets a private
    cache, which already dedupes the per-layer loop bodies shared between
    candidates.

    ``fusion="search"`` widens every strategy's space by the operator-
    fusion knob (beam expands it in stage 3; the batched engine's role
    floors turn fusion-aware automatically).  The default ``"off"``
    searches exactly the pre-fusion space.
    """
    if stats is None:
        stats = SearchStats()
    if cache is None:
        cache = PlanCostCache()
    if search == "batched":
        cands = (list(candidates) if candidates is not None
                 else enumerate_plans(arch, shape, cc, fusion=fusion))
        decisions = _batched_search(arch, shape, cc, top_k, cands, cache,
                                    stats)
        stats.cache = cache.stats()
        return decisions[:top_k]
    if candidates is not None or search == "exhaustive":
        cands = (list(candidates) if candidates is not None
                 else enumerate_plans(arch, shape, cc, fusion=fusion))
        decisions = [_cost_candidate(arch, shape, p, cc, cache, stats)
                     for p in cands]
        decisions.sort(key=_rank_key)
        stats.cache = cache.stats()
        return decisions[:top_k]
    if search != "beam":
        raise ValueError(f"unknown search strategy {search!r}")
    decisions = _beam_search(arch, shape, cc, top_k, beam_width, cache, stats,
                             fusion=fusion)
    stats.cache = cache.stats()
    return decisions


def _batched_search(arch: ArchConfig, shape: ShapeConfig, cc: ClusterConfig,
                    top_k: int, cands: List[ShardingPlan],
                    cache: PlanCostCache,
                    stats: SearchStats) -> List[PlanDecision]:
    """Exhaustive-space search through the vectorized engine.

    Structure groups stream in ascending role-floor order through a
    rank-key :class:`DominancePool`; at ``top_k == 1`` a group whose
    role's sound cluster floor (``resource.role_floor_times`` — a lower
    bound on every member's time, knobs included) strictly loses to a
    *feasible* incumbent is pruned without being costed: each member
    would rank behind the incumbent under ``_rank_key`` whether feasible
    (worse time) or not (feasibility sinks).  Ties are never pruned
    (strict inequality), so the returned winner is the exhaustive winner
    bit-for-bit.  With ``top_k > 1`` every group is costed — the tail of
    the ranking has no floor argument."""
    from repro_torch.core import resource as _resource  # circular at import time
    # A candidate set with non-"off" fusion members needs fusion-aware
    # floors: "full" removes HBM traffic, so the off-only representative
    # would not lower-bound it (see reference_plans).  Derived from the
    # candidates themselves so explicit candidate lists stay sound.
    floor_fusion = ("off" if all(p.fusion == "off" for p in cands)
                    else "search")
    try:
        floors = _resource.role_floor_times(arch, shape, cc,
                                            fusion=floor_fusion)
    except Exception:
        floors = {}
    groups: Dict[Tuple, List[ShardingPlan]] = {}
    for p in cands:
        groups.setdefault(_structure_key(p, shape.mode), []).append(p)
    ordered = sorted(groups.items(),
                     key=lambda kv: floors.get(kv[0][0], 0.0))
    pool = DominancePool(
        rank_key=_rank_key,
        cannot_win=lambda floor_t, best: best.feasible and floor_t > best.time)
    decisions: List[PlanDecision] = []
    for key, members in ordered:
        floor_t = floors.get(key[0], 0.0)
        if top_k == 1 and not pool.admit(floor_t):
            stats.pruned_dominated += len(members)
            continue
        for d in cost_candidates_batched(arch, shape, members, cc, cache,
                                         stats):
            decisions.append(d)
            pool.offer(d)
    decisions.sort(key=_rank_key)
    return decisions


def _family_beam(ranked: List, width: int, is_pp) -> List:
    """The beam slice when pipelined roles share the space with
    sequential ones: the global top slice widened by the pipelined
    presence, UNION each family's own top ``width``.  The per-family
    guarantees mean neither family can crowd the other out of its slots
    no matter how the mixed ranking falls (a pipeline ranks on different
    knobs — its M, not its remat — so a low stage rank says little about
    either family's expanded best).  The widened global slice is extra
    exploration on exactly the meshes where pipelining enlarged the
    space: it admits entries past the calibrated width even when their
    *family* rank exceeds it — measured to matter when one role's
    microbatch variants flood the stage-2 ranking and the true winner
    (e.g. dp-pure, which only wins after its stage-3 grad-dtype
    expansion) sits just past both cuts.  With no pp entries this IS
    ``ranked[:width]``: every pre-pipeline search is bit-identical."""
    pp = [e for e in ranked if is_pp(e)]
    if not pp:
        return ranked[:width]
    seq = [e for e in ranked if not is_pp(e)]
    out = list(ranked[:width + min(len(pp), width)])
    chosen = set(map(id, out))
    for e in pp[:width] + seq[:width]:
        if id(e) not in chosen:
            chosen.add(id(e))
            out.append(e)
    return out


def _beam_search(arch: ArchConfig, shape: ShapeConfig, cc: ClusterConfig,
                 top_k: int, beam_width: int, cache: PlanCostCache,
                 stats: SearchStats,
                 fusion: str = "off") -> List[PlanDecision]:
    """Staged beam search over the sharding decision vector.

    Stage 1 — axis roles, costed with neutral knobs (remat=none, fp32
    grads, micro=1 — except pipelined roles, whose representative runs at
    the largest valid M: a pipeline at M=1 is all bubble and would be
    unfairly dropped from the beam).  A role whose *most frugal*
    completion (remat=full, max microbatches) still exceeds the HBM budget
    is an infeasible prefix and is dropped without expanding it — unless
    nothing fits, in which case all roles stay so the caller sees the
    honest OOM ranking.

    Stage 2 — remat x microbatch per surviving role.  For a fixed (role,
    micro) the cost model makes recompute strictly slower and strictly
    smaller, so every remat heavier than the lightest feasible one is
    dominated and skipped without costing.

    Stage 3 — grad-reduce dtype, the fusion knob, and collective overlap.
    overlap=False is dominated outright (the model can only discount
    collectives), so only the dtype x fusion grid is expanded.  With the
    default ``fusion="off"`` the grid collapses to the dtype axis and the
    search is bit-identical to the pre-fusion beam.
    """
    remats, micro_opts, gdtypes = _knob_space(shape)
    fus_opts = _fusion_space(fusion)
    budget = cc.hbm_budget

    # ---- stage 1: axis roles --------------------------------------------
    roles = _model_roles(arch, shape, cc)
    stage1: List[Tuple[Dict, PlanDecision]] = []
    kept: List[Tuple[Dict, PlanDecision]] = []
    base_micros: Dict[int, int] = {}     # id(role) -> stage-1 micro used
    for role in roles:
        base_micro = _role_base_micro(role, shape, cc, micro_opts)
        base_micros[id(role)] = base_micro
        d = _cost_candidate(arch, shape,
                            _role_plan(role, cc, remats[0], base_micro,
                                       gdtypes[0]),
                            cc, cache, stats)
        stage1.append((role, d))
        frugal_micro = max((m for m in micro_opts
                            if _micro_valid(role, shape, cc, m)), default=1)
        frugal = _role_plan(role, cc, remats[-1], frugal_micro, gdtypes[0])
        if estimate_hbm(arch, shape, frugal, cc) <= budget:
            kept.append((role, d))
        else:
            stats.pruned_infeasible += 1
    if not kept:           # nothing can fit: keep every prefix, rank honestly
        kept = stage1
    kept.sort(key=lambda rd: _rank_key(rd[1]))
    # Pipelined roles are a new family riding alongside the sequential
    # ones — the beam takes the top beam_width of EACH family (in rank
    # order), so neither can crowd the other out of its slots.  With no
    # pp roles in the space this is exactly kept[:beam_width]: every
    # pre-pipeline search is bit-identical.
    beam1 = _family_beam(kept, beam_width, lambda rd: bool(rd[0].get("pp")))

    # ---- stage 2: remat x microbatches ----------------------------------
    stage2: List[PlanDecision] = []
    oom_pairs: List[Tuple[Dict, int]] = []   # (role, micro) with no fit
    for role, base_d in beam1:
        for micro in micro_opts:
            if not _micro_valid(role, shape, cc, micro):
                continue
            picked = None
            for remat in remats:    # lightest-first: first fit dominates rest
                if picked is not None:
                    stats.pruned_dominated += 1
                    continue
                p = _role_plan(role, cc, remat, micro, gdtypes[0])
                if estimate_hbm(arch, shape, p, cc) > budget:
                    stats.pruned_infeasible += 1
                    continue
                if remat == remats[0] and micro == base_micros[id(role)]:
                    picked = base_d          # already costed in stage 1
                else:
                    picked = _cost_candidate(arch, shape, p, cc, cache, stats)
            if picked is not None:
                stage2.append(picked)
            else:
                oom_pairs.append((role, micro))
    if not any(d.feasible for d in stage2):
        # Nothing fits: rank the infeasible space honestly.  Among plans
        # that all OOM, the fastest has the lightest remat, so one
        # representative per (role, micro) reproduces the exhaustive order.
        for role, micro in oom_pairs:
            p = _role_plan(role, cc, remats[0], micro, gdtypes[0])
            if micro == base_micros[id(role)]:
                d = next(d for r, d in beam1 if r is role)
            else:
                d = _cost_candidate(arch, shape, p, cc, cache, stats)
            stage2.append(d)
    stage2.sort(key=_rank_key)
    beam2 = _family_beam(stage2, beam_width, lambda d: bool(d.plan.pp_axes))

    # ---- stage 3: grad dtype x fusion (+ overlap, dominated) ------------
    final: List[PlanDecision] = []
    for d in beam2:
        final.append(d)
        for gd, fus in itertools.product(gdtypes, fus_opts):
            if gd == d.plan.grad_reduce_dtype and fus == d.plan.fusion:
                continue
            p = dataclasses.replace(d.plan, grad_reduce_dtype=gd, fusion=fus)
            final.append(_cost_candidate(arch, shape, p, cc, cache, stats))
        # overlap=False is dominated outright (the model can only discount
        # collectives) and is not part of the enumerated space — not
        # expanded, and not counted against it either.
    final.sort(key=_rank_key)
    return final[:top_k]
