"""Architecture + shape configuration schema (the port's own copy).

One :class:`ArchConfig` per assigned architecture (see ``configs/<id>.py``),
plus the four assigned input-shape sets.  Configs are pure data — models,
planner, dry-run and cost model all read from here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    d_ff_dense: int = 0              # ff width of the dense (non-MoE) layers
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        # decode caches the compressed c_kv + the shared rope key
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    state_size: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: SSM backbone + shared attention block every N layers."""

    attn_every: int = 6
    n_shared_attn_blocks: int = 2   # distinct shared param sets, alternated


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    encoder_seq: int = 1500          # whisper: 30 s audio -> 1500 frames


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    gated_mlp: bool = True           # SwiGLU-style
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # sliding-window pattern: window size per layer position in a repeating
    # cycle; None entry = global attention.  gemma3: 5 local : 1 global.
    window_pattern: Optional[Tuple[Optional[int], ...]] = None
    local_window: int = 1024
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    frontend: str = "none"           # none | audio_stub | vision_stub
    frontend_seq: int = 0            # encoder frames / image patches
    mtp_depth: int = 0               # deepseek multi-token prediction heads
    dtype: str = "bfloat16"

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_window(self, layer_idx: int, seq_len: int) -> int:
        """Effective attention window for a layer (seq_len = global)."""
        if self.window_pattern is None:
            return seq_len
        w = self.window_pattern[layer_idx % len(self.window_pattern)]
        return seq_len if w is None else min(w, seq_len)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / mostly-local attention."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window_pattern is not None

    # -- parameter counts (used for 6ND MODEL_FLOPS and memory checks) ----
    def param_counts(self) -> Dict[str, float]:
        return _param_counts_cached(self)

    def _param_counts_impl(self) -> Dict[str, float]:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        counts: Dict[str, float] = {}
        counts["embed"] = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> float:
            if self.mla:
                m = self.mla
                p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * m.qk_head_dim
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                p += self.n_heads * m.v_head_dim * d
                return p
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + b

        def mlp_params(width: float) -> float:
            return (3 if self.gated_mlp else 2) * d * width

        def ssm_params() -> float:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D
            in_proj = d * (2 * di + 2 * s.n_groups * s.state_size + nh)
            conv = s.conv_width * (di + 2 * s.n_groups * s.state_size)
            return in_proj + conv + di * d + 2 * nh

        layer_total = 0.0
        active_total = 0.0
        for layer in range(self.n_layers):
            if self.family == "ssm":
                lp = ssm_params()
                la = lp
            elif self.family == "hybrid":
                lp = ssm_params()
                la = lp
            elif self.moe is not None:
                a = attn_params()
                if layer < self.moe.first_dense_layers:
                    m = mlp_params(self.moe.d_ff_dense or ff)
                    lp, la = a + m, a + m
                else:
                    per_expert = mlp_params(self.moe.d_ff_expert)
                    routed = self.moe.n_experts * per_expert
                    shared = self.moe.n_shared_experts * per_expert
                    router = d * self.moe.n_experts
                    lp = a + routed + shared + router
                    la = a + self.moe.top_k * per_expert + shared + router
            else:
                lp = attn_params() + mlp_params(ff)
                la = lp
            layer_total += lp
            active_total += la

        # zamba2 shared attention blocks (params counted once, applied often)
        if self.hybrid is not None:
            shared = (attn_params() + mlp_params(ff)) * self.hybrid.n_shared_attn_blocks
            layer_total += shared
            n_applications = self.n_layers // self.hybrid.attn_every
            active_total += (attn_params() + mlp_params(ff)) * n_applications

        if self.enc_dec is not None:
            # encoder layers + decoder cross-attention
            enc = (attn_params() + mlp_params(ff)) * self.enc_dec.n_encoder_layers
            cross = attn_params() * self.n_layers
            layer_total += enc + cross
            active_total += enc + cross

        counts["layers"] = layer_total
        counts["layers_active"] = active_total
        counts["total"] = counts["embed"] + layer_total
        counts["active"] = counts["embed"] + active_total
        return counts

    @property
    def n_params(self) -> float:
        return self.param_counts()["total"]

    @property
    def n_active_params(self) -> float:
        return self.param_counts()["active"]

    # -- smoke-test reduction ---------------------------------------------
    def reduced(self) -> "ArchConfig":
        """A tiny config of the same family for CPU smoke tests."""
        kw: Dict = {}
        kw["n_layers"] = min(self.n_layers, 4 if self.family in ("ssm", "hybrid") else 2)
        kw["d_model"] = 64
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4
        kw["head_dim"] = 16
        kw["d_ff"] = 128 if self.d_ff else 0
        kw["vocab_size"] = 256
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4), top_k=min(self.moe.top_k, 2),
                d_ff_expert=64, d_ff_dense=128 if self.moe.d_ff_dense else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1))
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, state_size=16, head_dim=16,
                                            chunk_size=32)
        if self.hybrid:
            kw["hybrid"] = dataclasses.replace(self.hybrid, attn_every=2,
                                               n_shared_attn_blocks=1)
        if self.enc_dec:
            kw["enc_dec"] = dataclasses.replace(self.enc_dec, n_encoder_layers=2,
                                                encoder_seq=16)
        if self.window_pattern is not None:
            kw["window_pattern"] = (8, None)     # 1 local : 1 global
            kw["local_window"] = 8
            kw["n_layers"] = 4                   # 2 cycles of period 2
        if self.frontend_seq:
            kw["frontend_seq"] = 8
        return dataclasses.replace(self, **kw)


@functools.lru_cache(maxsize=None)
def _param_counts_cached(cfg: "ArchConfig") -> Dict[str, float]:
    return cfg._param_counts_impl()


# ---------------------------------------------------------------------------
# Input shapes (assigned): seq_len x global_batch per mode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("skip: pure full-attention arch — 500k dense-KV decode "
                       "is infeasible (see DESIGN.md §5)")
    return True, ""
