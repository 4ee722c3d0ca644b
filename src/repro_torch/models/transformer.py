"""Decoder-LM transformer assembly (PyTorch counterpart of
``repro.models.transformer``), driven by :class:`ArchConfig`.

Ported so far: the dense family (one homogeneous stack of GQA blocks, e.g.
``qwen1.5-0.5b``), the ssm family (one homogeneous stack of Mamba2 blocks,
``mamba2-1.3b``), the hybrid family (a Mamba2 stack with a shared
attention+MLP block after every ``attn_every`` layers, the shared blocks
alternating, ``zamba2-2.7b``), the vlm family (the dense stack over
precomputed patch embeddings prepended to the tokens, ``pixtral-12b``) and
the encoder-decoder audio family (a non-causal encoder over precomputed
frame embeddings, then a decoder of causal self-attention, cross-attention
over the encoder's output and an MLP, ``whisper-small``) and the dense
window-pattern family (a stack of cycles of ``len(window_pattern)`` GQA
blocks, block ``i`` of a cycle attending over window ``window_pattern[i]``
or, for ``None``, globally, ``gemma3-12b``) and the moe family (blocks
whose MLP is the reference's GShard capacity-routed experts,
:func:`layers.moe_ffn`, plus a shared expert where the config has one,
after ``first_dense_layers`` dense blocks: GQA attention for
``phi3.5-moe-42b-a6.6b``, DeepSeek's multi-head latent attention
(:func:`mla_attention`: low-rank q and kv, a decoupled rope key, the
absorbed MQA-over-latent decode) and the MTP head (:func:`mtp_hidden`,
``loss_fn``'s ``mtp_ce`` term) for ``deepseek-v3-671b``).  MLA outside the
moe family raises ``NotImplementedError``: the reference names its cache
group ``moe`` there while its dense stack reads ``self``, so it has no
decode to hold the port to.

Params are nested dicts of tensors; leaves of the layer stack carry a leading
layer axis, as in the reference, and the stack runs as a python loop over it.
The window-pattern family's ``params["cycles"]`` is a list of one block dict
per position of the pattern, each leaf with a leading cycle axis.  The moe
family keeps the reference's two stacks: ``dense_blocks`` (only when
``first_dense_layers``) and ``blocks``, whose ``moe`` subtree holds the
fp32 router ``w_router [L,d,E]`` and the experts ``w_gate``, ``w_up``
``[L,E,d,ff]`` and ``w_down`` ``[L,E,ff,d]``; a stack with no layers
(every layer dense) is left out.  MLA's attention holds ``w_dq``,
``q_norm`` (fp32), ``w_uq``, ``w_dkv``, ``kv_norm`` (fp32), ``w_ukv`` and
``w_o``; the MTP head is ``params["mtp"] = {"proj" [2d,d], "block" (a
dense block), "norm" (fp32)}``.

Training: :func:`loss_fn` is the reference's next-token CE with the
time-chunked head of :func:`_chunked_ce`, each chunk under a checkpoint; the
layer stack takes the reference's ``remat`` policies (:func:`_remat_wrap`).

The decode cache is ``{"pos": int, "self": {"k", "v": [L,B,Hkv,cap,hd],
"kpos": [L,cap]}}`` for the dense family and ``{"pos": int, "mamba":
{"conv": [L,B,W-1,C], "state": [L,B,H,P,N] fp32}}`` for the ssm family; the
hybrid family has ``mamba`` and ``attn``, the latter stacked over the
``L // attn_every`` applications of a shared block, not over layers; the
encoder-decoder has ``self`` and the cross-attention K/V ``cross_k``,
``cross_v`` ``[L,B,Hkv,F,hd]``, which ``prefill`` replaces with the ones it
computes from the encoder's output (F frames, in the encoder's type); the
window-pattern family has ``p0`` ... ``p{period-1}``, each ``{"k", "v":
[n_cycles,B,Hkv,cap,hd], "kpos": [n_cycles,cap]}`` with ``cap = max_len`` for
a global position and ``min(w, max_len)`` for a position of window ``w``: a
ring in which position ``p`` sits in slot ``p % cap``; the moe family has
the reference's ``dense`` (only when ``first_dense_layers``) and ``moe``
groups (each only when it has layers), each the dense family's ``self``,
or with MLA ``{"ckv": [n,B,max_len,kv_lora_rank], "krope":
[n,B,max_len,qk_rope_head_dim]}``: the compressed latent and the shared
rope key, written at their position.
``pos`` is a host integer, so that a decode step never waits for a device
scalar.  ``prefill`` and ``decode_step`` **write the cache tensors in place**
and return a dict that holds the same tensors.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.sharded import (draw_leaf, is_dtensor, keep_slice,
                                        local_call, per_head, replicate_dims)
from repro_torch.optim.adamw import tree_leaves

Params = Dict[str, Any]
Cache = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def require_ported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is of a family the port runs: the plain dense
    decoder (with or without a window pattern), the attention-free ssm
    stack, the hybrid of the two, the dense decoder behind a vision stub
    (vlm), the encoder-decoder (audio), or the moe decoder, with GQA or
    with MLA (MLA only there: see the module's docstring)."""
    plain = (cfg.mla is None or cfg.family == "moe") \
        and (cfg.moe is None) == (cfg.family != "moe") \
        and (cfg.window_pattern is None or cfg.family == "dense")
    ok = {"dense": cfg.enc_dec is None and cfg.frontend == "none",
          "ssm": cfg.enc_dec is None and cfg.frontend == "none"
          and cfg.ssm is not None,
          "hybrid": cfg.enc_dec is None and cfg.frontend == "none"
          and cfg.ssm is not None and cfg.hybrid is not None,
          "vlm": cfg.enc_dec is None and cfg.frontend == "vision_stub",
          "audio": cfg.enc_dec is not None,
          "moe": cfg.enc_dec is None and cfg.frontend == "none"
          }.get(cfg.family, False)
    if not (plain and ok):
        raise NotImplementedError(
            f"arch '{cfg.name}' (family {cfg.family}): not ported yet; the "
            f"port runs the dense (window pattern included), ssm, hybrid, "
            f"vlm (vision stub), encoder-decoder and moe (MLA only there) "
            f"families only")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid.attn_every:
        raise ValueError(f"hybrid arch '{cfg.name}': n_layers "
                         f"{cfg.n_layers} is not a multiple of attn_every "
                         f"{cfg.hybrid.attn_every}")
    if cfg.window_pattern is not None \
            and cfg.n_layers % len(cfg.window_pattern):
        raise ValueError(f"arch '{cfg.name}': n_layers {cfg.n_layers} is not "
                         f"a multiple of the window pattern's period "
                         f"{len(cfg.window_pattern)}")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _norm_init(gen: torch.Generator, shape, scale: float,
               dtype: torch.dtype) -> torch.Tensor:
    """``N(0, scale^2)`` drawn in fp32, in ``dtype``, through
    ``sharded.draw_leaf``: a sharded init keeps only the rank's slice."""
    shape = tuple(shape)
    return draw_leaf(shape, lambda sl: _draw(gen, shape, scale, dtype, sl))


def _draw(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
          dtype: torch.dtype, sl: Optional[Tuple[slice, ...]]
          ) -> torch.Tensor:
    """The ``sl`` part (``None``: all) of :func:`_norm_init`'s leaf.  A leaf
    of more than two axes (a stack) is filled one matrix at a time, so the
    fp32 draw never holds more than one: a whole stacked expert leaf of
    phi3.5-moe at 24 layers would take 40 GB in fp32.  Every matrix is
    drawn whole, kept or not, so the generator gives the same numbers
    whatever part is kept.  Under ``FakeTensorMode`` (shapes only) a stack
    is left unfilled: there is nothing to fill, and deepseek-v3's 44544
    expert matrices took 34 s to fake-fill."""
    if len(shape) <= 2:
        return keep_slice(torch.randn(shape, generator=gen,
                                      device=gen.device,
                                      dtype=torch.float32) * scale, sl, dtype)
    rows = range(shape[0]) if sl is None else range(
        *sl[0].indices(shape[0]))
    sub = None if sl is None else sl[1:]
    out = torch.empty((len(rows),) + tuple(
        len(range(*s.indices(n))) for s, n in zip(sub, shape[1:]))
        if sub is not None else shape, dtype=dtype, device=gen.device)
    if is_fake(out):
        return out
    for i in range(shape[0]):
        m = _draw(gen, shape[1:], scale, dtype, sub)
        if i in rows:
            out[i - rows.start] = m
    return out


def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
              lead: Tuple[int, ...] = ()) -> Params:
    """GQA projection weights, or MLA's with ``cfg.mla`` (its two norm
    scales fp32 zeros, as the reference keeps them); ``lead`` prepends
    stack axes to every leaf."""
    d, hd = cfg.d_model, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    std = d ** -0.5
    if cfg.mla is not None:
        m = cfg.mla
        zeros = lambda n: torch.zeros(lead + (n,), dtype=torch.float32,
                                      device=gen.device)
        return {
            "w_dq": _norm_init(gen, lead + (d, m.q_lora_rank), std, dtype),
            "q_norm": zeros(m.q_lora_rank),
            "w_uq": _norm_init(gen, lead + (m.q_lora_rank,
                                            nh * m.qk_head_dim),
                               m.q_lora_rank ** -0.5, dtype),
            "w_dkv": _norm_init(gen, lead + (d, m.kv_lora_rank
                                             + m.qk_rope_head_dim),
                                std, dtype),
            "kv_norm": zeros(m.kv_lora_rank),
            "w_ukv": _norm_init(gen, lead + (m.kv_lora_rank, nh * (
                m.qk_nope_head_dim + m.v_head_dim)),
                m.kv_lora_rank ** -0.5, dtype),
            "w_o": _norm_init(gen, lead + (nh * m.v_head_dim, d),
                              (nh * m.v_head_dim) ** -0.5, dtype),
        }
    p = {
        "w_q": _norm_init(gen, lead + (d, nh * hd), std, dtype),
        "w_k": _norm_init(gen, lead + (d, nkv * hd), std, dtype),
        "w_v": _norm_init(gen, lead + (d, nkv * hd), std, dtype),
        "w_o": _norm_init(gen, lead + (nh * hd, d), (nh * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("b_q", nh * hd), ("b_k", nkv * hd),
                            ("b_v", nkv * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype,
                                  device=gen.device)
    return p


def mlp_init(gen: torch.Generator, cfg: ArchConfig, d_ff: int,
             dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    std = d ** -0.5
    p = {"w_up": _norm_init(gen, lead + (d, d_ff), std, dtype),
         "w_down": _norm_init(gen, lead + (d_ff, d), d_ff ** -0.5, dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = _norm_init(gen, lead + (d, d_ff), std, dtype)
    return p


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    """The routed experts' weights in ``dtype`` and the router in fp32
    whatever ``dtype`` is, as the reference keeps it; a shared expert's MLP
    (``shared``) when ``n_shared_experts``."""
    mc = cfg.moe
    d, e, f = cfg.d_model, mc.n_experts, mc.d_ff_expert
    std = d ** -0.5
    p = {"w_router": _norm_init(gen, lead + (d, e), std, torch.float32),
         "w_up": _norm_init(gen, lead + (e, d, f), std, dtype),
         "w_down": _norm_init(gen, lead + (e, f, d), f ** -0.5, dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = _norm_init(gen, lead + (e, d, f), std, dtype)
    if mc.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, mc.n_shared_experts * f, dtype, lead)
    return p


def block_init(gen: torch.Generator, cfg: ArchConfig, *, dtype: torch.dtype,
               lead: Tuple[int, ...] = (), cross: bool = False,
               moe: bool = False) -> Params:
    """A pre-norm block; ``cross`` adds the decoder's cross-attention and its
    norm (``ln_cross``, ``cross``); ``moe`` puts the routed experts
    (``moe``) where the MLP is.  A moe arch's dense blocks take
    ``d_ff_dense`` when it is set."""
    d = cfg.d_model
    zeros = lambda: torch.zeros(lead + (d,), dtype=torch.float32,
                                device=gen.device)
    p = {"ln1": zeros(), "ln2": zeros(),
         "attn": attn_init(gen, cfg, dtype, lead)}
    if moe:
        p["moe"] = moe_init(gen, cfg, dtype, lead)
    else:
        d_ff = cfg.d_ff if cfg.d_ff else 4 * d
        if cfg.moe is not None and cfg.moe.d_ff_dense:
            d_ff = cfg.moe.d_ff_dense
        p["mlp"] = mlp_init(gen, cfg, d_ff, dtype, lead)
    if cross:
        p["ln_cross"] = zeros()
        p["cross"] = attn_init(gen, cfg, dtype, lead)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random weights on ``gen.device`` with the reference's shapes, types and
    scales: norm scales are fp32 zeros, matrices ``N(0, fan_in^-1)`` in
    ``cfg.dtype``, the layer stack has a leading layer axis."""
    require_ported(cfg)
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    params: Params = {
        "embed": _norm_init(gen, (cfg.vocab_size, d), 1.0, dtype),
        "final_norm": torch.zeros((d,), dtype=torch.float32,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _norm_init(gen, (d, cfg.vocab_size), d ** -0.5,
                                       dtype)
    lead = (cfg.n_layers,)
    if cfg.family in ("ssm", "hybrid"):
        params["blocks"] = {
            "ln": torch.zeros(lead + (d,), dtype=torch.float32,
                              device=gen.device),
            "mamba": M.mamba_block_init(gen, d, cfg.ssm, dtype, lead)}
        if cfg.family == "hybrid":
            params["shared_attn"] = [
                block_init(gen, cfg, dtype=dtype)
                for _ in range(cfg.hybrid.n_shared_attn_blocks)]
    elif cfg.enc_dec is not None:
        params["enc_blocks"] = block_init(
            gen, cfg, dtype=dtype, lead=(cfg.enc_dec.n_encoder_layers,))
        params["enc_norm"] = torch.zeros((d,), dtype=torch.float32,
                                         device=gen.device)
        params["blocks"] = block_init(gen, cfg, dtype=dtype, lead=lead,
                                      cross=True)
    elif cfg.moe is not None:
        nd = cfg.moe.first_dense_layers
        if nd:
            params["dense_blocks"] = block_init(gen, cfg, dtype=dtype,
                                                lead=(nd,))
        if cfg.n_layers > nd:
            params["blocks"] = block_init(gen, cfg, dtype=dtype,
                                          lead=(cfg.n_layers - nd,),
                                          moe=True)
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": _norm_init(gen, (2 * d, d), (2 * d) ** -0.5, dtype),
                "block": block_init(gen, cfg, dtype=dtype),
                "norm": torch.zeros((d,), dtype=torch.float32,
                                    device=gen.device)}
    elif cfg.window_pattern is not None:
        period = len(cfg.window_pattern)
        params["cycles"] = [
            block_init(gen, cfg, dtype=dtype, lead=(cfg.n_layers // period,))
            for _ in range(period)]
    else:
        params["blocks"] = block_init(gen, cfg, dtype=dtype, lead=lead)
    return params


# ---------------------------------------------------------------------------
# Attention sublayer apply (dense QKV path + caches)
# ---------------------------------------------------------------------------


def gqa_attention(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                  positions: torch.Tensor, window: Optional[int],
                  causal: bool = True,
                  kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                  pos: Optional[int] = None,
                  use_kernel: bool = False,
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Standard GQA attention.  x: [B,S,d].

    kv_cache: {"k","v": [B,Hkv,cap,hd], "kpos": [cap]}, written in place.
    The reference's ``kv_source`` form is not kept: the decoder's
    cross-attention goes through :func:`cross_attention` over
    :func:`cross_kv`, as the reference's blocks do.
    ``pos`` is the decode position as a host integer (the whole batch shares
    it); it is needed when ``S == 1`` and a cache is given.
    """
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = L.dense(x, p["w_q"], p.get("b_q")).reshape(b, s, nh, hd).transpose(1, 2)
    k = L.dense(x, p["w_k"], p.get("b_k")).reshape(b, s, nkv, hd).transpose(1, 2)
    v = L.dense(x, p["w_v"], p.get("b_v")).reshape(b, s, nkv, hd).transpose(1, 2)

    q = L.apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = L.apply_rope(k, positions[:, None, :], cfg.rope_theta)
    if kv_cache is None:
        out = L.attention(q, k, v, causal=causal, window=window,
                          use_kernel=use_kernel)
    else:
        ck, cv, kpos = kv_cache["k"], kv_cache["v"], kv_cache["kpos"]
        cap = ck.shape[2]
        if s == 1:                                     # decode
            slot = pos % cap
            ck[:, :, slot:slot + 1] = k
            cv[:, :, slot:slot + 1] = v
            kpos[slot] = pos
            valid = (kpos >= 0) & (kpos <= pos)
            if window is not None:
                valid &= kpos > pos - window
            out = _masked_dense_attention(q, ck, cv,
                                          valid[None, None, None, :])
        else:                                          # prefill
            if s >= cap:
                # the last cap positions, position p in slot p % cap, where
                # decode writes it (the reference keeps them at slots 0 to
                # cap - 1, which decode's slots match only when s % cap == 0)
                kept = positions[0, s - cap:]
                slots = kept.long() % cap
                ck.index_copy_(2, slots, k[:, :, s - cap:])
                cv.index_copy_(2, slots, v[:, :, s - cap:])
                kpos.index_copy_(0, slots, kept.to(kpos.dtype))
            else:
                ck[:, :, :s] = k
                cv[:, :, :s] = v
                kpos[:s] = positions[0]
            # attention still runs on the un-truncated k, v
            out = L.attention(q, k, v, causal=causal, window=window,
                              use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, s, nh * hd)
    return L.dense(out, p["w_o"]), kv_cache


def _masked_dense_attention(q, k, v, mask) -> torch.Tensor:
    """Softmax attention of q over a cache under an explicit key mask
    [1,1,1,Skv] (decode); ``DTensor`` operands on their local shards
    (:func:`sharded.per_head`)."""
    if is_dtensor(q) or is_dtensor(k):
        return per_head(_masked_dense_attention, q, k, v, mask)
    b, hq, sq, dk = q.shape
    _, hkv, skv, dv = v.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(dk)
    qg = q.reshape(b, hkv, g, sq, dk).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) * scale
    mask = mask[:, :, None]
    s = s.masked_fill(~mask, L.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / l, v.to(torch.float32))
    return o.reshape(b, hq, sq, dv).to(q.dtype)


def mla_attention(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                  positions: torch.Tensor,
                  kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                  pos: Optional[int] = None,
                  use_kernel: bool = False,
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """DeepSeek's multi-head latent attention (the reference's
    ``mla_attention``).  x: [B,S,d].  q from the low-rank ``c_q``, the keys
    and values from the compressed latent ``c_kv`` (``kv_lora_rank``), a
    rope key of ``qk_rope_head_dim`` shared by every head.

    Without a cache, or with one and S > 1 (prefill): k_nope and v from
    ``c_kv @ w_ukv``, the rope key broadcast to the heads, then
    :func:`layers.attention` at scale ``1/sqrt(qk_head_dim)``; Dk != Dv
    keeps it off the flash kernel, as the reference's dispatch does.
    Prefill writes ``c_kv`` and the rope key at slots ``0 .. S-1`` of the
    cache ``{"ckv": [B,cap,r], "krope": [B,cap,rd]}``, in place.

    With a cache and S == 1 (decode; ``pos`` the host position): the
    absorbed path, MQA over the latent cache.  ``q_nope`` is absorbed into
    the latent (``q_nope . W_uk`` in fp32, cast to the model's type), the
    keys are ``[ckv | krope]`` and the values ``ckv``, the scale corrected
    to MLA's own inside q, and the output goes through ``W_uv`` in fp32.
    """
    m = cfg.mla
    b, s, _ = x.shape
    nh = cfg.n_heads
    r, rd = m.kv_lora_rank, m.qk_rope_head_dim
    dn, dv = m.qk_nope_head_dim, m.v_head_dim

    cq = L.rms_norm(L.dense(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = L.dense(cq, p["w_uq"]).reshape(b, s, nh, m.qk_head_dim).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    # one position row for every head: the reference's jnp.repeat along
    # the head axis, as a broadcast
    q_rope = L.apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)

    ckv_full = L.dense(x, p["w_dkv"])                      # [B,S,r+rd]
    c_kv = L.rms_norm(ckv_full[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(ckv_full[..., None, r:].transpose(1, 2),
                          positions[:, None, :], cfg.rope_theta)  # [B,1,S,rd]

    scale = 1.0 / math.sqrt(m.qk_head_dim)
    if kv_cache is not None and s == 1:
        cc, ckr = kv_cache["ckv"], kv_cache["krope"]       # [B,cap,r|rd]
        cc[:, pos:pos + 1] = c_kv
        ckr[:, pos:pos + 1] = k_rope[:, 0]
        w_ukv = p["w_ukv"].reshape(r, nh, dn + dv)
        w_uk, w_uv = w_ukv[..., :dn], w_ukv[..., dn:]
        q_lat = torch.einsum("bhsd,rhd->bhsr", q_nope.to(torch.float32),
                             w_uk.to(torch.float32)).to(x.dtype)
        q_full = torch.cat([q_lat, q_rope], dim=-1)        # [B,H,1,r+rd]
        k_full = torch.cat([cc, ckr], dim=-1)[:, None]     # [B,1,cap,r+rd]
        kmask = (torch.arange(cc.shape[1], device=x.device)
                 <= pos)[None, None, None, :]
        # _masked_dense_attention scales by 1/sqrt(r+rd); MLA's scale is
        # 1/sqrt(qk_head_dim): the correction goes into q
        corr = math.sqrt(q_full.shape[-1]) * scale
        o_lat = _masked_dense_attention(q_full * corr, k_full, cc[:, None],
                                        kmask)
        out = torch.einsum("bhsr,rhd->bshd", o_lat.to(torch.float32),
                           w_uv.to(torch.float32))
        out = out.reshape(b, s, nh * dv).to(x.dtype)
    else:
        kv = L.dense(c_kv, p["w_ukv"]).reshape(b, s, nh, dn + dv)
        k_nope = kv[..., :dn].transpose(1, 2)
        v = kv[..., dn:].transpose(1, 2)
        k = torch.cat([k_nope, k_rope.expand(b, nh, s, rd).to(k_nope.dtype)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        o = L.attention(qf, k, v, causal=True, scale=scale,
                        use_kernel=use_kernel)
        out = o.transpose(1, 2).reshape(b, s, nh * dv)
        if kv_cache is not None:                          # prefill
            kv_cache["ckv"][:, :s] = c_kv
            kv_cache["krope"][:, :s] = k_rope[:, 0]
    return L.dense(out, p["w_o"]), kv_cache


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def cross_attention(cfg: ArchConfig, p: Params, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cross-attention with precomputed K/V [B,Hkv,F,hd]: dense, not causal,
    never the kernel (as in the reference)."""
    b, s, _ = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim_
    q = L.dense(x, p["w_q"], p.get("b_q")).reshape(b, s, nh, hd).transpose(1, 2)
    o = L.attention_dense(q, k, v, causal=False)
    return L.dense(o.transpose(1, 2).reshape(b, s, nh * hd), p["w_o"])


def cross_kv(cfg: ArchConfig, p: Params, src: torch.Tensor):
    """The cross-attention K and V [B,Hkv,F,hd] of the encoder's output, in
    its type (``dense`` casts the weights to it)."""
    b, sk, _ = src.shape
    nkv, hd = cfg.n_kv_heads, cfg.head_dim_
    k = L.dense(src, p["w_k"], p.get("b_k")).reshape(b, sk, nkv,
                                                     hd).transpose(1, 2)
    v = L.dense(src, p["w_v"], p.get("b_v")).reshape(b, sk, nkv,
                                                     hd).transpose(1, 2)
    return k, v


def block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                positions: torch.Tensor, window: Optional[int],
                causal: bool = True, moe: bool = False,
                kv_cache: Optional[Dict] = None,
                cross_state: Optional[Tuple] = None,
                pos: Optional[int] = None,
                capacity_factor: Optional[float] = None,
                use_kernel: bool = False):
    """One transformer block (MLA attention where the config has it);
    ``cross_state`` (K, V) adds the decoder's
    cross-attention after the self-attention; ``moe`` routes the MLP's
    tokens to the experts (:func:`layers.moe_ffn` over the ``B*S`` tokens,
    ``capacity_factor`` or the config's), plus the shared expert where the
    config has one. Returns (x, cache, aux_loss)."""
    h_in = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        attn_out, new_cache = mla_attention(cfg, p["attn"], h_in,
                                            positions=positions,
                                            kv_cache=kv_cache, pos=pos,
                                            use_kernel=use_kernel)
    else:
        attn_out, new_cache = gqa_attention(cfg, p["attn"], h_in,
                                            positions=positions,
                                            window=window, causal=causal,
                                            kv_cache=kv_cache, pos=pos,
                                            use_kernel=use_kernel)
    x = x + attn_out
    if cross_state is not None:
        ck, cv = cross_state
        x = x + cross_attention(cfg, p["cross"],
                                L.rms_norm(x, p["ln_cross"], cfg.norm_eps),
                                ck, cv)
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe:
        mc = cfg.moe
        b, s, d = h2.shape
        out2d, aux = L.moe_ffn(
            h2.reshape(b * s, d), p["moe"], top_k=mc.top_k,
            capacity_factor=capacity_factor or mc.capacity_factor,
            gated=cfg.gated_mlp)
        out = out2d.reshape(b, s, d)
        if mc.n_shared_experts:
            out = out + L.ffn(h2, p["moe"]["shared"], cfg.gated_mlp,
                              use_kernel=use_kernel)
        return x + out, new_cache, aux
    out = L.ffn(h2, p["mlp"], cfg.gated_mlp,
                act="silu" if cfg.gated_mlp else "gelu",
                use_kernel=use_kernel)
    return x + out, new_cache, 0.0


def mamba_layer_apply(cfg: ArchConfig, p: Params, x: torch.Tensor,
                      cache: Optional[Dict] = None, use_kernel: bool = False):
    """Pre-norm residual Mamba2 layer.  Returns (x, cache, aux_loss); the
    layer's cache views are written in place."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    out, new_cache = M.mamba_block_apply(p["mamba"], h, cfg.ssm, cache,
                                         use_kernel=use_kernel)
    if cache is not None:
        cache["conv"].copy_(new_cache["conv"])
        cache["state"].copy_(new_cache["state"])
    return x + out, cache, 0.0


_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective remat: keep the outputs of the weight products, recompute
    everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn: Callable, remat: str) -> Callable:
    """The reference's ``_remat_wrap`` with ``torch.utils.checkpoint``
    (non-reentrant).  ``"full"`` keeps only the wrapped function's inputs
    and reruns it in the backward.  ``"selective"`` is the counterpart of
    ``dots_with_no_batch_dims_saveable``: it keeps the outputs of
    ``aten.mm`` / ``aten.addmm`` (a ``[B,S,d] @ [d,f]`` weight product
    lowers to one ``mm``) and recomputes the rest.  What does not map one to
    one: XLA decides per dot by its dimension numbers, here the saved ops are
    named; batched products (``bmm``, the attention einsums) are recomputed
    in both; the kernels' autograd Functions rerun their forward in the
    recompute (their launches are not ``mm``), and a product inside a kernel
    (the matmul-epilogue gate and head) is recomputed where XLA would keep
    the reference's einsum."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "selective":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_products))
    raise ValueError(f"unknown remat policy {remat!r}")


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {name: _layer(leaf, i) for name, leaf in tree.items()}
    return tree[i]


def _trace_stack_grad(stacked: Params, p: Params, x: torch.Tensor) -> None:
    """While a profiler records, under grad: the span ``model.stack_grad``
    over what the backward does between this layer's body and the body of
    the layer below (whose output is ``x``): the backward of each slice
    ``p`` takes of a stacked leaf fills a whole-stack zero tensor, and
    autograd adds it into the stack's gradient.  The counter
    ``model.stack_grad_bytes`` adds those whole-stack tensors' bytes."""
    whole = [t for t in tree_leaves(stacked) if t.requires_grad]
    tracing.count("model.stack_grad_bytes",
                  sum(t.numel() * t.element_size() for t in whole))
    tracing.grad_span("model.stack_grad", tree_leaves(p), x)


def scan_stack(stacked: Params, x: torch.Tensor, body_fn: Callable,
               cache: Optional[Dict] = None, remat: str = "none"):
    """Run a homogeneous layer stack: a python loop over the leading layer
    axis.  body_fn(p, h, c) -> (h, c, aux).  Layer caches are views of the
    stacked cache, which the blocks write in place.  Without a cache each
    layer's body runs under ``remat`` (:func:`_remat_wrap`), as the
    reference's scan body does."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    n_layers = leaf.shape[0]
    aux_total = 0.0
    if cache is None:
        body = _remat_wrap(lambda p, h: body_fn(p, h, None), remat)
        for i in range(n_layers):
            p = _layer(stacked, i)
            if tracing.recording() and torch.is_grad_enabled():
                _trace_stack_grad(stacked, p, x)
            x, _, aux = body(p, x)
            aux_total = aux_total + aux
        return x, None, aux_total
    for i in range(n_layers):
        x, _, aux = body_fn(_layer(stacked, i), x, _layer(cache, i))
        aux_total = aux_total + aux
    return x, cache, aux_total


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> Cache:
    """Zero-filled decode cache on ``device``."""
    require_ported(cfg)
    dtype = torch_dtype(cfg.dtype)

    def kvc(n: int, cap: int = max_len) -> Dict[str, torch.Tensor]:
        shape = (n, batch, cfg.n_kv_heads, cap, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "kpos": torch.full((n, cap), -1, dtype=torch.int32,
                                   device=device)}

    if cfg.enc_dec is not None:
        cross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_dec.encoder_seq,
                 cfg.head_dim_)
        return {"pos": 0, "self": kvc(cfg.n_layers),
                "cross_k": torch.zeros(cross, dtype=dtype, device=device),
                "cross_v": torch.zeros(cross, dtype=dtype, device=device)}
    if cfg.window_pattern is not None:
        n_cycles = cfg.n_layers // len(cfg.window_pattern)
        return {"pos": 0, **{
            f"p{i}": kvc(n_cycles, max_len if w is None else min(w, max_len))
            for i, w in enumerate(cfg.window_pattern)}}
    if cfg.family in ("dense", "vlm"):
        return {"pos": 0, "self": kvc(cfg.n_layers)}
    if cfg.moe is not None:
        nd = cfg.moe.first_dense_layers
        cache = {"pos": 0}
        for name, n in (("dense", nd), ("moe", cfg.n_layers - nd)):
            if n and cfg.mla is not None:
                m = cfg.mla
                cache[name] = {
                    "ckv": torch.zeros((n, batch, max_len, m.kv_lora_rank),
                                       dtype=dtype, device=device),
                    "krope": torch.zeros((n, batch, max_len,
                                          m.qk_rope_head_dim),
                                         dtype=dtype, device=device)}
            elif n:
                cache[name] = kvc(n)
        return cache
    s = cfg.ssm
    conv_ch = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.state_size
    cache: Cache = {"pos": 0, "mamba": {
        "conv": torch.zeros((cfg.n_layers, batch, s.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((cfg.n_layers, batch, s.n_heads(cfg.d_model),
                              s.head_dim, s.state_size),
                             dtype=torch.float32, device=device)}}
    if cfg.family == "hybrid":
        cache["attn"] = kvc(cfg.n_layers // cfg.hybrid.attn_every)
    return cache


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def _stack_runner(cfg: ArchConfig, params: Params, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Cache],
                  use_kernel: bool, pos: Optional[int] = None,
                  remat: str = "none",
                  capacity_factor: Optional[float] = None):
    """Run the layer stack. Returns (x, new_cache, aux).  ``remat`` applies
    without a cache (training), as in the reference.  The encoder-decoder's
    stack runs in its callers.  ``capacity_factor`` reaches the moe
    family's experts (None: the config's)."""
    require_ported(cfg)
    if cfg.enc_dec is not None:
        raise RuntimeError("enc_dec is handled in forward_hidden / prefill / "
                           "decode_step directly")
    if cfg.family == "ssm":
        def mamba_body(p, h, c):
            return mamba_layer_apply(cfg, p, h, c, use_kernel)
        x, c2, aux = scan_stack(params["blocks"], x, mamba_body,
                                cache["mamba"] if cache else None, remat)
        return x, ({"mamba": c2} if cache is not None else None), aux
    if cfg.family == "hybrid":
        return _hybrid_stack(cfg, params, x, positions, cache, use_kernel,
                             pos, remat)
    if cfg.window_pattern is not None:
        return _cycle_stack(cfg, params, x, positions, cache, use_kernel,
                            pos, remat)
    if cfg.moe is not None:
        return _moe_stack(cfg, params, x, positions, cache, use_kernel, pos,
                          remat, capacity_factor)

    def body(p, h, c):
        return block_apply(cfg, p, h, positions=positions, window=None,
                           kv_cache=c, pos=pos, use_kernel=use_kernel)
    x, c2, aux = scan_stack(params["blocks"], x, body,
                            cache["self"] if cache else None, remat)
    return x, ({"self": c2} if cache is not None else None), aux


def _hybrid_stack(cfg: ArchConfig, params: Params, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Cache],
                  use_kernel: bool, pos: Optional[int], remat: str = "none"):
    """The hybrid stack: for each segment, ``attn_every`` Mamba2 layers and
    then shared block ``seg % n_shared`` with its own attention cache
    ``cache["attn"][seg]``.  Caches are written in place.  Without a cache
    each Mamba2 layer and each application of a shared block runs under
    ``remat``, as in the reference."""
    every = cfg.hybrid.attn_every
    shared = params["shared_attn"]
    if cache is not None:
        remat = "none"
    mamba = _remat_wrap(lambda p, h, c: mamba_layer_apply(cfg, p, h, c,
                                                          use_kernel), remat)
    block = _remat_wrap(lambda p, h, c: block_apply(
        cfg, p, h, positions=positions, window=None, kv_cache=c, pos=pos,
        use_kernel=use_kernel), remat)
    for seg in range(cfg.n_layers // every):
        for i in range(seg * every, (seg + 1) * every):
            c = _layer(cache["mamba"], i) if cache is not None else None
            x, _, _ = mamba(_layer(params["blocks"], i), x, c)
        a_cache = _layer(cache["attn"], seg) if cache is not None else None
        x, _, _ = block(shared[seg % len(shared)], x, a_cache)
    new_cache = ({"mamba": cache["mamba"], "attn": cache["attn"]}
                 if cache is not None else None)
    return x, new_cache, 0.0


def _moe_stack(cfg: ArchConfig, params: Params, x: torch.Tensor,
               positions: torch.Tensor, cache: Optional[Cache],
               use_kernel: bool, pos: Optional[int], remat: str = "none",
               capacity_factor: Optional[float] = None):
    """The moe stack, as the reference's: the dense blocks
    (``dense_blocks``, cache group ``dense``), then the moe blocks
    (``blocks``, cache group ``moe``), each a :func:`scan_stack`; the aux
    losses summed over the layers."""
    aux_total = 0.0
    new_cache = {} if cache is not None else None
    for moe, name, key in ((False, "dense_blocks", "dense"),
                           (True, "blocks", "moe")):
        if name not in params:
            continue

        def body(p, h, c, _moe=moe):
            return block_apply(cfg, p, h, positions=positions, window=None,
                               moe=_moe, kv_cache=c, pos=pos,
                               capacity_factor=capacity_factor,
                               use_kernel=use_kernel)
        x, c2, aux = scan_stack(params[name], x, body,
                                cache[key] if cache is not None else None,
                                remat)
        aux_total = aux_total + aux
        if cache is not None:
            new_cache[key] = c2
    return x, new_cache, aux_total


def _cycle_stack(cfg: ArchConfig, params: Params, x: torch.Tensor,
                 positions: torch.Tensor, cache: Optional[Cache],
                 use_kernel: bool, pos: Optional[int], remat: str = "none"):
    """The window-pattern stack: for each cycle, block ``i`` of the pattern
    with ``window=window_pattern[i]`` (``None``: global), as the reference
    passes it, and its cache ``cache[f"p{i}"][cycle]``, written in place.
    Without a cache each whole cycle runs under ``remat``, one checkpoint a
    cycle, as the reference's scan body over cycles is wrapped."""
    pattern = cfg.window_pattern
    cycles = params["cycles"]
    n_cycles = cfg.n_layers // len(pattern)

    def cycle(ps, h, cs):
        for i, w in enumerate(pattern):
            h, _, _ = block_apply(cfg, ps[i], h, positions=positions,
                                  window=w,
                                  kv_cache=cs[i] if cs is not None else None,
                                  pos=pos, use_kernel=use_kernel)
        return h

    if cache is None:
        body = _remat_wrap(lambda ps, h: cycle(ps, h, None), remat)
        for c in range(n_cycles):
            x = body([_layer(p, c) for p in cycles], x)
        return x, None, 0.0
    names = [f"p{i}" for i in range(len(pattern))]
    for c in range(n_cycles):
        x = cycle([_layer(p, c) for p in cycles], x,
                  [_layer(cache[n], c) for n in names])
    return x, {n: cache[n] for n in names}, 0.0


def _head(cfg: ArchConfig, params: Params, x: torch.Tensor,
          use_kernel: bool = False) -> torch.Tensor:
    """Final norm and logits in fp32.  Plain: the product runs in the working
    type and is cast afterwards.  ``use_kernel``: the matmul-epilogue kernel
    accumulates in fp32 and writes fp32 logits in its one flush (cast
    sinking)."""
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if use_kernel:
        from repro_torch.kernels import ops as kops
        logits = local_call(functools.partial(
            kops.matmul_epilogue, out_dtype=torch.float32),
            (h.reshape(-1, h.shape[-1]), w.to(h.dtype)),
            ({0: "m"}, {1: "n"}), (("m", "n"),))
        return logits.reshape(*h.shape[:-1], -1)
    return (h @ w.to(h.dtype)).to(torch.float32)


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def run_encoder(cfg: ArchConfig, params: Params, frontend: torch.Tensor,
                remat: str = "none", use_kernel: bool = False) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings [B,F,d]: a
    non-causal stack (the flash kernel under ``use_kernel``), then the
    encoder's norm.  It runs in the frames' type: ``dense`` casts the
    weights to the activation's, as the reference's does."""
    b, f, _ = frontend.shape
    positions = _positions(b, f, frontend.device)

    def body(p, h, c):
        return block_apply(cfg, p, h, positions=positions, window=None,
                           causal=False, use_kernel=use_kernel)
    x, _, _ = scan_stack(params["enc_blocks"], frontend, body, None, remat)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
           frontend: Optional[torch.Tensor], remat: str, use_kernel: bool):
    """Token embeddings, the patch embeddings (cast to the model's type)
    prepended for a vision stub, and the encoder's output for an
    encoder-decoder (else None)."""
    x = L.embed_lookup(params["embed"], tokens)
    if cfg.enc_dec is not None:
        if frontend is None:
            raise ValueError("enc-dec arch needs frontend embeddings")
        return x, run_encoder(cfg, params, frontend, remat, use_kernel)
    if cfg.frontend != "none" and frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    return x, None


def forward_hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                   frontend: Optional[torch.Tensor] = None, *,
                   remat: str = "none", use_kernel: bool = False,
                   capacity_factor: Optional[float] = None):
    """Trunk only: returns (pre-head hidden [B,S_total,d], aux_loss);
    ``S_total`` counts the prepended patches of a vision stub.
    ``capacity_factor``: the moe family's, None for the config's."""
    b = tokens.shape[0]
    x, enc_out = _embed(cfg, params, tokens, frontend, remat, use_kernel)
    positions = _positions(b, x.shape[1], x.device)
    if enc_out is not None:
        def body(p, h, c):
            ck, cv = cross_kv(cfg, p["cross"], enc_out)
            return block_apply(cfg, p, h, positions=positions, window=None,
                               cross_state=(ck, cv), use_kernel=use_kernel)
        x, _, aux = scan_stack(params["blocks"], x, body, None, remat)
        return x, aux
    x, _, aux = _stack_runner(cfg, params, x, positions, None, use_kernel,
                              remat=remat, capacity_factor=capacity_factor)
    return x, aux


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None, *,
            remat: str = "none", use_kernel: bool = False,
            capacity_factor: Optional[float] = None):
    """Full-sequence forward.  Returns (logits [B,S_total,V] fp32,
    aux_loss)."""
    x, aux = forward_hidden(cfg, params, tokens, frontend, remat=remat,
                            use_kernel=use_kernel,
                            capacity_factor=capacity_factor)
    return _head(cfg, params, x, use_kernel), aux


def mtp_hidden(cfg: ArchConfig, params: Params, h_main: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """DeepSeek's MTP trunk (the reference's ``mtp_hidden``): the hidden
    state ``[B,S-1,d]`` that predicts token ``t+2`` from ``norm(h[t])`` and
    the embedding of token ``t+1``, through ``proj`` and one dense block.
    As in the reference the block runs with neither the kernels nor remat:
    its gate is a plain product on both paths."""
    p = params["mtp"]
    b, s = tokens.shape
    h = L.rms_norm(h_main[:, :-1], p["norm"], cfg.norm_eps)
    nxt = L.embed_lookup(params["embed"], tokens[:, 1:])
    x = torch.cat([h, nxt], dim=-1) @ p["proj"].to(h.dtype)
    x, _, _ = block_apply(cfg, p["block"], x,
                          positions=_positions(b, s - 1, x.device),
                          window=None)
    return x


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: str = "none", use_kernel: bool = False,
            aux_weight: float = 0.01, mtp_weight: float = 0.1,
            capacity_factor: Optional[float] = None, ce_chunk: int = 2048):
    """Next-token CE (+ ``aux_weight`` x the MoE aux loss, summed over the
    moe layers, zero for the other families, + ``mtp_weight`` x the MTP
    head's CE where the config and the tree have one).  batch:
    ``{"tokens": [B,S] int}``, plus ``"frontend"`` [B,F,d] for a vision
    stub (the patches prepended, the CE over the tokens' positions only) or
    an encoder-decoder (the encoder's frames).
    Returns (loss, ``{"ce", "aux"}`` and ``"mtp_ce"`` with MTP), each a 0-d
    fp32 tensor.

    The CE head is chunked and rematerialised (:func:`_chunked_ce`), so the
    ``[T, vocab]`` fp32 logits never exist whole.  The MTP CE is the same
    head over :func:`mtp_hidden`'s first S - 2 positions against tokens
    ``2 ..``, with the same ``use_kernel``."""
    require_ported(cfg)
    tokens = batch["tokens"]
    frontend = batch.get("frontend")
    hidden, aux = forward_hidden(cfg, params, tokens, frontend, remat=remat,
                                 use_kernel=use_kernel,
                                 capacity_factor=capacity_factor)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)
    offset = 0
    if cfg.frontend != "none" and cfg.enc_dec is None and frontend is not None:
        offset = frontend.shape[1]
    ce = _chunked_ce(cfg, params,
                     hidden[:, offset:offset + tokens.shape[1] - 1],
                     tokens[:, 1:], ce_chunk, use_kernel)
    total = ce + aux_weight * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth and "mtp" in params:
        mtp_h = mtp_hidden(cfg, params,
                           hidden[:, offset:offset + tokens.shape[1]], tokens)
        mtp_ce = _chunked_ce(cfg, params, mtp_h[:, :-1], tokens[:, 2:],
                             ce_chunk, use_kernel)
        total = total + mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return total, metrics


def _chunked_ce(cfg: ArchConfig, params: Params, h: torch.Tensor,
                targets: torch.Tensor, chunk: int,
                use_kernel: bool = False) -> torch.Tensor:
    """Mean next-token CE with a rematerialised, time-chunked head.

    The reference's chunk rule: ``c = max(min(chunk // b, s), 1)`` time
    steps a chunk with the batch kept leading, the time axis padded to a
    multiple of ``c`` with target -1 (no loss), each chunk's head and CE
    under a checkpoint (the chunk's ``[b, c, vocab]`` fp32 logits are made
    again in the backward and never kept), the sum divided by ``b * s``.
    """
    b, s, _ = h.shape
    c = max(min(chunk // max(b, 1), s), 1)
    pad = (-s) % c
    if pad:
        # on a DTensor each rank pads its own rows (torch 2.11's DTensor
        # fails to redistribute a batch split over two mesh dims for pad)
        h = local_call(functools.partial(F.pad, pad=(0, 0, 0, pad)), (h,),
                       ({0: "b"},), (("b", None, None),))
        targets = local_call(functools.partial(F.pad, pad=(0, pad),
                                               value=-1), (targets,),
                             ({0: "b"},), (("b", None),))

    def chunk_loss(hc, tc):
        logits = _head(cfg, params, hc, use_kernel)         # [b, c, V] fp32
        # a vocab-sharded (tp) or partial (fsdp) head: DTensor's gather
        # along the vocab dim leaves a masked partial that fails to reduce,
        # so the logits are made whole over the vocab first, as GSPMD
        # gathers them for the CE
        logits = replicate_dims(logits, [-1])
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, tc.clamp_min(0)[..., None])[..., 0]
        return torch.where(tc >= 0, logz - ll, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s + pad, c):
        total = total + checkpoint(chunk_loss, h[:, i:i + c],
                                   targets[:, i:i + c], use_reentrant=False)
    return total / (b * s)


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            cache: Cache, frontend: Optional[torch.Tensor] = None, *,
            use_kernel: bool = False,
            capacity_factor: Optional[float] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Fill the decode cache (in place) from a prompt; returns (last-token
    logits [B,V], cache).  Only the last position goes through the head.
    A vision stub's patches come first, so the cache's ``pos`` is patches +
    prompt; an encoder-decoder computes the cross K/V once, from the
    encoder's output, and stores them in ``cross_k`` / ``cross_v``."""
    b = tokens.shape[0]
    x, enc_out = _embed(cfg, params, tokens, frontend, "none", use_kernel)
    stot = x.shape[1]
    positions = _positions(b, stot, x.device)
    new_cache: Cache = {"pos": stot}
    if enc_out is not None:
        cks, cvs = [], []

        def body(p, h, c):
            ck, cv = cross_kv(cfg, p["cross"], enc_out)
            cks.append(ck)
            cvs.append(cv)
            return block_apply(cfg, p, h, positions=positions, window=None,
                               kv_cache=c, cross_state=(ck, cv),
                               use_kernel=use_kernel)
        x, self_c, _ = scan_stack(params["blocks"], x, body, cache["self"])
        new_cache.update(self=self_c, cross_k=torch.stack(cks),
                         cross_v=torch.stack(cvs))
    else:
        x, c2, _ = _stack_runner(cfg, params, x, positions, cache,
                                 use_kernel, capacity_factor=capacity_factor)
        new_cache.update(c2)
    logits = _head(cfg, params, x[:, -1:], use_kernel)
    return logits[:, 0], new_cache


def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                cache: Cache, *, use_kernel: bool = False,
                capacity_factor: Optional[float] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decoding step.  token: [B] int.  Returns (logits [B,V], cache);
    the cache tensors are updated in place."""
    b = token.shape[0]
    pos = int(cache["pos"])
    x = L.embed_lookup(params["embed"], token[:, None])
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    new_cache: Cache = {"pos": pos + 1}
    if cfg.enc_dec is not None:
        def body(p, h, c):
            return block_apply(cfg, p, h, positions=positions, window=None,
                               kv_cache=c["self"], pos=pos,
                               cross_state=(c["k"], c["v"]),
                               use_kernel=use_kernel)
        x, _, _ = scan_stack(params["blocks"], x, body,
                             {"self": cache["self"], "k": cache["cross_k"],
                              "v": cache["cross_v"]})
        new_cache.update(self=cache["self"], cross_k=cache["cross_k"],
                         cross_v=cache["cross_v"])
    else:
        x, c2, _ = _stack_runner(cfg, params, x, positions, cache,
                                 use_kernel, pos=pos,
                                 capacity_factor=capacity_factor)
        new_cache.update(c2)
    logits = _head(cfg, params, x, use_kernel)
    return logits[:, 0], new_cache
