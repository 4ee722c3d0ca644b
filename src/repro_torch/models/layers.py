"""Shared model primitives (PyTorch counterpart of ``repro.models.layers``).

Plain functions on tensors.  Layouts are the reference's: weights
``[d_in, d_out]`` applied as ``x @ w``, attention tensors ``[B, H, S, D]``.

  * attention is *chunked* (online softmax over KV blocks) above 2048
    positions, so a long prefill never materializes an S x S score tensor —
    the plain-PyTorch analogue of the flash kernel in
    :mod:`repro_torch.kernels`, and what the kernel path is held against;
    under grad mode it runs under a checkpoint, as in the reference;
  * sliding-window layers visit a bounded band of KV chunks;
  * the gated MLP's ``act(x @ w_gate)`` goes through the matmul-epilogue
    kernel under ``use_kernel``;
  * ``moe_ffn`` is the reference's GShard capacity routing, as plain torch
    ops: an fp32 router, a top-k (``stable_top_k``) that keeps
    ``jax.lax.top_k``'s order among equal values, queue positions by an
    exclusive cumsum in (token, slot) order, and dense fp32 one-hot
    dispatch and combine products.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.sharded import (is_dtensor, local_call, per_head,
                                        replicate_dims, shard_like)

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Small pieces
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, scaled by ``1 + scale`` (``scale`` starts at zero)."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, D]; positions broadcastable to x.shape[:-1].  Split-half
    rotation, computed in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs       # [..., S, D/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On ``DTensor``s: a vocab-sharded table is
    gathered whole first (GSPMD masks the lookup and all-reduces the rows
    instead; ROADMAP Queue 3), and sharded tokens go through
    ``F.embedding``, whose backward DTensor sums into a partial table
    gradient: its index backward would gather the tokens.  Unsharded
    tokens take the index, the one-device program's op."""
    table = replicate_dims(table, [0])
    if is_dtensor(tokens) and any(p.is_shard() for p in tokens.placements):
        return F.embedding(tokens, table)
    return table[tokens]


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)``; the weights follow the activation's type.  A
    ``DTensor`` product over a sharded contraction (a row-parallel weight)
    is all-reduced here, as GSPMD reduces it: left partial, DTensor
    reduce-scatters it onto the sequence at the next add and the layer's
    later reshapes meet strided shards."""
    y = replicate_dims(x @ w.to(x.dtype), ())
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Direct softmax attention (the kernels' plain version + small-S path).

    q: [B, Hq, Sq, Dk], k: [B, Hkv, Skv, Dk], v: [B, Hkv, Skv, Dv].
    ``q_offset``: absolute position of q[0] relative to k[0] (decode).
    Supports Dk != Dv.  Without grad mode the softmax works on the one fp32
    score tensor in place (the same ops in the same order, so the same
    bits): an MLA prefill at 128 heads x 2048 x 2048 holds one 17.2 GB
    score tensor of B 8 instead of about three.
    """
    if is_dtensor(q) or is_dtensor(k):
        return per_head(functools.partial(
            attention_dense, causal=causal, q_offset=q_offset, window=window,
            scale=scale), q, k, v)
    b, hq, sq, dk = q.shape
    _, hkv, skv, dv = v.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.reshape(b, hkv, g, sq, dk).to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    mask = _band_mask(q_pos, k_pos, causal, window)
    if torch.is_grad_enabled():
        s = (s * scale).masked_fill(~mask, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    else:
        del qg
        p = s.mul_(scale).masked_fill_(~mask, NEG_INF)
        p.sub_(p.amax(dim=-1, keepdim=True)).exp_().mul_(mask)
        p.div_(p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return o.reshape(b, hq, sq, dv).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style, plain PyTorch).

    Each query chunk visits only the KV chunks its causal/window band can
    intersect; chunks wholly inside the band skip the mask.  Peak memory is
    O(q_chunk * kv_chunk) scores per head.
    """
    b, hq, sq, dk = q.shape
    _, hkv, skv, dv = v.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if sq <= 2048 and skv <= 2048:
        return attention_dense(q, k, v, causal=causal, window=window,
                               scale=scale)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    # pad ragged tails; padded keys are masked off via the k_pos < skv check,
    # padded queries are sliced off.
    pad_q = (-sq) % q_chunk
    pad_k = (-skv) % kv_chunk
    sq_p, skv_p = sq + pad_q, skv + pad_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, pad_k))
    nq, nk = sq_p // q_chunk, skv_p // kv_chunk
    g = hq // hkv
    qr = q.reshape(b, hkv, g, nq, q_chunk, dk)

    def kv_step(qi, qc, carry, j, masked):
        m, l, acc = carry
        kj = k[:, :, j * kv_chunk:(j + 1) * kv_chunk]
        vj = v[:, :, j * kv_chunk:(j + 1) * kv_chunk]
        # operands in the working type, products and sums in fp32 (a bf16 x
        # bf16 product is exact in fp32), as preferred_element_type gives
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc.to(torch.float32),
                         kj.to(torch.float32)) * scale
        if masked:
            q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
            k_pos = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = _band_mask(q_pos, k_pos, causal, window)
            mask &= (k_pos < skv)[None, :]               # padded keys
            s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if masked:
            p = p * mask
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(q.dtype).to(torch.float32),
            vj.to(torch.float32))
        return m_new, l_new, acc_new

    def interior_range(qi, lo, kv_hi):
        """KV-chunk indices fully inside the band (no masking needed)."""
        q_lo, q_hi = qi * q_chunk, (qi + 1) * q_chunk - 1
        int_lo, int_hi = lo, kv_hi
        if causal:
            int_hi = min(int_hi, (q_lo + 1) // kv_chunk)
        if window is not None:
            int_lo = max(int_lo, -(-(q_hi - window + 1) // kv_chunk))
        if pad_k:
            int_hi = min(int_hi, skv // kv_chunk)    # padded tail needs mask
        return int_lo, max(int_hi, int_lo)

    outs = []
    for qi in range(nq):
        kv_hi = min(nk, -(-((qi + 1) * q_chunk) // kv_chunk)) if causal else nk
        lo = max(0, (qi * q_chunk - (window or 0)) // kv_chunk) if window else 0
        qc = qr[:, :, :, qi]
        carry = (
            torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32,
                        device=q.device),
            torch.zeros((b, hkv, g, q_chunk, dv), dtype=torch.float32,
                        device=q.device))
        int_lo, int_hi = interior_range(qi, lo, kv_hi)
        for j in range(lo, kv_hi):
            carry = kv_step(qi, qc, carry, j,
                            masked=not (int_lo <= j < int_hi))
        _, l, acc = carry
        outs.append(acc / l[..., None].clamp_min(1e-30))
    o = torch.stack(outs, dim=3)                     # [b,hkv,g,nq,qc,dv]
    o = o.reshape(b, hq, sq_p, dv)
    return o[:, :, :sq].to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, scale: Optional[float] = None,
              use_kernel: bool = False) -> torch.Tensor:
    """Dispatch: dense for small/decode, chunked for long prefill.

    ``use_kernel=True`` routes to the hand-written flash kernel
    (:mod:`repro_torch.kernels.ops`): launched for CUDA tensors, its plain
    version for CPU tensors.  ``DTensor`` operands reach either as their
    local shards, batch and heads kept sharded (:func:`sharded.per_head`):
    attention is independent per (batch, head), and a kernel never sees a
    ``DTensor``.
    """
    sq, skv = q.shape[2], k.shape[2]
    if is_dtensor(q) or is_dtensor(k):
        return per_head(functools.partial(
            attention, causal=causal, window=window, q_offset=q_offset,
            scale=scale, use_kernel=use_kernel), q, k, v)
    if use_kernel and sq > 1 and q.shape[-1] == v.shape[-1]:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    scale=scale)
    if sq == 1 or (sq <= 2048 and skv <= 2048):
        return attention_dense(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    chunked = functools.partial(attention_chunked, causal=causal,
                                window=window, scale=scale)
    if torch.is_grad_enabled():
        # recompute in the backward, as the reference's jax.checkpoint does:
        # without it the backward keeps every KV chunk's softmax residuals
        return checkpoint(chunked, q, k, v, use_reentrant=False)
    return chunked(q, k, v)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def _act(name: str):
    if name == "silu":
        return F.silu
    # the reference's gelu is the tanh approximation
    return lambda t: F.gelu(t, approximate="tanh")


def ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], gated: bool,
        act: str = "silu", use_kernel: bool = False) -> torch.Tensor:
    """Dense MLP. gated: SwiGLU (w_gate, w_up, w_down); else (w_up, w_down).

    ``use_kernel=True`` computes the gated branch's ``act(x @ w_gate)``
    through the hand-written matmul-epilogue kernel on the flattened
    ``[B*S, d]`` view (its plain version for CPU tensors); ``w_up`` and
    ``w_down`` stay plain products.
    """
    actf = _act(act)
    if gated and use_kernel:
        from repro_torch.kernels import ops as kops
        gate = local_call(functools.partial(
            kops.matmul_epilogue, epilogue=act, out_dtype=x.dtype),
            (x.reshape(-1, x.shape[-1]), params["w_gate"].to(x.dtype)),
            ({0: "m"}, {1: "n"}), (("m", "n"),)
        ).reshape(*x.shape[:-1], -1)
        h = gate * dense(x, params["w_up"])
    elif gated:
        h = actf(dense(x, params["w_gate"])) * dense(x, params["w_up"])
    else:
        h = actf(dense(x, params["w_up"], params.get("b_up")))
    return dense(h, params["w_down"], params.get("b_down"))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def stable_top_k(x: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, largest
    first and equal values in index order (the lower index first), as
    ``jax.lax.top_k`` orders them.  ``torch.topk`` promises no order among
    equal values, on the CPU or on the GPU; a stable descending sort
    does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(x: torch.Tensor, w_router: torch.Tensor, *, top_k: int,
              capacity_factor: float,
              group_size: int = 4096) -> Dict[str, torch.Tensor]:
    """The reference's routing of ``moe_ffn`` for x ``[T, d]`` over the
    router ``[d, E]``.  Tokens go in groups of ``tg = min(group_size, T)``
    (one group when ``T % tg``), each expert takes ``capacity`` (token,
    slot) pairs a group, in (token, slot) order.  Returns ``probs``
    ``[G, Tg, E]`` fp32, ``onehot`` ``[G, Tg, k, E]`` (before drops),
    ``gate_idx`` ``[G, Tg, k]``, ``keep`` (bool, the slot is within its
    expert's capacity), the fp32 ``dispatch`` and ``combine`` ``[G, Tg, E,
    C]`` and ``capacity``."""
    t, d = x.shape
    e = w_router.shape[-1]
    tg = min(group_size, t)
    if t % tg:                                       # fall back: one group
        tg = t
    g = t // tg
    capacity = max(int(capacity_factor * top_k * tg / e), 1)
    xg = x.reshape(g, tg, d)

    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                          w_router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = stable_top_k(probs, top_k)         # [G, Tg, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, slot) within its expert queue (per group);
    # one-hots by comparison, as jax.nn.one_hot makes them
    onehot = (gate_idx[..., None] == torch.arange(
        e, device=x.device)).to(torch.float32)                  # [G, Tg, k, E]
    flat = onehot.reshape(g, tg * top_k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, tg, top_k, e)
    pos = torch.einsum("gtke,gtke->gtk", pos, onehot)           # [G, Tg, k]
    keep = pos < capacity
    gate_vals = gate_vals * keep

    pos_cap = torch.where(keep, pos, 0).to(torch.int32)
    disp = onehot * keep[..., None]                             # [G, Tg, k, E]
    pos_onehot = (pos_cap[..., None] == torch.arange(
        capacity, device=x.device)).to(torch.float32)
    dispatch = torch.einsum("gtke,gtkc->gtec", disp, pos_onehot)
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gate_vals, disp,
                           pos_onehot)
    return {"probs": probs, "onehot": onehot, "gate_idx": gate_idx,
            "keep": keep, "dispatch": dispatch, "combine": combine,
            "capacity": capacity}


def _experts(xe: torch.Tensor, w_up: torch.Tensor,
             w_gate: Optional[torch.Tensor], w_down: torch.Tensor, *,
             dtype: torch.dtype) -> torch.Tensor:
    """The experts' batched products over their queues ``xe [G, E, C, d]``
    (``w_gate`` ``None``: not gated), in ``dtype``."""
    up = torch.einsum("gecd,edf->gecf", xe, w_up.to(dtype))
    if w_gate is not None:
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate.to(dtype))) * up
    else:
        h = F.silu(up)
    return torch.einsum("gecf,efd->gecd", h, w_down.to(dtype))


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], *, top_k: int,
            capacity_factor: float, gated: bool,
            group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style capacity-based MoE with token grouping (the reference's
    ``moe_ffn``, line for line).

    x: [T, d].  params: w_router [d, E] (fp32); w_gate / w_up [E, d, ff];
    w_down [E, ff, d].  Returns (out [T, d] in x's type, the Switch aux
    loss, a 0-d fp32 tensor).  Routing is :func:`moe_route`'s.  The tokens
    reach their experts' queues ``[G, E, C, d]`` and come back through
    dense fp32 one-hot products, cast to x's type where the reference
    casts; the expert products are batched products in x's type.  Every
    sum has one fixed order: a rerun repeats bit for bit.
    """
    t, d = x.shape
    r = moe_route(x, params["w_router"], top_k=top_k,
                  capacity_factor=capacity_factor, group_size=group_size)
    g = r["probs"].shape[0]
    xg = x.reshape(g, t // g, d)
    # tokens sharded (dp): each rank's queues hold its tokens' share; they
    # are summed whole here (left partial, DTensor may reduce-scatter them
    # onto the capacity dim, which the combine cannot flatten when uneven)
    xe = replicate_dims(torch.einsum("gtd,gtec->gecd", xg.to(torch.float32),
                                     r["dispatch"]), ())
    xe = xe.to(x.dtype)                                         # [G, E, C, d]
    # the experts on each rank's own experts (ep): the queues are split as
    # the weights are (a local slice), and DTensor's backward of these
    # batched products views a non-contiguous local shard, which fails
    w_up, w_down = params["w_up"], params["w_down"]
    xe = shard_like(xe, 1, w_up, 0)
    experts = {0: "e"}
    ye = local_call(functools.partial(_experts, dtype=x.dtype),
                    (xe, w_up, params.get("w_gate") if gated else None,
                     w_down),
                    ({1: "e"}, experts, experts, experts),
                    ((None, "e", None, None),))
    # experts sharded (ep): the expert outputs are gathered over the
    # experts before the combine, as GSPMD gathers them (torch 2.11's
    # DTensor cannot flatten the sharded expert dim inside this einsum)
    out = torch.einsum("gecd,gtec->gtd",
                       replicate_dims(ye.to(torch.float32), [1]),
                       replicate_dims(r["combine"], [2]))

    # load-balance aux loss (Switch-style), averaged over groups
    e = r["probs"].shape[-1]
    density = r["onehot"].sum(2).mean(1)                        # [G, E]
    density_proxy = r["probs"].mean(1)
    aux = (density * density_proxy).sum(-1).mean() * e
    return out.reshape(t, d).to(x.dtype), aux.to(torch.float32)
