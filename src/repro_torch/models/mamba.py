"""Mamba2 (SSD, state-space duality) block: PyTorch counterpart of
``repro.models.mamba``.

The chunked SSD algorithm of arXiv:2405.21060 §6: an intra-chunk quadratic,
attention-like term plus an inter-chunk state recurrence (a python loop over
chunks).  The hand-written kernel for the same scan is
:mod:`repro_torch.kernels.ssd_scan`; :func:`ssd_scan_prescaled` is its plain
version and what the kernel path is held against.

Shapes follow the reference: x [B,S,H,P], dt [B,S,H], A_log [H],
B/C [B,S,G,N].  Unlike the reference, the scan takes any S: the tail of the
last chunk is padded after pre-scaling with ``xbar = 0``, ``log_a = 0`` and
``B = C = 0``, rows that leave y at the real positions and the final state
exactly as they are.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models import layers as L
from repro_torch.models.sharded import draw_leaf, keep_slice, local_call


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{k=j+1..i} log_a[..., k].

    log_a: [..., L] -> [..., L, L], lower-triangular (j <= i), -inf above.
    """
    n = log_a.shape[-1]
    x = torch.cumsum(log_a, dim=-1)
    diff = x[..., :, None] - x[..., None, :]
    ii = torch.arange(n, device=log_a.device)
    mask = ii[:, None] >= ii[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan_prescaled(xbar: torch.Tensor, log_a: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan on pre-scaled inputs, in fp32, for any S.

    xbar [B,S,H,P] (= x * dt), log_a [B,S,H] (= dt * A), B/C [B,S,G,N],
    init_state [B,H,P,N] or None (zeros).  Returns (y [B,S,H,P] in
    ``xbar.dtype``, final_state [B,H,P,N] fp32); the D residual is the
    caller's.
    """
    b, s, h, p = xbar.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    pad = (-s) % chunk
    xb = xbar.to(torch.float32)
    la = log_a.to(torch.float32)
    Bf, Cf = B.to(torch.float32), C.to(torch.float32)
    if pad:
        xb = F.pad(xb, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk

    xc = xb.reshape(b, nc, chunk, h, p)
    lac = la.reshape(b, nc, chunk, h)
    Bc = Bf.reshape(b, nc, chunk, g, n)
    Cc = Cf.reshape(b, nc, chunk, g, n)

    # intra-chunk (quadratic, attention-like); scores by group, then heads
    Lmat = torch.exp(segsum(lac.transpose(2, 3)))              # [b,c,h,l,l]
    scores = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    scores = scores.repeat_interleave(rep, dim=2) * Lmat       # [b,c,h,l,s]
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc)
    del scores, Lmat

    # chunk states
    a_cum = torch.cumsum(lac, dim=2)                           # [b,c,l,h]
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)
    Bh = Bc.repeat_interleave(rep, dim=3)                      # [b,c,l,h,n]
    states = torch.einsum("bclhn,bclhp->bchpn", Bh,
                          xc * decay_to_end[..., None])

    # inter-chunk recurrence; emits the state ENTERING each chunk
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                # [b,c,h]
    state = (init_state.to(torch.float32) if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=xbar.device))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [b,c,h,p,n]

    # off-diagonal (cross-chunk) output
    Ch = Cc.repeat_interleave(rep, dim=3)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, prev_states) \
        * torch.exp(a_cum)[..., None]
    y = (y_diag + y_off).reshape(b, s + pad, h, p)[:, :s]
    return y.to(xbar.dtype), state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                chunk: int = 256, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in fp32.  Returns (y [B,S,H,P] in ``x.dtype``,
    final_state [B,H,P,N] fp32)."""
    dt32 = dt.to(torch.float32).clamp_min(1e-6)
    log_a = dt32 * -torch.exp(A_log.to(torch.float32))     # dt * A, A < 0
    x32 = x.to(torch.float32)
    y, state = ssd_scan_prescaled(x32 * dt32[..., None], log_a, B, C,
                                  chunk=chunk, init_state=init_state)
    y = y + x32 * D.to(torch.float32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A_log: torch.Tensor,
                    B_t: torch.Tensor, C_t: torch.Tensor, D: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update.

    state [B,H,P,N]; x_t [B,H,P]; dt_t [B,H]; B_t/C_t [B,G,N].
    Returns (y [B,H,P] in ``x_t.dtype``, new_state fp32).
    """
    h = state.shape[1]
    rep = h // B_t.shape[1]
    dt_t = dt_t.to(torch.float32).clamp_min(1e-6)
    a = torch.exp(dt_t * -torch.exp(A_log.to(torch.float32)))       # [B,H]
    Bh = B_t.to(torch.float32).repeat_interleave(rep, dim=1)        # [B,H,N]
    Ch = C_t.to(torch.float32).repeat_interleave(rep, dim=1)
    x32 = x_t.to(torch.float32)
    xb = x32 * dt_t[..., None]                                      # [B,H,P]
    new_state = state * a[..., None, None] + xb[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + x32 * D.to(torch.float32)[None, :, None]
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block (in_proj -> conv -> SSD -> gate -> out_proj)
# ---------------------------------------------------------------------------


def mamba_block_init(gen: torch.Generator, d_model: int, ssm,
                     dtype: torch.dtype, lead: Tuple[int, ...] = ()
                     ) -> Dict[str, torch.Tensor]:
    """The reference's shapes, types and scales; ``lead`` prepends stack
    axes to every leaf."""
    di = ssm.d_inner(d_model)
    h = ssm.n_heads(d_model)
    g, n, w = ssm.n_groups, ssm.state_size, ssm.conv_width
    conv_ch = di + 2 * g * n
    dev = gen.device

    def normal(shape, scale):
        return draw_leaf(lead + shape, lambda sl: keep_slice(
            torch.randn(lead + shape, generator=gen, device=dev,
                        dtype=torch.float32) * scale, sl, dtype))

    def fp32(row):
        return row.to(device=dev).expand(lead + row.shape).clone()

    return {
        "w_in": normal((d_model, 2 * di + 2 * g * n + h), d_model ** -0.5),
        "conv_w": normal((w, conv_ch), 0.2),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": fp32(torch.log(torch.linspace(1.0, 16.0, h,
                                               dtype=torch.float32))),
        "D": fp32(torch.ones(h, dtype=torch.float32)),
        "dt_bias": fp32(torch.zeros(h, dtype=torch.float32)),
        "norm_scale": fp32(torch.zeros(di, dtype=torch.float32)),
        "w_out": normal((di, d_model), di ** -0.5),
    }


def _causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d as shifted sums, as in the reference (not
    ``F.conv1d``, which cuDNN would run in TF32).  xc [B,S,C]; w [W,C];
    state [B,W-1,C].  Returns (silu(conv + b), new_state)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((xc.shape[0], width - 1, xc.shape[2]),
                            dtype=xc.dtype, device=xc.device)
    xpad = torch.cat([state.to(xc.dtype), xc], dim=1)
    s = xc.shape[1]
    out = xpad[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + xpad[:, i:i + s, :] * w[i]
    new_state = xpad[:, -(width - 1):, :]
    return F.silu(out + b), new_state


def _conv_kernel(xc, w, b, state):
    from repro_torch.kernels import ops as kops
    return kops.causal_conv(xc, w, b, state)


def _ssd_kernel(xh, dt, A_log, Bh, Ch, D, init, *, chunk: int):
    from repro_torch.kernels import ops as kops
    return kops.ssd_scan(xh, dt, A_log, Bh, Ch, D, chunk=chunk,
                         init_state=init)


def _ssd_plain(xh, dt, A_log, Bh, Ch, D, init, *, chunk: int):
    return ssd_chunked(xh, dt, A_log, Bh, Ch, D, chunk=chunk,
                       init_state=init)


def mamba_block_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, ssm,
                      cache: Optional[Dict[str, torch.Tensor]] = None,
                      use_kernel: bool = False,
                      ) -> Tuple[torch.Tensor,
                                 Optional[Dict[str, torch.Tensor]]]:
    """x: [B, S, d_model].  cache: {"conv": [B,W-1,C], "state": [B,H,P,N]}.

    Returns (out, new_cache); the cache given is not written (the layer
    stack copies the new one into it).  ``use_kernel=True`` routes the conv
    to :func:`repro_torch.kernels.ops.causal_conv` (its sum and SiLU in
    fp32, rounded once) and the scan to
    :func:`repro_torch.kernels.ops.ssd_scan` **with the cache's state as
    its initial state**; the reference drops it on that path.
    """
    bsz, s, d = x.shape
    di = ssm.d_inner(d)
    h = ssm.n_heads(d)
    g, n = ssm.n_groups, ssm.state_size

    with tracing.span("mamba.in_proj"):
        proj = L.dense(x, params["w_in"])              # [B,S,2di+2gn+h]
    z = proj[..., :di]
    conv_in = proj[..., di:2 * di + 2 * g * n]         # xin | Bx | Cx
    dt = proj[..., 2 * di + 2 * g * n:]
    conv_state = cache.get("conv") if cache else None
    with tracing.span("mamba.conv"):
        if use_kernel:  # on the local shards, batch and channels kept
            bc = {0: "b", 2: "c"}
            conv_out, new_conv = local_call(
                _conv_kernel,
                (conv_in, params["conv_w"], params["conv_b"], conv_state),
                (bc, {1: "c"}, {0: "c"}, bc),
                (("b", None, "c"), ("b", None, "c")))
        else:
            conv_out, new_conv = _causal_conv(conv_in, params["conv_w"],
                                              params["conv_b"], conv_state)
    xh = conv_out[..., :di].reshape(bsz, s, h, ssm.head_dim)
    Bh = conv_out[..., di:di + g * n].reshape(bsz, s, g, n)
    Ch = conv_out[..., di + g * n:].reshape(bsz, s, g, n)

    with tracing.span("mamba.ssd"):
        dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
        if cache is not None and s == 1:
            y, new_state = ssd_decode_step(
                cache["state"], xh[:, 0], dt[:, 0], params["A_log"],
                Bh[:, 0], Ch[:, 0], params["D"])
            y = y[:, None]                              # [B,1,H,P]
        else:
            init = cache["state"] if cache is not None else None
            # the scan, kernel or plain, on the local shards of DTensors
            # (torch 2.11's DTensor has no strategy for the flip of
            # cumsum's backward); heads stay sharded only with one group
            # (every head reads group 0's B and C, whatever heads a rank
            # holds)
            h_ = "h" if g == 1 else None
            bh, hh = {0: "b", 2: h_}, {0: h_}
            y, new_state = local_call(
                functools.partial(_ssd_kernel if use_kernel else _ssd_plain,
                                  chunk=ssm.chunk_size),
                (xh, dt, params["A_log"], Bh, Ch, params["D"], init),
                (bh, bh, hh, {0: "b"}, {0: "b"}, hh, {0: "b", 1: h_}),
                (("b", None, h_, None), ("b", h_, None, None)))
    with tracing.span("mamba.gate_norm"):
        y = y.reshape(bsz, s, di)
        y = L.rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype),
                       params["norm_scale"])
    with tracing.span("mamba.out_proj"):
        out = L.dense(y, params["w_out"])
    new_cache = ({"conv": new_conv, "state": new_state}
                 if cache is not None else None)
    return out, new_cache
