"""Plain PyTorch reference of the repo's Mamba2 language model, for deciding
``correct``.

One sequence at a time, in fp32 with TF32 off, from the benchmark's
weights (a dict from the port's leaf paths to tensors; stacked leaves keep
their leading layer axis) and tokens.  Nothing here imports the port: the
equations are written out again from the configuration.

The equations (the repo's, which the configuration files' ``assumed`` lists
set beside the published models):

* RMS norm in fp32, ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``;
* a Mamba2 layer: ``x + out(norm(x))``, where ``in_proj`` gives
  ``z | x | B | C | dt`` in that order, ``x | B | C`` go through a depthwise
  causal conv of width ``conv_width`` and SiLU, ``dt = softplus(dt +
  dt_bias)`` (at least 1e-6), ``A = -exp(A_log)``, the SSD scan (chunked, as
  in arXiv:2405.21060 section 6) plus ``D * x``, then ``norm(y * silu(z))``
  and ``out_proj``;
* the head: the final norm and ``lm_head`` in fp32; the loss: the mean
  next-token cross-entropy over the sequence's first ``S - 1`` positions.

The AdamW steps are the optimizer's published update with the repo's
schedule (linear warm-up, cosine decay to ``min_lr_ratio``), global-norm
clipping, decoupled weight decay on every leaf, fp32 moments, and each
parameter kept between steps in its stored type (bf16 weights stay bf16).

:class:`Precision` ``"fp8"`` rounds both operands of every product to
float8 e4m3 with a per-tensor scale before an fp32 product (the
straight-through rule in the backward): the lower-precision control that
the comparison has to fail.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return t
        d = t.detach()
        scale = d.abs().amax().clamp_min(1e-30) / 448.0
        r = (d / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (r - d)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


class exact_fp32:
    """TF32 off for the block (a float32 product could else run in TF32)."""

    def __enter__(self):
        self._old = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._old
        return False


# ------------------------------------------------------------------ pieces


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x [S, C], w [W, C]: out[t] = sum_i w[i] x[t - W + 1 + i], then
    silu(out + b)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[0]
    out = sum(xp[i:i + s] * w[i] for i in range(width))
    return F.silu(out + b)


def ssd(xbar, log_a, Bm, Cm, chunk: int, prec: Precision):
    """The chunked SSD scan of one sequence: xbar [S, H, P] (x * dt),
    log_a [S, H] (dt * A), B / C [S, G, N].  Returns y [S, H, P] and the
    final state [H, P, N]."""
    s, h, p = xbar.shape
    g, n = Bm.shape[1], Bm.shape[2]
    rep = h // g
    pad = (-s) % chunk
    if pad:             # zero rows leave y and the state as they are
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    c = (s + pad) // chunk
    X = xbar.reshape(c, chunk, h, p)
    A = log_a.reshape(c, chunk, h)
    Bc = Bm.reshape(c, chunk, g, n)
    Cc = Cm.reshape(c, chunk, g, n)
    acum = torch.cumsum(A, dim=1)                               # [c, l, h]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xbar.device).tril()
    seg = (acum[:, :, None, :] - acum[:, None, :, :]).masked_fill(
        ~tri[None, :, :, None], float("-inf"))                  # [c, l, s, h]
    decay = torch.exp(seg).permute(0, 3, 1, 2)                  # [c, h, l, s]
    cb = torch.einsum("clgn,csgn->cgls", prec.q(Cc), prec.q(Bc))
    scores = cb.repeat_interleave(rep, dim=1) * decay
    y = torch.einsum("chls,cshp->clhp", prec.q(scores), prec.q(X))
    to_end = torch.exp(acum[:, -1:, :] - acum)                  # [c, l, h]
    Bh = Bc.repeat_interleave(rep, dim=2)
    states = torch.einsum("clhn,clhp->chpn", prec.q(Bh),
                          prec.q(X * to_end[..., None]))
    chunk_decay = torch.exp(acum[:, -1, :])                     # [c, h]
    state = torch.zeros((h, p, n), dtype=xbar.dtype, device=xbar.device)
    entering = []
    for i in range(c):
        entering.append(state)
        state = state * chunk_decay[i][:, None, None] + states[i]
    prev = torch.stack(entering)                                # [c, h, p, n]
    Ch = Cc.repeat_interleave(rep, dim=2)
    y = y + torch.einsum("clhn,chpn->clhp", prec.q(Ch), prec.q(prev)) \
        * torch.exp(acum)[..., None]
    return y.reshape(c * chunk, h, p)[:s], state


# ------------------------------------------------------------------ layers


def mamba_layer(cfg: dict, w: Weights, i: int, x: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    ssm = cfg["ssm"]
    d = cfg["d_model"]
    di = ssm["expand"] * d
    hp = ssm["head_dim"]
    h = di // hp
    g, n = ssm["n_groups"], ssm["state_size"]
    s = x.shape[0]
    L = lambda name: w[f"blocks.{name}"][i]                     # noqa: E731
    u = rms_norm(x, L("ln"), cfg["norm_eps"])
    proj = prec.mm(u, L("mamba.w_in"))
    z = proj[:, :di]
    xbc = causal_conv(proj[:, di:2 * di + 2 * g * n], L("mamba.conv_w"),
                      L("mamba.conv_b"))
    dt = F.softplus(proj[:, 2 * di + 2 * g * n:] + L("mamba.dt_bias"))
    dt = dt.clamp_min(1e-6)
    xs = xbc[:, :di].reshape(s, h, hp)
    Bm = xbc[:, di:di + g * n].reshape(s, g, n)
    Cm = xbc[:, di + g * n:].reshape(s, g, n)
    A = -torch.exp(L("mamba.A_log"))
    y, _ = ssd(xs * dt[..., None], dt * A, Bm, Cm, ssm["chunk_size"], prec)
    y = (y + xs * L("mamba.D")[None, :, None]).reshape(s, di)
    y = rms_norm(y * F.silu(z), L("mamba.norm_scale"), 1e-5)
    return x + prec.mm(y, L("mamba.w_out"))


def hidden(cfg: dict, w: Weights, tokens: torch.Tensor, prec: Precision,
           remat: bool = False) -> torch.Tensor:
    """The trunk over one sequence of token ids [S]: [S, d] before the
    final norm.  ``remat`` reruns each layer in the backward."""
    x = w["embed"][tokens]
    run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) if remat \
        else (lambda fn, *a: fn(*a))
    for i in range(cfg["n_layers"]):
        x = run(lambda xx, _i=i: mamba_layer(cfg, w, _i, xx, prec), x)
    return x


def head(cfg: dict, w: Weights, x: torch.Tensor,
         prec: Precision) -> torch.Tensor:
    return prec.mm(rms_norm(x, w["final_norm"], cfg["norm_eps"]),
                   w["lm_head"])


@torch.no_grad()
def last_logits(cfg: dict, w: Weights, tokens: torch.Tensor,
                prec: Precision) -> torch.Tensor:
    """fp32 logits [V] at the last position of ``tokens`` [S]."""
    with exact_fp32():
        return head(cfg, w, hidden(cfg, w, tokens, prec)[-1:], prec)[0]


def loss(cfg: dict, w: Weights, tokens: torch.Tensor, prec: Precision,
         remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence [S]."""
    x = hidden(cfg, w, tokens, prec, remat)[:-1]
    logits = head(cfg, w, x, prec)
    return F.cross_entropy(logits, tokens[1:])


# ------------------------------------------------------------------- AdamW


def schedule(opt: dict, step: int) -> float:
    warmup, total = opt["warmup_steps"], opt["total_steps"]
    warm = min(step / max(warmup, 1), 1.0)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


def train(cfg: dict, w0: Weights, batches: Sequence[torch.Tensor], opt: dict,
          prec: Precision) -> Dict[str, object]:
    """AdamW steps from ``w0`` over ``batches`` ([B, S] each; the gradient
    of a batch is the mean of its rows', formed a row at a time).

    Returns ``losses`` (each step's mean loss), ``grad1`` (each leaf's norm
    of the first step's clipped gradient, as the optimizer takes it) and
    ``change`` (each leaf's norm of the change of its stored value over the
    steps)."""
    stored = {k: v.dtype for k, v in w0.items()}
    params = {k: v.to(torch.float32) for k, v in w0.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    with exact_fp32():
        for step, batch in enumerate(batches, 1):
            live = {k: p.detach().requires_grad_() for k, p in params.items()}
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
            total = 0.0
            rows = batch.shape[0]
            for r in range(rows):
                with torch.enable_grad():
                    l_r = loss(cfg, live, batch[r], prec) / rows
                    gs = torch.autograd.grad(l_r, list(live.values()),
                                             allow_unused=True)
                for k, g in zip(live, gs):
                    if g is not None:
                        grads[k] += g
                total += float(l_r.detach())
                del l_r, gs
            del live
            losses.append(total)
            gnorm = math.sqrt(sum(float(g.square().sum())
                                  for g in grads.values()))
            clip = min(opt["grad_clip"] / max(gnorm, 1e-9), 1.0)
            lr = schedule(opt, step)
            b1, b2 = opt["b1"], opt["b2"]
            b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
            for k in params:
                g = grads[k] * clip
                if step == 1:
                    grad1[k] = float(torch.linalg.vector_norm(g))
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g.square()
                upd = (m[k] / b1c) / (torch.sqrt(v[k] / b2c) + opt["eps"])
                p = params[k] - lr * (upd + opt["weight_decay"] * params[k])
                params[k] = p.to(stored[k]).to(torch.float32)
            del grads
    change = {k: float(torch.linalg.vector_norm(params[k] - w0[k].to(
        torch.float32))) for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}
