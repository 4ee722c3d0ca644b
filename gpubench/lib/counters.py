"""The yardstick's operation and byte counts, from shapes alone.

Kernel counts (for a kernel's roofline share): the work the algorithm needs
for one call, whatever implements it: each input byte read once, each
output byte written once, the products the algorithm must form.  The SSD
scan's and flash attention's counts are those the repo's kernel notes use
(``bound_ms`` in PERF.md's kernel table), so a share here and a bound there
are one convention.

Model counts (for MFU): 2 FLOPs per multiply-add of every weight product a
token goes through, in the forward, plus the attention scores and values
over the causal pairs and the SSD scan's own products; training counts
three forwards' worth (forward, and the backward's two products per
forward product).  Recomputation under remat is not counted, nor is
padding.  A hybrid's shared blocks are counted at each application.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from gpubench.lib.device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs: operations at the bf16 dense peak or
    bytes at HBM bandwidth, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def causal_pairs(s: int) -> int:
    """(query, key) pairs of a causal square of ``s``."""
    return s * (s + 1) // 2


def ssd_fwd(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
            esize: int = 2, init: bool = False) -> Tuple[float, float]:
    """One SSD scan call on pre-scaled inputs: the lower-triangle pairs of
    each chunk for C B^T once per group and for the masked scores times
    Xbar per head, and C S^T and the state update per head; bytes: xbar and
    y, B and C by group, log_a (fp32), the final state (fp32) and, with an
    initial state, that state read."""
    flops = 0.0
    for r0 in range(0, s, chunk):
        ln = min(chunk, s - r0)
        flops += b * g * ln * (ln + 1) * n \
            + b * h * (ln * (ln + 1) * p + 4 * ln * p * n)
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * esize \
        + 4 * b * s * h + 4 * b * h * p * n * (2 if init else 1)
    return flops, float(nbytes)


def ssd_bwd(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
            esize: int = 2) -> Tuple[float, float]:
    """The scan's backward: C B^T's pairs once per group, dY Xbar^T, M^T dY,
    Wd^T C and Wd B per head over the pairs, five products of a chunk's rows
    with a state; bytes: xbar, dy, B, C and log_a read, dxbar, dB, dC and
    dlog_a written, the final state's gradient read."""
    flops = 0.0
    for r0 in range(0, s, chunk):
        ln = min(chunk, s - r0)
        pairs = ln * (ln + 1)
        flops += b * g * pairs * n + b * h * (
            pairs * (2 * p + 2 * n) + 10 * ln * p * n)
    nbytes = (3 * b * s * h * p + 4 * b * s * g * n) * esize \
        + 8 * b * s * h + 4 * b * h * p * n
    return flops, float(nbytes)


def flash_fwd(b: int, hq: int, hkv: int, s: int, d: int,
              esize: int = 2) -> Tuple[float, float]:
    """Causal attention forward: QK^T and PV over the causal pairs; q, k, v
    read and o written once."""
    flops = 4.0 * d * causal_pairs(s) * b * hq
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * esize
    return flops, float(nbytes)


def flash_bwd(b: int, hq: int, hkv: int, s: int, d: int,
              esize: int = 2) -> Tuple[float, float]:
    """Causal attention backward: S again, dP, dV, dK and dQ over the causal
    pairs; q, k, v, o, dO and the row log-sum-exp read, dq, dk, dv written
    once."""
    flops = 10.0 * d * causal_pairs(s) * b * hq
    nbytes = (5 * b * hq * s * d + 2 * b * hkv * s * d) * esize \
        + 4 * b * hq * s
    return flops, float(nbytes)


# ------------------------------------------------------------------ model


def ssd_shape(cfg: Dict[str, Any]) -> Dict[str, int]:
    ssm = cfg["ssm"]
    di = ssm["expand"] * cfg["d_model"]
    return {"h": di // ssm["head_dim"], "p": ssm["head_dim"],
            "g": ssm["n_groups"], "n": ssm["state_size"],
            "chunk": ssm["chunk_size"]}


def attn_applications(cfg: Dict[str, Any]) -> int:
    if cfg["family"] == "hybrid":
        return cfg["n_layers"] // cfg["hybrid"]["attn_every"]
    if cfg["family"] == "ssm":
        return 0
    return cfg["n_layers"]


def mamba_layers(cfg: Dict[str, Any]) -> int:
    return cfg["n_layers"] if cfg["family"] in ("ssm", "hybrid") else 0


def forward_flops(cfg: Dict[str, Any], seq: int, head_positions: int) -> float:
    """Model FLOPs of one sequence of ``seq`` real tokens through the
    forward, the head applied at ``head_positions`` of them."""
    d, vocab = cfg["d_model"], cfg["vocab_size"]
    total = 2.0 * head_positions * d * vocab
    if mamba_layers(cfg):
        sh = ssd_shape(cfg)
        di = sh["h"] * sh["p"]
        w_in = d * (2 * di + 2 * sh["g"] * sh["n"] + sh["h"])
        per_layer = 2.0 * seq * (w_in + di * d) + ssd_fwd(
            1, seq, sh["h"], sh["p"], sh["g"], sh["n"], sh["chunk"])[0]
        total += mamba_layers(cfg) * per_layer
    n_attn = attn_applications(cfg)
    if n_attn:
        nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
        hd = cfg.get("head_dim") or d // nh
        proj = d * nh * hd * 2 + d * nkv * hd * 2
        mlp = (3 if cfg.get("gated_mlp", True) else 2) * d * cfg["d_ff"]
        per_app = 2.0 * seq * (proj + mlp) + flash_fwd(
            1, nh, nkv, seq, hd)[0]
        total += n_attn * per_app
    return total


def train_step_flops(cfg: Dict[str, Any], rows: int, seq: int) -> float:
    """One training step of ``rows`` sequences of ``seq`` tokens: three
    forwards' worth, the head at the ``seq - 1`` positions that have a
    target."""
    return 3.0 * rows * forward_flops(cfg, seq, seq - 1)


def prefill_flops(cfg: Dict[str, Any], seq: int) -> float:
    """One prompt of ``seq`` real tokens, the head at its last position."""
    return forward_flops(cfg, seq, 1)
