"""Fusion as a plan dimension, checked against the generated plan: the
counterpart of the reference's ``benchmarks/bench_fusion.py``.

Rows:
  * ``fusion.flip.<arch>|<shape>|<mesh>`` - the fusion="off" winner vs the
    fusion="search" winner on a grid cell (pure cost model, the
    reference's code): step times, HBM totals, and whether the knob flipped
    the winner (``FLIP``/``same``).
  * ``fusion.search.<arch>|<shape>|<mesh>`` - beam and batched searches
    over the fusion-widened plan space vs the exhaustive scan (``MATCH`` or
    ``MISMATCH``).
  * ``fusion.graph.<case>`` - the analytical fused-vs-materialized HBM
    ranking checked against the traced plan
    (:func:`repro_torch.core.graph_cost.lower_and_cost`): the fused form is
    one traced function, the materialized form one per stage, its output
    made for real and handed to the next.  The measure is each function's
    *boundary* traffic (argument + output bytes: the boundary is the
    materialization the profiles price).  ``MATCH`` requires the traced
    ranking to agree AND the traced fused/unfused byte delta to equal the
    analytical delta within 5%, and the whole traffic of the fused form to
    be no larger than the split chain's.  On the card each row also
    carries two measured times (CUDA events, median of five warm calls;
    reported, not gated): ``ms_fused``, the kernel that does the fusing
    here (``matmul_epilogue`` with the SiLU or GELU tail; flash attention
    at the case's geometry), and ``ms_split``, the split chain in eager
    ops.
  * ``resource_opt.fusion`` - the gate: a winner flip on a memory-bound
    (decode) cell with strictly smaller HBM totals, beam == exhaustive ==
    batched over the widened space on every cell, and every traced ranking
    agreement holds.

The grid cells are the reference's: qwen1.5-0.5b's and gemma3-12b's
memory-bound decode cells and qwen's train cell (``--quick``: the first
two).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.benchmarks.bench_accuracy import warm_ms
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.costmodel import PlanCostCache
from repro_torch.core.graph_cost import lower_and_cost
from repro_torch.core.linalg_ops import profile
from repro_torch.core.planner import choose_plan
from repro_torch.core.symbols import TensorStat
from repro_torch.core.sweep import CLUSTERS
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul_epilogue import matmul_epilogue
from repro_torch.models.model import require_device

# The reference's memory-bound serving cells (decode streams weights and
# KV; epilogue fusion trims the elementwise round trips) and its train cell.
FLIP_CELLS = [
    ("qwen1.5-0.5b", "decode_32k", "pod"),
    ("gemma3-12b", "decode_32k", "pod"),
    ("gemma3-12b", "decode_32k", "v5p-pod"),
    ("qwen1.5-0.5b", "train_4k", "pod"),
]


def _flip_rows(quick: bool, cache: PlanCostCache):
    rows: List[str] = []
    decode_flip = False
    all_match = True
    cells = FLIP_CELLS[:2] if quick else FLIP_CELLS
    for arch_id, shape_id, cl in cells:
        arch, shape, cc = get_config(arch_id), SHAPES[shape_id], CLUSTERS[cl]
        t0 = time.perf_counter()
        off = choose_plan(arch, shape, cc, search="exhaustive",
                          cache=cache)[0]
        exh = choose_plan(arch, shape, cc, search="exhaustive",
                          fusion="search", cache=cache)[0]
        us = (time.perf_counter() - t0) * 1e6
        flipped = (exh.plan.fusion != "off"
                   and exh.cost.total < off.cost.total
                   and exh.cost.totals.hbm_bytes < off.cost.totals.hbm_bytes)
        if flipped and shape.mode != "train":
            decode_flip = True
        rows.append(
            f"fusion.flip.{arch_id}|{shape_id}|{cl},{us:.0f},"
            f"off_T={off.cost.total * 1e3:.4f}ms;"
            f"search_T={exh.cost.total * 1e3:.4f}ms;"
            f"fusion={exh.plan.fusion};"
            f"hbm_off={off.cost.totals.hbm_bytes:.4e};"
            f"hbm_search={exh.cost.totals.hbm_bytes:.4e};"
            f"{'FLIP' if flipped else 'same'}")
        beam = choose_plan(arch, shape, cc, fusion="search", cache=cache)[0]
        bat = choose_plan(arch, shape, cc, search="batched",
                          fusion="search", cache=cache)[0]
        match = all(d.cost.total == exh.cost.total
                    and d.plan.fusion == exh.plan.fusion
                    for d in (beam, bat))
        all_match = all_match and match
        rows.append(
            f"fusion.search.{arch_id}|{shape_id}|{cl},0,"
            f"beam_T={beam.cost.total * 1e3:.4f}ms;"
            f"batched_T={bat.cost.total * 1e3:.4f}ms;"
            f"{'MATCH' if match else 'MISMATCH'}")
    return rows, decode_flip, all_match


# ---------------------------------------------------------------------------
# Traced-plan agreement: function boundaries force materialization
# ---------------------------------------------------------------------------
def _tanh_gelu(t: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh) form, the epilogue kernel's."""
    return F.gelu(t, approximate="tanh")


def _graph_cases(quick: bool, dev: torch.device):
    """(name, analytical fused/unfused byte totals, fused fn, split fns,
    example args, the fusing kernel's call) per smoke-arch case, fp32 as
    the reference's."""
    qwen = get_config("qwen1.5-0.5b")
    mamba = get_config("mamba2-1.3b")
    m = 256 if quick else 2048
    cases = []

    def matmul_case(tag, d_in, d_out, act):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((m, d_in)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((d_in, d_out)).astype(
            np.float32)).to(dev)
        a = TensorStat((m, d_in), "float32")
        ws = TensorStat((d_in, d_out), "float32")
        fused_p = profile("matmul", [a, ws], epilogue=act)
        plain_p = profile("matmul", [a, ws])
        ew_p = profile(act, [plain_p.out])
        ana_fused = fused_p.read_bytes + fused_p.write_bytes
        ana_unf = (plain_p.read_bytes + plain_p.write_bytes
                   + ew_p.read_bytes + ew_p.write_bytes)
        activation = F.silu if act == "silu" else _tanh_gelu
        fused = lambda a_, w_: activation(a_ @ w_)          # noqa: E731
        split = [lambda a_, w_: a_ @ w_, activation]
        kernel = lambda: matmul_epilogue(x, w, epilogue=act)  # noqa: E731
        return (tag, ana_fused, ana_unf, fused, split, (x, w), kernel)

    # qwen's gated-MLP up-projection (SiLU tail) and mamba's output
    # projection with the GELU tail stand-in for its gated elementwise mix
    cases.append(matmul_case(
        "qwen1.5-0.5b.mlp_silu", qwen.d_model,
        min(qwen.d_ff, 512) if quick else qwen.d_ff, "silu"))
    cases.append(matmul_case(
        "mamba2-1.3b.proj_gelu", min(mamba.d_model, 512) if quick else
        mamba.d_model, min(mamba.d_model, 512) if quick else mamba.d_model,
        "gelu"))

    # attention on qwen's geometry: one function vs one per stage
    hq = 4 if quick else qwen.n_heads
    s = 128 if quick else 1024
    d = qwen.d_model // qwen.n_heads
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((hq, s, d)).astype(
        np.float32)).to(dev) for _ in range(3))
    qs = [TensorStat((1, hq, s, d), "float32")] * 3
    f_p = profile("attention", list(qs), fused=True)
    m_p = profile("attention", list(qs), fused=False)
    scale = 1.0 / float(np.sqrt(d))
    fused_attn = lambda q_, k_, v_: torch.softmax(           # noqa: E731
        q_ @ k_.transpose(1, 2) * scale, dim=-1) @ v_
    split_attn = [
        lambda q_, k_, v_: q_ @ k_.transpose(1, 2) * scale,
        lambda s_: torch.softmax(s_, dim=-1),
    ]
    kernel = lambda: flash_attention(q[None], k[None], v[None],  # noqa: E731
                                     causal=False)
    cases.append(("qwen1.5-0.5b.attention",
                  f_p.read_bytes + f_p.write_bytes,
                  m_p.read_bytes + m_p.write_bytes,
                  fused_attn, split_attn, (q, k, v), kernel))
    return cases


def _graph_rows(quick: bool, dev: torch.device):
    rows: List[str] = []
    all_match = True

    def boundary(cost):
        return cost.argument_bytes + cost.output_bytes

    for tag, ana_fused, ana_unf, fused_fn, split_fns, args, kernel in \
            _graph_cases(quick, dev):
        t0 = time.perf_counter()
        _, fused_cost = lower_and_cost(f"{tag}.fused", fused_fn, args)
        graph_fused = boundary(fused_cost)
        acc_fused = fused_cost.bytes_per_device
        # chain the split stages, summing each traced function's traffic
        graph_unf = acc_unf = 0.0
        chain: List[Callable] = []
        cur = args
        for i, fn in enumerate(split_fns):
            _, cost = lower_and_cost(f"{tag}.split{i}", fn, cur)
            graph_unf += boundary(cost)
            acc_unf += cost.bytes_per_device
            chain.append(lambda c, fn=fn: (fn(*c),))
            cur = (fn(*cur),)
        if tag.endswith("attention"):
            # the AV product closes the materialized chain: probs @ v
            av = lambda p_, v_: p_ @ v_                     # noqa: E731
            _, cost = lower_and_cost(f"{tag}.split_av", av,
                                     (cur[0], args[2]))
            graph_unf += boundary(cost)
            acc_unf += cost.bytes_per_device
            chain.append(lambda c, v_=args[2]: (av(c[0], v_),))
        us = (time.perf_counter() - t0) * 1e6
        rank = ana_fused < ana_unf and graph_fused < graph_unf
        delta_agree = abs((ana_unf - ana_fused) - (graph_unf - graph_fused)) \
            <= 0.05 * (ana_unf - ana_fused)
        match = rank and delta_agree and acc_fused <= acc_unf
        all_match = all_match and match
        times = ""
        if dev.type == "cuda":
            def split_chain(c=args, chain=chain):
                for stage in chain:
                    c = stage(c)
                return c
            times = (f"ms_fused={warm_ms(kernel, dev):.4f};"
                     f"ms_split={warm_ms(split_chain, dev):.4f};")
        rows.append(
            f"fusion.graph.{tag},{us:.0f},"
            f"ana_fused={ana_fused:.3e};ana_unfused={ana_unf:.3e};"
            f"graph_fused={graph_fused:.3e};graph_unfused={graph_unf:.3e};"
            f"{times}{'MATCH' if match else 'MISMATCH'}")
    return rows, all_match


def run(quick: bool = False, device="cuda") -> List[str]:
    """The rows above; the traced cases' tensors on ``device`` (the card by
    default, where the rows also carry measured times)."""
    dev = require_device(device)
    cache = PlanCostCache()
    rows, decode_flip, search_match = _flip_rows(quick, cache)
    graph_rows, graph_match = _graph_rows(quick, dev)
    rows.extend(graph_rows)
    gate = decode_flip and search_match and graph_match
    rows.append(
        f"resource_opt.fusion,0,"
        f"decode_flip={decode_flip};search_match={search_match};"
        f"graph_match={graph_match};{'PASS' if gate else 'FAIL'}")
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    for row in run(args.quick, args.device):
        print(row, flush=True)


if __name__ == "__main__":
    main()
