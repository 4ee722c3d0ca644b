"""SystemML-style EXPLAIN with cost annotations (paper Figures 4 & 5).

Produces the text form the paper uses throughout::

    PROGRAM                         # total cost C=3.31s
    --MAIN PROGRAM                  # C=3.31s
    ----GENERIC (lines 1-3)         # C=2.8E-8s
    ------CP tsmm X _mVar2 LEFT     # C=[0.51s, 2.32s]

Leaf instructions show the [IO, compute] split (collective/latency appended
when nonzero); blocks show their aggregated total.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.costmodel import CostedNode, CostedProgram


def _fmt(x: float) -> str:
    if x == 0:
        return "0s"
    if x >= 0.01:
        return f"{x:.3g}s"
    return f"{x:.2g}s".replace("e-0", "E-").replace("e-", "E-")


def _annotate(node: CostedNode) -> str:
    c = node.cost
    if node.children:
        # pipelined loops carry a schedule note (critical stage, bubble
        # fraction) worth surfacing inline — the whole point of costing
        # them as control flow is that the overlap is visible here
        if node.note:
            return f"# C={_fmt(c.total)} [{node.note}]"
        return f"# C={_fmt(c.total)}"
    parts = f"# C=[{_fmt(c.io)}, {_fmt(c.compute)}"
    if c.collective:
        parts += f", coll={_fmt(c.collective)}"
    if c.latency > 1e-7:
        parts += f", lat={_fmt(c.latency)}"
    return parts + "]"


def explain(costed: CostedProgram, max_depth: int = 99,
            show_notes: bool = False) -> str:
    lines: List[str] = []

    def walk(node: CostedNode, depth: int) -> None:
        if depth > max_depth:
            return
        prefix = "--" * depth if depth else ""
        pad = max(2, 64 - len(prefix) - len(node.label))
        lines.append(f"{prefix}{node.label}{' ' * pad}{_annotate(node)}")
        if show_notes and node.note:
            lines.append(f"{prefix}  .. {node.note}")
        for ch in node.children:
            walk(ch, depth + 1)

    walk(costed.root, 0)
    lines.append(f"# total cost C={_fmt(costed.total)}  "
                 f"(io={_fmt(costed.breakdown.io)}, compute={_fmt(costed.breakdown.compute)}, "
                 f"collective={_fmt(costed.breakdown.collective)}, "
                 f"latency={_fmt(costed.breakdown.latency)}; "
                 f"peak HBM/device={costed.peak_hbm_per_device/1e9:.3g} GB)")
    return "\n".join(lines)
