"""The card: its presence, its name and power limit, its published peaks, and
the check that no JAX module was loaded.

Peaks are NVIDIA's data sheet for the H100 SXM part, dense rates without
sparsity, at the full 700 W: 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.  A card
set below 700 W runs slower under load; each run prints the limit beside
its numbers.
"""
from __future__ import annotations

import subprocess
import sys
from typing import Iterable, List

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Top-level module names that no run may load: the JAX package of this repo
# and JAX itself, and the repo's smoke script, tools and JAX benchmarks.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "tools",
             "benchmarks")


def forbidden_loaded(modules: Iterable[str] = None,
                     forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of ``forbidden``, compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    bad = set(forbidden)
    return sorted(m for m in names if m.split(".", 1)[0] in bad)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of every card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def missing_chips(chips: int) -> str:
    """Why this machine cannot run a cell of ``chips`` cards ('' if it
    can)."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards and "
                f"{torch.cuda.device_count()} are visible")
    return ""
