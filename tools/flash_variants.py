"""Time variants of the wgmma flash-attention body with parts taken out, to
see what holds it back (GPU only).

Each variant is ``csrc/flash_attention.cu`` with one textual change, built
by nvcc beside the kernels (all variants in parallel) and loaded in the
library's place; each is timed at the two served shapes, qwen1.5-0.5b's
``[8,16,2048,64]`` and zamba2-2.7b's ``[8,32,2048,80]`` (bf16, causal,
transposed views), beside ``F.scaled_dot_product_attention`` in the same
run.  The variants that take work out compute wrong outputs: they are
timed, not checked.

    python3 tools/flash_variants.py [variant ...]

Variants: ``base`` (the source as it is), ``loads_only`` (TMA loads and
barriers, no products, no softmax), ``no_softmax`` (the products, no
softmax), ``ex2_as_fma`` (``ex2.approx`` replaced by an FMA), ``stages5``
(a ring of five stages instead of four).  Prints the card's name and power
limit, then one JSON line per shape.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOFTMAX = ("auto softmax = [&](float (&sacc)[16][4], int i, "
           "float (&alpha)[2]) {")
PV = ("wgmma_rs_n64(oa, pf[kk],", "wgmma_rs_n16(ob, pf[kk],")
QK = ("wgmma_ss_n128(sacc, wg_desc(qa", "wgmma_ss_n128(sacc, wg_desc(qb")
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source has no {old!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The source of variant ``name``."""
    if name == "base":
        return src
    if name == "no_softmax":
        return _replace(src, SOFTMAX,
                        SOFTMAX + " alpha[0] = alpha[1] = 1.f; return;")
    if name == "loads_only":
        s = variant_source(src, "no_softmax")
        for old in PV:
            s = _replace(s, old, "if (kk < 0) " + old)
        for old in QK:
            s = _replace(s, old, "if (i < 0) " + old)
        return s
    if name == "ex2_as_fma":
        return _replace(src, EX2, "y = fmaf(x, 0.001f, 1.f);")
    if name == "stages5":
        return _replace(src, "constexpr int WG_STAGES = 4;",
                        "constexpr int WG_STAGES = 5;")
    raise ValueError(f"unknown variant {name!r}")


def build(names) -> dict:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    return _build.build_variants(
        "flash_attention", {name: variant_source(src, name) for name in names})


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs an NVIDIA GPU")
    names = sys.argv[1:] or ["base", "loads_only", "no_softmax",
                             "ex2_as_fma", "stages5"]
    libs = build(names)
    print(cs.device_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape, m in (("d64", cs.FLASH_MAIN), ("d80", cs.FLASH_D80)):
        q, k, v = cs.flash_inputs(m["b"], m["hq"], m["hkv"], m["s"], m["d"],
                                  torch.bfloat16, gen, views=True)
        res = {"shape": shape, "sdpa_ms": cs.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            30, 3)}
        for name, path in libs.items():
            _build._libs["flash_attention"] = ctypes.CDLL(str(path))
            res[name] = cs.time_ms(
                lambda: fa.flash_attention(q, k, v, causal=True), 30, 3)
        _build._libs.pop("flash_attention", None)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
