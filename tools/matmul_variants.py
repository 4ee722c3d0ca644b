"""Time variants of the matmul-epilogue kernel with parts taken out or
changed, to see what holds it back (GPU only).

Each variant is ``csrc/matmul_epilogue.cu`` with textual changes, built by
nvcc beside the kernels (all variants in parallel) and loaded in the
library's place.  By default each is timed at the prefill gates of
zamba2-2.7b (``silu(x @ w)``, ``[16384,2560]x[2560,10240]``) and
qwen1.5-0.5b (``[16384,1024]x[1024,2816]``), bf16, beside ``F.silu(x @ w)``
in the same run (the ``wgmma`` body); with ``--small-m`` at the five 8-row
shapes of the serve paths (the ``small_m`` body: decode gates and heads,
device time of a CUDA graph of the calls with w cold, as ``chip_smoke.py``
times them)
beside their library calls.  The variants that take work out compute wrong
outputs: they are timed, not checked.

    python3 tools/matmul_variants.py [--sass] [--small-m] [variant ...]

Variants of the ``wgmma`` body: ``base`` (the source as it is),
``loads_only`` (TMA loads and barriers, no products), ``no_loads`` (products
on whatever shared memory holds, no loads), ``no_epilogue`` (no epilogue, no
store), ``bn128`` (tiles of 128 x 128 for bf16 out, and the stages that
frees), ``no_fence_acc`` (no compiler fence on the accumulators before a
stage's products).  Of the ``small_m`` body: ``sm_budget<N>k`` (N KB of
shared memory a block instead of the source's 45, which gives four stages
at 8 rows and 64-column slabs, and five blocks an SM: 37 gives three
stages, 75 eight, 113 twelve, and the card holds as many blocks as fit),
``sm_no_tma`` (w by cp.async from every thread instead of TMA boxes),
``sm_narrow`` and ``sm_wide`` (slabs of 64 or of 128 columns of w at every
8-row shape, where the source picks by shape), ``sm_l2_256`` (each 16-byte
cp.async asks L2 to fetch 256 bytes), ``sm_no_mma`` (the loads without the
products).  ``a+b`` applies both.

``--sass`` prints, for the ``wgmma`` kernels of the base library, the count
of each ``HGMMA`` and ``WARPGROUP`` instruction that ``cuobjdump -sass``
shows (ptxas serializes the products when a ``WARPGROUP.DEPBAR`` follows
every ``HGMMA``).  Prints the card's name and power limit, then one JSON
line per shape.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import matmul_epilogue as mme  # noqa: E402

PRODUCTS = "wgmma_tile<BN, B_KMAJOR ? 0 : 1>(acc, da, db, first ? ks : 1);"
WAIT_FULL = """      const int s = it % ST;
      mbar_wait(full(s), (it / ST) & 1);"""
PRODUCER = "    if (threadIdx.x == 256) {"
EPILOGUE = "      epilogue_regs(p, acc, n0 + 2 * q);"
BF16_LAUNCH = "return w_mn ? launch_wgmma<256, false, false>(p, s)"
FENCE = """      fence_acc(acc);
      wgmma_fence();"""
BUDGET = "constexpr int SM_BUDGET = 45 * 1024;"
WIDE = "constexpr int SM_WIDE_NT = 2;"
WIDE_WHEN = "if (M <= 8 && (N + 63) / 64 >= resident && SM_WIDE_NT > 1) {"
CP_ASYNC = "cp.async.cg.shared.global [%0], [%1], 16, %2;"
SM_MMA = "          mma_16816(acc[t][mt], a, b[mt][0], b[mt][1]);"
VARIANTS = ("base", "loads_only", "no_loads", "no_epilogue", "bn128",
            "no_fence_acc")
SMALL_M_VARIANTS = ("base", "sm_narrow", "sm_wide", "sm_budget37k",
                    "sm_budget75k", "sm_budget113k", "sm_no_tma", "sm_no_mma")


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source has no {old!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The source of variant ``name``; ``a+b`` applies both."""
    if "+" in name:
        for part in name.split("+"):
            src = variant_source(src, part)
        return src
    if name == "base":
        return src
    if name == "loads_only":
        return _replace(src, PRODUCTS, "if (ks < 0) " + PRODUCTS)
    if name == "no_loads":
        s = _replace(src, WAIT_FULL, "      const int s = it % ST;")
        return _replace(s, PRODUCER, "    if (threadIdx.x == 256 && p.M < 0) {")
    if name == "no_epilogue":
        return _replace(src, EPILOGUE, "      continue;\n" + EPILOGUE)
    if name == "bn128":
        return _replace(src, BF16_LAUNCH,
                        "return w_mn ? launch_wgmma<128, false, false>(p, s)")
    if name.startswith("sm_budget") and name.endswith("k"):
        kb = int(name[len("sm_budget"):-1])
        return _replace(src, BUDGET, f"constexpr int SM_BUDGET = {kb} * 1024;")
    if name == "sm_narrow":
        return _replace(src, WIDE, "constexpr int SM_WIDE_NT = 1;")
    if name == "sm_wide":
        return _replace(src, WIDE_WHEN, "if (M <= 8 && SM_WIDE_NT > 1) {")
    if name == "sm_no_tma":
        return _replace(src, "  const bool tma = p.vec_w;",
                        "  const bool tma = false;")
    if name == "sm_l2_256":
        return _replace(src, CP_ASYNC,
                        "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, "
                        "%2;")
    if name == "sm_no_mma":
        return _replace(src, SM_MMA, "          if (kk < 0)\n" + SM_MMA)
    if name == "no_fence_acc":
        return _replace(src, FENCE, "      wgmma_fence();")
    raise ValueError(f"unknown variant {name!r}")


def build(names) -> dict:
    src = (_build.CSRC / "matmul_epilogue.cu").read_text()
    return _build.build_variants(
        "matmul_epilogue", {name: variant_source(src, name) for name in names})


def sass_counts(lib: Path) -> dict:
    """Per wgmma kernel of ``lib``: how often each HGMMA and WARPGROUP
    instruction appears in its SASS."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "mm_epi_wgmma" not in name:
            continue
        ops = re.findall(r"\b(HGMMA\.\S+|WARPGROUP\.\S+)", block)
        out[name[-60:]] = dict(Counter(op.split(".")[0] + "." + op.split(".")[1]
                                       for op in ops))
    return out


def time_small_m(libs: dict, gen) -> None:
    """Each 8-row shape of the serve paths: every variant and the library
    call, device time with w cold."""
    for shape, c, lib_fn in (
            ("zamba2 decode gate", cs.MM_DECODE_GATE,
             lambda x, w: F.silu(x @ w)),
            ("qwen decode gate", cs.MM_QWEN_DECODE_GATE,
             lambda x, w: F.silu(x @ w)),
            ("zamba2 head", cs.MM_HEAD, lambda x, w: (x @ w).float()),
            ("mamba2 head", cs.MM_MAMBA_HEAD, lambda x, w: (x @ w).float()),
            ("qwen head", cs.MM_QWEN_HEAD, lambda x, w: (x @ w).float())):
        x, w, _ = cs.mm_inputs(c["m"], c["n"], c["k"], c["dtype"], gen,
                               model_like=True)
        kw = dict(epilogue=c["epilogue"], out_dtype=c["out_dtype"])
        n_w = max(2, int(-(-cs.COLD_BYTES // (w.numel() * w.element_size()))))
        ring = itertools.cycle([w] + [w.clone() for _ in range(n_w - 1)])
        res = {"shape": shape,
               "library_ms": cs.graph_ms(lambda: lib_fn(x, next(ring))),
               **cs.mm_bound_ms(**c)}
        for name, path in libs.items():
            _build._libs["matmul_epilogue"] = ctypes.CDLL(str(path))
            mme._small_m_calls.clear()
            res[name] = cs.graph_ms(
                lambda: mme.matmul_epilogue(x, next(ring), **kw))
        _build._libs.pop("matmul_epilogue", None)
        mme._small_m_calls.clear()
        print(json.dumps(res), flush=True)
        del x, w, ring


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("matmul_variants: needs an NVIDIA GPU")
    args = sys.argv[1:]
    sass, small_m = "--sass" in args, "--small-m" in args
    names = [a for a in args if not a.startswith("--")] or (
        SMALL_M_VARIANTS if small_m else VARIANTS)
    libs = build(names)
    print(cs.device_line(), flush=True)
    if sass and "base" in libs:
        print(json.dumps({"sass": sass_counts(libs["base"])}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    if small_m:
        time_small_m(libs, gen)
        return
    for shape, c in (("zamba2 gate", cs.MM_GATE),
                     ("qwen gate", cs.MM_QWEN_GATE)):
        x, w, _ = cs.mm_inputs(c["m"], c["n"], c["k"], c["dtype"], gen,
                               model_like=True)
        res = {"shape": shape, "library_ms": cs.time_ms(
            lambda: F.silu(x @ w), 20, 3), **cs.mm_bound_ms(**c)}
        for name, path in libs.items():
            _build._libs["matmul_epilogue"] = ctypes.CDLL(str(path))
            res[name] = cs.time_ms(
                lambda: mme.matmul_epilogue(x, w, epilogue="silu"), 20, 3)
        _build._libs.pop("matmul_epilogue", None)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
