"""Time variants of the tsmm kernel with parts taken out or changed, to see
what holds it back, and hold each against the float64 Gram matrix (GPU
only).

Each variant is ``csrc/tsmm.cu`` with textual changes, built by nvcc beside
the kernels (all variants in parallel) and loaded in the library's place.
Each is timed at LinReg DS's ``x [262144, 1024]`` fp32 (CUDA events, mean of
5 calls after one), beside ``x.T @ x`` in fp32 (TF32 off) and in TF32, and
its largest error against the plain version and against the float64 Gram
matrix is printed with whether ``chip_smoke.tsmm_tol`` holds it.  The
variants that take work out compute wrong outputs: they are timed, and
their errors mean nothing.

    python3 tools/tsmm_variants.py [--sass] [--ptxas] [--src PATH] [variant ...]

``--src PATH`` takes the variants of another copy of the source (for
example the parent commit's, from ``git archive``) with the same C
interface.

Variants: ``base`` (the source as it is), ``promote<N>`` (the products of
N slabs summed on the tensor cores before they are added into the fp32
accumulator; the source adds every second slab's), ``promote_never`` (all of
a slice's products on the tensor cores), ``one_product`` (fp32 with hi.hi
alone: plain TF32), ``stages<N>`` (N slabs in the ring instead of 4),
``sb<N>`` (N split B tiles in their ring instead of 3), ``cvt_hi`` (hi
rounded by ``cvt.rna``, which adds a select for inf and NaN to the source's
add and mask), ``no_lo_store`` (B's lo tile is not written: half the split's
stores), ``two_products`` (no hi.lo product: a third fewer products and
reads of B), ``no_split`` (the products read whatever the split tiles hold:
B is not split), ``no_a`` (A's fragment is not loaded or split),
``no_products`` (the loads and splits without the products).  ``a+b``
applies both.

``--sass`` prints the count of each ``HGMMA`` and ``WARPGROUP`` instruction
in the base library's kernels (ptxas serializes the products when a
``WARPGROUP.DEPBAR`` follows every ``HGMMA``); ``--ptxas`` builds the base
source with ``-Xptxas -v`` first and prints nvcc's output.  Prints the
card's name and power limit, then one JSON line per variant.
"""
from __future__ import annotations

import ctypes
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

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import tsmm as tsmm_mod  # noqa: E402

PROMOTE = "constexpr int PROMOTE = 2;"
STAGES = "constexpr int STAGES = 4;"
FP32_RUN = """  if (dtype == 0 && products == 3)
    return run<float, 3>"""
SB = "constexpr int SB = 3;"
SPLIT_B = "    split_b<T, P>(st + (diag ? 0 : BLK), sp, sp + SPLIT / 2, warp, lane);"
LOAD_A = "    load_a<T, P>(st, 64 * wg, w, g, t, hi, lo);"
PRODUCTS = "    for (int ks = 0; ks < TK / 8; ++ks) {\n      const int fresh"
LO_STORE = "    if (P == 3) *reinterpret_cast<uint4*>(lo + off) = l;"
HI_LO = """        wgmma_tf32(d, ah[PAR][ks],
                   wg_desc(bh + SPLIT / 2 + 32 * ks, 16, 1024, SW128), 1);"""
HI = "  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;"
VARIANTS = ("base", "promote1", "promote4", "promote_never", "one_product",
            "cvt_hi", "sb2", "stages3+sb4", "no_lo_store", "two_products",
            "no_split", "no_a", "no_products")



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
    if name == "promote_never":
        return _replace(src, PROMOTE, "constexpr int PROMOTE = 1 << 30;")
    if name.startswith("promote"):
        k = int(name[len("promote"):])
        return _replace(src, PROMOTE, f"constexpr int PROMOTE = {k};")
    if name.startswith("sb"):
        k = int(name[len("sb"):])
        return _replace(src, SB, f"constexpr int SB = {k};")
    if name.startswith("stages"):
        k = int(name[len("stages"):])
        return _replace(src, STAGES, f"constexpr int STAGES = {k};")
    if name == "one_product":
        return _replace(src, FP32_RUN, """  if (dtype == 0 && products == 3)
    return run<float, 1>""")
    if name == "cvt_hi":
        return _replace(src, HI, "  hi = tf32(v);")
    if name == "no_lo_store":
        return _replace(src, LO_STORE, "")
    if name == "two_products":
        return _replace(src, HI_LO, "")
    if name == "no_split":
        return _replace(src, SPLIT_B, "    if (nslab < 0) " + SPLIT_B.strip())
    if name == "no_a":
        return _replace(src, LOAD_A, "    if (nslab < 0) " + LOAD_A.strip())
    if name == "no_products":
        return _replace(src, PRODUCTS,
                        "    for (int ks = 0; ks < TK / 8 && nslab < 0; ++ks) "
                        "{\n      const int fresh")
    raise ValueError(f"unknown variant {name!r}")


def sass_counts(lib: Path) -> dict:
    """Per tsmm kernel of ``lib``: how often each HGMMA and WARPGROUP
    instruction appears in its SASS, and their order (H an HGMMA, A a
    WARPGROUP.ARRIVE, D<k> a WARPGROUP.DEPBAR that waits until at most k
    groups are pending)."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "tsmm_tc" not in name:
            continue
        ops = re.findall(r"\b(HGMMA\.\S+|WARPGROUP\.[^;]*)", block)
        counts = dict(Counter(op.split(".")[0] + "." + op.split(".")[1]
                              .split()[0] for op in ops))
        counts["order"] = " ".join(
            "H" if op.startswith("HGMMA") else
            "A" if ".ARRIVE" in op else
            "D" + "".join(re.findall(r"0x(\w+)", op)) for op in ops)
        out[name[-60:]] = counts
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tsmm_variants: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    src_path = _build.CSRC / "tsmm.cu"
    if "--src" in args:
        i = args.index("--src")
        src_path = Path(args.pop(i + 1))
        args.pop(i)
    names = [a for a in args if not a.startswith("--")] or VARIANTS
    if "--ptxas" in args:
        _build.build(["tsmm"], verbose=True)
    src = src_path.read_text()
    libs = _build.build_variants(
        "tsmm", {name: variant_source(src, name) for name in names})
    print(cs.device_line(), flush=True)
    if "--sass" in args and "base" in libs:
        print(json.dumps({"sass": sass_counts(libs["base"])}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    m, n, lam = cs.LINREG_M, cs.LINREG_N, cs.LINREG_LAM
    x = torch.randn((m, n), generator=gen, device="cuda")
    plain = tsmm_mod.tsmm_upper_plain(x, reg=lam).double()
    x64 = x.double()
    blk = torch.arange(n, device="cuda") // tsmm_mod.TILE
    g64 = (x64.T @ x64 + lam * torch.eye(n, device="cuda",
                                         dtype=torch.float64)) \
        * (blk[:, None] <= blk[None, :])
    del x64
    tol = cs.tsmm_tol(torch.float32, m)
    res = {"shape": f"x [{m},{n}] fp32", **cs.tsmm_bound_ms(m, n,
                                                            torch.float32),
           "library_ms": cs.time_ms(lambda: x.T @ x, 5)}
    torch.backends.cuda.matmul.allow_tf32 = True
    res["library_tf32_ms"] = cs.time_ms(lambda: x.T @ x, 5)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(res), flush=True)
    for name, path in libs.items():
        _build._libs["tsmm"] = ctypes.CDLL(str(path))
        out = tsmm_mod.tsmm_upper(x, reg=lam)
        torch.cuda.synchronize()
        row = {"variant": name, "source": str(src_path.relative_to(ROOT)
                                                 if src_path.is_relative_to(ROOT)
                                                 else src_path),
               "ms": cs.time_ms(lambda: tsmm_mod.tsmm_upper(x, reg=lam), 5)}
        for ref_name, ref in (("plain", plain), ("f64", g64)):
            err = (out.double() - ref).abs()
            row[f"max_abs_err_vs_{ref_name}"] = float(err.max())
            row[f"within_tol_vs_{ref_name}"] = bool(
                (err <= tol["atol"] + tol["rtol"] * ref.abs()).all())
        row["bound_fraction"] = res["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        del out
    _build._libs.pop("tsmm", None)


if __name__ == "__main__":
    main()
