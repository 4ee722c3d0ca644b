"""Time variants of the SSD backward's tensor-core tile kernel with parts
taken out, to see what holds it back (GPU only).

Each variant is ``csrc/ssd_scan_bwd.cu`` with one textual change, built by
nvcc beside the kernels (all variants in parallel) and loaded in the
library's place; each is timed at mamba2-1.3b's ``[8,2048,64,64]``, N 128,
chunk 256 (bf16, B and C views of one projection, the serve path's decays)
as a whole ``ssd_scan_bwd`` call by CUDA events and, by torch.profiler, its
``ssd_bwd_tile`` kernel alone (null if the trace has no device time), in
two rounds.  The variants that take work
out compute wrong outputs: they are timed, not checked.

    python3 tools/ssd_bwd_variants.py [variant ...]

Variants: ``base`` (the source as it is), ``no_cb`` (M without C B^T: the
decay mask alone, no loads of C B^T), ``no_wd`` (Wd not summed into shared
memory), ``no_state`` (none of the three state products), ``no_state_loads``
(the states not loaded).  Prints the card's name and power limit, then one
JSON line: each variant's (call ms, tile kernel ms) a round.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

CB = "const float m = ok ? cbp[(long long)t * p.LT + s] * lm : 0.f;"
WD = ("if (j < r) sWd[(j * TT + tl) * LDW + sl] += w[nt][e] * lm;",
      "sWd[(i * TT + sl) * LDW + tl] += w[nt][e] * lm;")
STATE = ("{  // dXbar += exp(total - cum) o (B_r dS_out^T), columns P / 2 wn ..",
         "{  // dB += exp(total - cum) o (Xbar_r dS_out), columns N / 2 wn ..",
         "{  // dC += exp(cum) o (dY_r S_in), and C_r . that into dcum")
STATE_LOADS = ("load_bf16_rows_async<N, LDN, P, TL_THREADS>(sSt, dso, N, 0, P);",
               "    cp_async_commit();\n    for (int i = threadIdx.x; i < p.L; "
               "i += TL_THREADS)\n")
VARIANTS = ("base", "no_cb", "no_wd", "no_state", "no_state_loads")


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source has no {old!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The source of variant ``name``."""
    if name == "base":
        return src
    if name == "no_cb":
        return _replace(src, CB, "const float m = lm;")
    if name == "no_wd":
        for old in WD:
            src = _replace(src, old, "")
        return src
    if name == "no_state":
        for old in STATE:
            src = _replace(src, old, "if (p.S < 0) " + old)
        return src
    if name == "no_state_loads":
        src = _replace(src, STATE_LOADS[0], "if (p.S < 0) {")
        return _replace(src, STATE_LOADS[1], "    }\n" + STATE_LOADS[1])
    raise ValueError(f"unknown variant {name!r}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_variants: needs an NVIDIA GPU")
    names = sys.argv[1:] or VARIANTS
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    libs = _build.build_variants(
        "ssd_scan_bwd", {name: variant_source(src, name) for name in names})
    print(cs.device_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    m = cs.SSD_MAIN
    xbar, log_a, bm, cm, _ = cs.ssd_inputs(
        m["b"], m["s"], m["h"], m["p"], m["g"], m["n"], torch.bfloat16, gen,
        model_like=True, views=True)
    dy = torch.randn(xbar.shape, generator=gen, device="cuda").to(xbar.dtype)

    def call():
        return ss.ssd_scan_bwd(xbar, log_a, bm, cm, dy, None,
                               chunk=m["chunk"])
    res = {"shape": "mamba2 [8,2048,64,64], N 128, chunk 256"}
    cs.device_kernel_ms(call)  # a process's first trace can come back empty
    for rnd in range(2):
        for name, path in libs.items():
            _build._libs["ssd_scan_bwd"] = ctypes.CDLL(str(path))
            tile = next((ms for k, ms in cs.device_kernel_ms(call).items()
                         if "ssd_bwd_tile" in k), None)
            res[f"{name}_{rnd}"] = [cs.time_ms(call, 10, 2), tile]
    _build._libs.pop("ssd_scan_bwd", None)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
