"""Time variants of the SSD scan's wgmma kernels with parts taken out, to
see what holds them back (GPU only): the backward's tile kernel, or with
``--fwd`` the forward's chunk-output kernel.

Each variant is ``csrc/ssd_scan_bwd.cu`` (or ``csrc/ssd_scan.cu``) with one
textual change, built by nvcc beside the kernels (all variants in parallel)
and loaded in the library's place; each is timed at mamba2-1.3b's
``[8,2048,64,64]``, N 128, chunk 256 (bf16, B and C views of one
projection, the serve path's decays) as a whole call by CUDA events and, by
torch.profiler, its ``ssd_bwd_tile`` (or ``ssd_chunk_out``) kernel alone
(null if the trace has no device time), in two rounds.  The variants that
take work out compute wrong outputs: they are timed, not checked.

    python3 tools/ssd_bwd_variants.py [--fwd] [variant ...]

Backward variants: ``base`` (the source as it is), ``no_cb`` (M without C
B^T: the decay mask alone, no C B^T products), ``no_wd`` (Wd not added into
its sums in shared memory), ``no_state`` (none of the three state
products), ``no_state_loads`` (the states not loaded: their ring slots are
released to the consumers empty).  Forward variants: ``base``, ``no_decay``
(the mask without its exponentials), ``no_cb`` (no C B^T products),
``no_rs`` (no products of the decayed scores with Xbar), ``no_yoff`` (no C
S_in^T products).  Prints the card's name and power limit, then one JSON
line: each variant's (call ms, kernel ms) a round.
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

CB = ("const float m = cb[i][e] * lm;", "const float m = cb[i8][e] * lm;",
      "wgmma_ss_n64<0, 0>(cb, ")
WD = ("wd[i * 128] = v;", "wd[i8 * 128] = v;")
STATE = ("wgmma_ss_n64<0, 1>(co, ", "wgmma_ss_n64<0, 0>(dx, desc_k(sBr",
         "wgmma_ss_n64<0, 1>(bo, ")
STATE_LOADS = ("ring0.acquire(k, TILE);\n            tma_load_4d(ring0.slot(k), "
               "&maps.s_in,",
               "ring1.acquire(k, TILE);\n            tma_load_4d(ring1.slot(k), "
               "&maps.ds_out,")
VARIANTS = ("base", "no_cb", "no_wd", "no_state", "no_state_loads")
# the forward's chunk-output kernel: (old, new) text of each variant
FWD_PATCHES = {
    "no_decay": [("ex2(ok ? (crow[k] - sCum[min(j, p.L - 1)]) * LOG2E : "
                  "-INFINITY)", "(ok ? 1.f : 0.f)")],
    "no_cb": [("        wgmma_ss_n64<0, 0>(sc, desc_k(sC + f * TILE, ks),\n"
               "                           desc_k(s + f * TILE, ks), 1);", "")],
    "no_rs": [("    rs_split(y, fh, fl, s + NP * TILE);", "")],
    "no_yoff": [("        wgmma_ss_n64<0, 0>(y, desc_k(sC + f * TILE, ks),\n"
                 "                           desc_k(st + f * TILE, ks), 1);",
                 "")],
}
FWD_VARIANTS = ("base",) + tuple(FWD_PATCHES)


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source has no {old!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The source of variant ``name``."""
    if name == "base":
        return src
    if name == "no_cb":
        src = _replace(src, CB[0], "const float m = lm;")
        src = _replace(src, CB[1], "const float m = lm;")
        return _replace(src, CB[2], "if (p.S < 0) " + CB[2])
    if name == "no_wd":
        for old in WD:
            src = _replace(src, old, "")
        return src
    if name == "no_state":
        for old in STATE:
            src = _replace(src, old, "if (p.S < 0) " + old)
        return src
    if name == "no_state_loads":
        for old in STATE_LOADS:
            src = _replace(src, old, old.replace(
                "acquire(k, TILE);", "acquire(k, 0); if (p.S > 0) continue;"))
        return src
    raise ValueError(f"unknown variant {name!r}")


def fwd_variant_source(src: str, name: str) -> str:
    """The forward source (``ssd_scan.cu``) of variant ``name``."""
    if name == "base":
        return src
    if name not in FWD_PATCHES:
        raise ValueError(f"unknown variant {name!r}")
    for old, new in FWD_PATCHES[name]:
        src = _replace(src, old, new)
    return src


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_variants: needs an NVIDIA GPU")
    args = sys.argv[1:]
    fwd = "--fwd" in args
    args = [a for a in args if a != "--fwd"]
    source, kernel = ("ssd_scan", "ssd_chunk_out") if fwd else (
        "ssd_scan_bwd", "ssd_bwd_tile")
    make = fwd_variant_source if fwd else variant_source
    names = args or (FWD_VARIANTS if fwd else VARIANTS)
    src = (_build.CSRC / f"{source}.cu").read_text()
    libs = _build.build_variants(
        source, {name: make(src, name) for name in names})
    print(cs.device_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    m = cs.SSD_MAIN
    xbar, log_a, bm, cm, _ = cs.ssd_inputs(
        m["b"], m["s"], m["h"], m["p"], m["g"], m["n"], torch.bfloat16, gen,
        model_like=True, views=True)
    dy = torch.randn(xbar.shape, generator=gen, device="cuda").to(xbar.dtype)

    def call():
        if fwd:
            return ss.ssd_scan(xbar, log_a, bm, cm, chunk=m["chunk"])
        return ss.ssd_scan_bwd(xbar, log_a, bm, cm, dy, None,
                               chunk=m["chunk"])
    res = {"shape": "mamba2 [8,2048,64,64], N 128, chunk 256",
           "kernel": kernel}
    cs.device_kernel_ms(call)  # a process's first trace can come back empty
    for rnd in range(2):
        for name, path in libs.items():
            _build._libs[source] = ctypes.CDLL(str(path))
            ms = next((v for k, v in cs.device_kernel_ms(call).items()
                       if kernel in k), None)
            res[f"{name}_{rnd}"] = [cs.time_ms(call, 10, 2), ms]
    _build._libs.pop(source, None)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
