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

With ``--bwd`` the variants are of the backward's ``wgmma`` body
(``csrc/flash_attention_bwd.cu``), timed as ``flash_attention_bwd`` calls
on o and lse from the forward kernel, beside SDPA's backward alone:

    python3 tools/flash_variants.py --bwd [--src PATH] [variant ...]

``--src PATH`` takes the variants of another copy of
``flash_attention_bwd.cu`` (another tree's, from ``git archive``), built
against this tree's headers.

``base``, ``no_dq_atomics`` (dQ computed and summed, not reduce-added to
the fp32 buffer, and no block waits for its turn), ``no_dq`` (neither the dQ
product nor its sum nor its staging nor its reduce-add), ``no_dq_stage``
(at D = 128 and 160 the dQ product without its staging and reduce-add),
``no_p`` (P and dS without the exponential and the mask), ``ex2_as_fma``,
``stages2`` (a ring of two Q / dO stages instead of four at D = 64 and 80),
``stages_less`` (one Q / dO stage fewer at D = 64, 80, 128 and 160: 3, 2,
1), ``keys_outer`` (the blocks in the order of their key tiles over all
heads, the last first, instead of head by head).  Timed at qwen1.5-0.5b's
``[8,16,2048,64]``, zamba2-2.7b's ``[8,32,2048,80]``, qwen1.5-4b's
``[8,20,2048,128]`` and stablelm-12b's ``[8,32,2048,160]`` over 8 kv heads
(``chip_smoke.path_flash``).
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

SOFTMAX = ("auto softmax = [&](float (&sacc)[NT][4], int i, "
           "float (&alpha)[2]) {")
PV = ("wgmma_rs_n64(oa[f], pf[kk],", "wgmma_rs_narrow<DB>(ob, pf[kk],")
QK = ("wgmma_s<BK>(\n                sacc, wg_desc(qa",
      "wgmma_s<BK>(sacc,\n                        wg_desc(qb")
# ex2 is defined in csrc/tma.cuh: the variant redefines its calls here
EX2 = '#include "tma.cuh"'
VARIANTS = ("base", "loads_only", "no_softmax", "ex2_as_fma", "stages5")


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
        return _replace(src, EX2,
                        EX2 + "\n#define ex2(x) fmaf((x), 0.001f, 1.f)")
    if name == "stages5":
        return _replace(src, "return d <= 80 ? 4 :", "return d <= 80 ? 5 :")
    raise ValueError(f"unknown variant {name!r}")


BWD_ATOMICS = ("    if (turn > 0) {\n      int seen = 0;",
               "    asm volatile(\n        \"cp.reduce.async.bulk")
BWD_DQ = ("wgmma_ss_n64<1, 1>(dq,", "wgmma_ss_narrow<DB, 1, 1>(dqb,",
          "wgmma_ss_n64<1, 1>(\n            dq[f],",
          "wgmma_ss_narrow<CS::DB, 1, 1>(\n            dqn,")
BWD_EXCHANGE = ("    const int buf = it & 1;\n",
                "if (threadIdx.x == 288)\n      dq_write<2>")
# the split-D bodies' dQ staging (in their tile loops) and their writers
BWD_STAGE = ("    const uint32_t xq_addr = sDQ + W * ",
             "if (threadIdx.x == 288 || threadIdx.x == 320) {")
BWD_MASK = "if (need_mask) {"
BWD_ORDER = ("const int kt = block_key_tile(), kvh = blockIdx.y, "
             "b = blockIdx.z;",
             "const dim3 grid((p.Skv + PL::BK - 1) / PL::BK, p.Hkv, p.B);")
# P's exponential; the second as older copies of the source have it (--src)
BWD_P = ("const float pv = ex2(fmaf(st[j][e], scale2, -ld.x));",
         "const float pv = ex2(fmaf(st[j][e], scale2, -l2[c]));")
BWD_STAGES = "STAGES = D <= 80 ? 4 : D <= 128 ? 3 : D <= 160 ? 2 : 1;"
BWD_VARIANTS = ("base", "no_dq_atomics", "no_dq", "no_dq_stage", "no_p",
                "ex2_as_fma", "stages2", "stages_less", "keys_outer")


def bwd_variant_source(src: str, name: str) -> str:
    """The backward source of variant ``name``."""
    if name == "base":
        return src
    if name == "no_dq_atomics":  # no turn waited for, nothing added
        s = _replace(src, BWD_ATOMICS[0], BWD_ATOMICS[0].replace(
            "turn > 0", "turn > 0 && p.Sq < 0"))
        return _replace(s, BWD_ATOMICS[1], "    if (p.Sq < 0) " +
                        BWD_ATOMICS[1].lstrip())
    if name == "no_dq":  # no product, no exchange or staging, no writer
        s = bwd_variant_source(src, "no_dq_stage")
        for old in BWD_DQ:
            s = _replace(s, old, "if (kk < 0) " + old)
        s = _replace(s, BWD_EXCHANGE[0],
                     BWD_EXCHANGE[0] + "    if (p.Sq > 0) continue;\n")
        return _replace(s, BWD_EXCHANGE[1], BWD_EXCHANGE[1].replace(
            "288)", "288 && p.Sq < 0)"))
    if name == "no_dq_stage":  # split-D: dQ formed, never staged or added
        s = _replace(src, BWD_STAGE[0],
                     "    if (p.Sq > 0) continue;\n" + BWD_STAGE[0])
        return _replace(s, BWD_STAGE[1], "if ((threadIdx.x == 288 || "
                        "threadIdx.x == 320) && p.Sq < 0) {")
    if name == "no_p":  # P = S, dS = S o (dP - delta): no ex2, no mask
        s = _replace(src, BWD_MASK, "if (need_mask && p.Sq < 0) {")
        old = next((o for o in BWD_P if o in s), BWD_P[0])
        return _replace(s, old, "const float pv = st[j][e];")
    if name == "ex2_as_fma":
        return variant_source(src, name)
    if name == "stages2":
        return _replace(src, "STAGES = D <= 80 ? 4 :", "STAGES = D <= 80 ? 2 :")
    if name == "stages_less":
        return _replace(src, BWD_STAGES,
                        "STAGES = D <= 80 ? 3 : D <= 128 ? 2 : 1;")
    if name == "keys_outer":  # the key tiles of every head first, then the next
        s = _replace(src, BWD_ORDER[0], "const int kvh = blockIdx.x, "
                     "b = blockIdx.y, kt = gridDim.z - 1 - blockIdx.z;")
        return _replace(s, BWD_ORDER[1], "const dim3 grid(p.Hkv, p.B, "
                        "(p.Skv + PL::BK - 1) / PL::BK);")
    raise ValueError(f"unknown variant {name!r}")


def build(names, source="flash_attention", make=variant_source,
          src_path=None) -> dict:
    src = Path(src_path or _build.CSRC / f"{source}.cu").read_text()
    return _build.build_variants(
        source, {name: make(src, name) for name in names})


def main_bwd(names, src_path=None) -> None:
    libs = build(names, "flash_attention_bwd", bwd_variant_source, src_path)
    print(cs.device_line(), flush=True)
    if src_path:
        print(json.dumps({"src": str(src_path)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    wide = dict(cs.path_flash())
    for shape, m in (("d64", cs.FLASH_MAIN), ("d80", cs.FLASH_D80),
                     ("d128 qwen1.5-4b", wide["qwen1.5-4b"]),
                     ("d160 stablelm-12b", wide["stablelm-12b"])):
        q, k, v = cs.flash_inputs(m["b"], m["hq"], m["hkv"], m["s"], m["d"],
                                  torch.bfloat16, gen, views=True)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=m["hq"] != m["hkv"])
        res = {"shape": shape, "sdpa_bwd_ms": cs.time_ms(
            lambda: torch.autograd.grad(sdpa, (qs, ks, vs), do,
                                        retain_graph=True), 20, 3)}
        for name, path in libs.items():
            _build._libs["flash_attention_bwd"] = ctypes.CDLL(str(path))
            res[name] = cs.time_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 20, 3)
        _build._libs.pop("flash_attention_bwd", None)
        print(json.dumps(res), flush=True)
        del q, k, v, o, lse, do, qs, ks, vs, sdpa


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs an NVIDIA GPU")
    args = sys.argv[1:]
    if args[:1] == ["--bwd"]:
        args, src_path = args[1:], None
        if "--src" in args:
            i = args.index("--src")
            src_path = args[i + 1]
            del args[i:i + 2]
        main_bwd(args or BWD_VARIANTS, src_path)
        return
    names = args or VARIANTS
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
