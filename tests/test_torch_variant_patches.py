"""The ``tools/*_variants.py`` scripts patch a kernel's CUDA source as text.

Each variant replaces lines that must be in the source as they are; an edit
to those lines breaks the variant only when it is built on the card.  This
checks on the CPU that every variant a tool runs by default still applies
to the source in the checkout and changes it.
"""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.kernels import _build

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases():
    flash, ssd = _tool("flash_variants"), _tool("ssd_bwd_variants")
    mm, tsmm = _tool("matmul_variants"), _tool("tsmm_variants")
    groups = [
        ("flash_attention", flash.variant_source, flash.VARIANTS),
        ("flash_attention_bwd", flash.bwd_variant_source, flash.BWD_VARIANTS),
        ("ssd_scan_bwd", ssd.variant_source, ssd.VARIANTS),
        ("ssd_scan", ssd.fwd_variant_source, ssd.FWD_VARIANTS),
        ("matmul_epilogue", mm.variant_source,
         mm.VARIANTS + mm.SMALL_M_VARIANTS[1:] + ("sm_l2_256",)),
        ("tsmm", tsmm.variant_source, tsmm.VARIANTS),
    ]
    return [pytest.param(source, make, name, id=f"{source}-{name}")
            for source, make, names in groups for name in names]


@pytest.mark.parametrize("source,make,name", _cases())
def test_variant_applies(source, make, name):
    src = (_build.CSRC / f"{source}.cu").read_text()
    out = make(src, name)  # raises ValueError when a patched line is gone
    assert (out == src) == (name == "base")


def test_unknown_variant_raises():
    ssd = _tool("ssd_bwd_variants")
    with pytest.raises(ValueError):
        ssd.variant_source("", "no_such_variant")
    with pytest.raises(ValueError):
        ssd.fwd_variant_source("", "no_such_variant")
