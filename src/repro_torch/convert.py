"""Carries the reference's parameter and cache trees over to the port.

The reference keeps its trees as pytrees of JAX arrays.  numpy has no
bfloat16, so the caller turns every floating leaf into a **float32 numpy
array** (integers stay integers) and hands the nested dicts over; the
functions here build the port's trees on a device.  Nothing here imports the
reference: the tests do the JAX side.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import torch_dtype

# leaves the reference keeps in fp32 whatever cfg.dtype says: norm scales
# (the encoder-decoder's ln_cross and enc_norm among them), the Mamba2
# block's A_log / D / dt_bias / norm_scale, the SSM cache's state, the MoE
# router (in bf16 it would route other tokens than the reference's), MLA's
# q_norm and kv_norm and the MTP head's norm
_FP32_LEAVES = ("ln1", "ln2", "ln", "ln_cross", "final_norm", "enc_norm",
                "A_log", "D", "dt_bias", "norm_scale", "state", "w_router",
                "q_norm", "kv_norm", "norm")


def _convert(tree: Any, name: str, device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, k, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):   # the hybrid's shared_attn, the cycles
        return [_convert(v, name, device, dtype) for v in tree]
    t = torch.tensor(np.asarray(tree), device=device)    # always a copy
    if t.is_floating_point():
        t = t.to(torch.float32 if name in _FP32_LEAVES else dtype)
    return t


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: Union[str, torch.device] = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's param tree (nested dicts of float32 numpy arrays, the
    layer stack with its leading layer axis) as the port's tree on ``device``:
    same keys and shapes (the encoder-decoder's ``enc_blocks``, ``enc_norm``
    and the decoder's ``cross`` among them), lists (the hybrid's
    ``shared_attn``, one block dict each; the window-pattern family's
    ``cycles``, one block dict a position of the pattern, each leaf with a
    leading cycle axis) kept as lists, the moe family's ``dense_blocks`` and
    ``blocks`` with their ``moe`` subtrees, the leaves the
    reference keeps in fp32 (norm scales, ``A_log``, ``D``, ``dt_bias``, the
    MoE router ``w_router``, MLA's ``q_norm`` and ``kv_norm``, the MTP
    head's ``norm``) in fp32, everything else in ``dtype`` (default
    ``cfg.dtype``)."""
    return _convert(tree, "", torch.device(device),
                    dtype or torch_dtype(cfg.dtype))


def cache_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                     device: Union[str, torch.device] = "cuda",
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's decode cache as the port's: ``pos`` becomes a host
    integer, ``k``/``v``, the encoder-decoder's ``cross_k``/``cross_v`` and
    the SSM's ``conv`` take ``dtype`` (default ``cfg.dtype``), the SSM's
    ``state`` stays fp32, ``kpos`` stays int32; the window-pattern family's
    ``p0`` ... ``p{period-1}`` and the moe family's ``dense`` and ``moe``
    groups come across as the other caches' ``self`` (with MLA, their
    ``ckv`` and ``krope`` in ``dtype``)."""
    out = _convert({k: v for k, v in tree.items() if k != "pos"}, "",
                   torch.device(device), dtype or torch_dtype(cfg.dtype))
    out["pos"] = int(np.asarray(tree["pos"]))
    return out
