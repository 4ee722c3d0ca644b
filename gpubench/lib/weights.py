"""The benchmark's own inputs: the model configuration as the port takes it,
weights and token batches made from ``--seed`` on the device.

From the port the benchmark reads only the names, shapes and types of its
parameter tree (built once on fake tensors); every value is the
benchmark's, drawn here leaf by leaf, each leaf from a generator seeded by
the run's seed and the leaf's index, so one leaf can be drawn again alone
(the reference and the training check do so).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import HybridConfig, SSMConfig

_NESTED = {"ssm": SSMConfig, "hybrid": HybridConfig}
MASK63 = (1 << 63) - 1


def arch_config(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` for a configuration file: the registry's
    entry for ``cfg["arch"]`` with every field the file gives put in;
    raises if a field the file gives does not come out as given."""
    base = get_config(cfg["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    kw = {}
    for key, value in cfg.items():
        if key not in fields:
            continue
        if key in _NESTED and value is not None:
            value = _NESTED[key](**value)
        kw[key] = value
    out = dataclasses.replace(base, **kw)
    for key, value in kw.items():
        if getattr(out, key) != value:
            raise ValueError(f"config field {key}: {getattr(out, key)!r} "
                             f"against {value!r}")
    return out


def mix(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any size."""
    h = 0x243F6A8885A308D3
    for p in parts:
        h = (h ^ (int(p) & ((1 << 64) - 1))) * 0x9E3779B97F4A7C15
        h = (h ^ (h >> 29)) & ((1 << 64) - 1)
    return h & MASK63


# --------------------------------------------------------------- the tree


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in the port's leaf order (dict insertion order, list
    order), paths dotted: ``blocks.mamba.w_in``, ``shared_attn.0.ln1``."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in flatten(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def unflatten(skeleton: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(skeleton, dict):
        return {k: unflatten(v, values, f"{prefix}{k}.")
                for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [unflatten(v, values, f"{prefix}{i}.")
                for i, v in enumerate(skeleton)]
    return values[prefix[:-1]]


@dataclasses.dataclass(frozen=True)
class Leaf:
    index: int
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype


def leaf_specs(model) -> Tuple[Any, List[Leaf]]:
    """The port's parameter tree as a skeleton of names and the leaves'
    shapes and types (fake tensors: no values, no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model.init(torch.Generator(device="cpu").manual_seed(0))
    leaves = [Leaf(i, path, tuple(t.shape), t.dtype)
              for i, (path, t) in enumerate(flatten(fake))]
    skeleton = unflatten(fake, {leaf.path: None for leaf in leaves})
    return skeleton, leaves


# ------------------------------------------------------------- the values

_MATRICES = {"embed", "lm_head", "w_in", "w_out", "w_q", "w_k", "w_v", "w_o",
             "w_up", "w_down", "w_gate", "conv_w"}
_SCALES = {"ln", "ln1", "ln2", "final_norm", "norm_scale"}


def draw(leaf: Leaf, seed: int, device) -> torch.Tensor:
    """Leaf ``leaf``'s values for ``seed``: matrices N(0, fan_in^-1) (the
    embedding N(0, 1), the depthwise conv N(0, 0.04)); norm scales and the
    conv bias N(0, 0.01); Mamba2's published init for ``A_log`` (A uniform
    in [1, 16]), ``dt_bias`` (the inverse softplus of dt log-uniform in
    [0.001, 0.1]) and ``D`` (one, plus N(0, 0.01)).  Raises for a leaf
    whose name has no rule: the port's tree changed."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, leaf.index))
    name = leaf.path.rsplit(".", 1)[-1]

    def randn(dtype=leaf.dtype):
        return torch.randn(leaf.shape, generator=gen, device=device,
                           dtype=dtype)

    def uniform(lo, hi):
        return torch.rand(leaf.shape, generator=gen, device=device,
                          dtype=torch.float32) * (hi - lo) + lo

    if name in _MATRICES:
        scale = (1.0 if name == "embed" else 0.2 if name == "conv_w"
                 else leaf.shape[-2] ** -0.5)
        return randn().mul_(scale)
    if name in _SCALES or name == "conv_b":
        return randn().mul_(0.1)
    if name == "A_log":
        return torch.log(uniform(1.0, 16.0)).to(leaf.dtype)
    if name == "dt_bias":
        dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
        return (dt + torch.log(-torch.expm1(-dt))).to(leaf.dtype)
    if name == "D":
        return (1.0 + 0.1 * randn(torch.float32)).to(leaf.dtype)
    raise KeyError(f"no value rule for the port's leaf {leaf.path!r}")


def make(model, seed: int, device) -> Tuple[Any, List[Leaf]]:
    """The whole tree for ``seed``, on ``device``."""
    skeleton, leaves = leaf_specs(model)
    values = {leaf.path: draw(leaf, seed, device) for leaf in leaves}
    return unflatten(skeleton, values), leaves


def tokens(seed: int, stream: int, rows: int, seq: int, vocab: int,
           device) -> torch.Tensor:
    """``[rows, seq]`` token ids for batch ``stream`` of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, 1 << 20,
                                                         stream))
    return torch.randint(0, vocab, (rows, seq), generator=gen, device=device)
