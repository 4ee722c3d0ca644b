"""Model facade: ``build_model(cfg)`` -> init / loss / forward / prefill /
decode, and ``frontend_shape`` for the archs that take precomputed patch or
frame embeddings.

The single entry point the launcher, the serve engine, tests and examples
use; arch-specific wiring lives in transformer.py.  A model is bound to one
device: ``"cuda"`` unless the caller asks for the CPU, and building it raises
when that device is absent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def require_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a CUDA device and
    there is none (nothing falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU unless "
            "device='cpu' is passed")
    return dev


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    # ------------------------------------------------------------- params
    def init(self, seed: Union[int, torch.Generator] = 0) -> T.Params:
        """Random weights on the model's device, from a seed or from a
        ``torch.Generator`` that lives on that device."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return T.init_params(self.cfg, gen)

    # ------------------------------------------------------------ training
    def loss(self, params, batch, *, remat: str = "none",
             use_kernel: bool = False, capacity_factor=None):
        return T.loss_fn(self.cfg, params, batch, remat=remat,
                         use_kernel=use_kernel,
                         capacity_factor=capacity_factor)

    def forward(self, params, tokens, frontend=None, *, remat: str = "none",
                use_kernel: bool = False, capacity_factor=None):
        return T.forward(self.cfg, params, tokens, frontend, remat=remat,
                         use_kernel=use_kernel,
                         capacity_factor=capacity_factor)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int) -> T.Cache:
        return T.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params, tokens, cache, frontend=None, *,
                use_kernel: bool = False, capacity_factor=None):
        """Writes ``cache`` in place and returns it beside the logits."""
        return T.prefill(self.cfg, params, tokens, cache, frontend,
                         use_kernel=use_kernel,
                         capacity_factor=capacity_factor)

    def decode_step(self, params, token, cache, *, use_kernel: bool = False,
                    capacity_factor=None):
        """Writes ``cache`` in place and returns it beside the logits."""
        return T.decode_step(self.cfg, params, token, cache,
                             use_kernel=use_kernel,
                             capacity_factor=capacity_factor)

    # ------------------------------------------------------------- helpers
    def frontend_shape(self, batch: int) -> Optional[Tuple[int, ...]]:
        """The precomputed patch or frame embeddings a batch takes
        ``[B,F,d]``, or None for an arch without a frontend."""
        cfg = self.cfg
        if cfg.frontend == "none" or not cfg.frontend_seq:
            return None
        return (batch, cfg.frontend_seq, cfg.d_model)


def build_model(cfg: ArchConfig,
                device: Union[str, torch.device] = "cuda") -> Model:
    T.require_ported(cfg)
    return Model(cfg, require_device(device))
