"""pixtral-12b [vlm]: Pixtral-ViT frontend stubbed; Mistral-NeMo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409].  Patch embeddings arrive precomputed.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,               # NeMo-style fixed head dim (32*128 != d_model)
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    frontend="vision_stub",
    frontend_seq=1024,          # 1024 image patches prepended
)
