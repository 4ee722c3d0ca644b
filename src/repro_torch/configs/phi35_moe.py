"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2 routing.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct].
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
)
