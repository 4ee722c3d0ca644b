"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242].  Two shared attn+MLP blocks alternate every 6 layers.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(state_size=64, head_dim=64, expand=2, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, n_shared_attn_blocks=2),
)
