"""mamba2-1.3b [ssm]: attention-free SSD (state-space duality).

48L d_model=2048 vocab=50280 ssm_state=128 [arXiv:2405.21060].
d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,                   # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    gated_mlp=False,
    ssm=SSMConfig(state_size=128, head_dim=64, expand=2, chunk_size=256),
)
