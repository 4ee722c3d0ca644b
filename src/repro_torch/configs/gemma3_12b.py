"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144; 5:1 local:global attention, 128k context
[hf:google/gemma-3-12b-pt].

window_pattern encodes the 5 local (1024-window) : 1 global cycle; the layer
stack is a stack of such cycles (window None for the global layer).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_theta=1e6,
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),
    local_window=1024,
)
