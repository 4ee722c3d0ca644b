"""qwen1.5-110b [dense]: 80L d_model=8192 64H (kv=8, GQA) d_ff=49152
vocab=152064 [hf:Qwen/Qwen1.5-110B].

The frontier-dense scenario: ~111B parameters is deliberately *past* what
tensor/FSDP sharding alone can fit on one or two pod slices (weights +
fp32 grads + Adam state blow the per-device HBM budget at every 2D role),
which is exactly the cell family pipeline parallelism opens — per-stage
resident state drops ~S-fold when the layer stack is split over a "pp"
axis (see ``repro.core.planner``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
)
