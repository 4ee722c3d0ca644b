"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H d_ff=2048(expert) vocab=129280 [arXiv:2412.19437].
First 3 layers dense (d_ff 18432); MLA q_lora 1536 / kv_lora 512 /
qk 128+64 rope / v 128; one MTP head.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,              # MLA: KV latent shared; kv=128 per assignment
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048,
        n_shared_experts=1, first_dense_layers=3, d_ff_dense=18432,
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
)
