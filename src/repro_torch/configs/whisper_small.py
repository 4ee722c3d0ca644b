"""whisper-small [audio]: enc-dec, conv frontend stubbed (precomputed frames).

12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865 [arXiv:2212.04356].
Backbone only — the caller feeds 1500 precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    gated_mlp=False,            # whisper uses plain GELU MLP
    qkv_bias=True,              # whisper attention has q/v bias
    enc_dec=EncDecConfig(n_encoder_layers=12, encoder_seq=1500),
    frontend="audio_stub",
    frontend_seq=1500,
)
