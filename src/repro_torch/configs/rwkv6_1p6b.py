"""RWKV6 (Finch) 1.6B — attention-free, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536; 32 wkv heads of dim 64; O(1) decode
state (per-head 64x64 matrix + token-shift buffers).
"""
from repro_torch.configs.base import ModelCfg, RWKVCfg

CONFIG = ModelCfg(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                # wkv heads = d_model / head_dim
    n_kv_heads=0,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attn_impl="none",
    rwkv=RWKVCfg(head_dim=64, decay_lora=64, mix_lora=32),
    tie_embeddings=False,
    microbatch=4,   # per data-shard microbatch rows
    sub_quadratic=True,        # constant-size recurrent state
)
