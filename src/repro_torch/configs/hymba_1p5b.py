"""Hymba-1.5B — hybrid parallel attention+Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Parallel attn+mamba heads fused per layer; sliding-window attention in all but
3 global layers (first / middle / last, per the paper); 128 meta tokens.
"""
from repro_torch.configs.base import ModelCfg, SSMCfg

CONFIG = ModelCfg(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm=SSMCfg(state_dim=16, conv_width=4, dt_rank=100, head_dim=64),
    window=2048,
    global_layers=(0, 15, 31),
    meta_tokens=128,
    rope_theta=10000.0,
    microbatch=4,   # per data-shard microbatch rows
    sub_quadratic=True,       # SWA + SSM: bounded decode state
    notes="parallel attn+mamba heads, outputs mean-fused after per-path norm",
)
