"""OLMoE-1B-7B — fully sparse MoE, 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (kv=16, MHA) d_ff_expert=1024 vocab=50304.
"""
from repro_torch.configs.base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024, n_shared=0,
               capacity_factor=1.0),
    qk_norm=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    microbatch=4,   # per data-shard microbatch rows
    sub_quadratic=False,
)
