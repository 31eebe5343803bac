"""Yi-34B — llama-architecture dense GQA transformer [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    microbatch=1,   # per data-shard microbatch rows
    sub_quadratic=False,      # pure full attention → long_500k skipped
)
