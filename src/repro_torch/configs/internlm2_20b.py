"""InternLM2-20B — dense GQA transformer [arXiv:2403.17297].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    microbatch=1,   # per data-shard microbatch rows
    sub_quadratic=False,
)
