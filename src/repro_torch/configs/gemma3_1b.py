"""Gemma3-1B — dense, 5:1 local:global attention, 262k vocab [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144; sliding window 512 on
local layers, qk-norm, head_dim=256 (projection width independent of d_model).
"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    window=512,
    layer_pattern="LLLLLG",      # 5 local : 1 global
    qk_norm=True,
    post_norms=True,
    scale_embeds=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    act="gelu",
    microbatch=8,   # per data-shard microbatch rows
    sub_quadratic=True,          # local layers dominate → bounded-window state
    notes="long_500k runs: only the 1-in-6 global layers hold full-length KV",
)
