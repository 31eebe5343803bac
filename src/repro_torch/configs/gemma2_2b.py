"""Gemma2-2B — dense, alternating local/global attention, softcaps [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; window 4096 on local
(odd) layers; attention logit softcap 50, final logit softcap 30.
"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    window=4096,
    layer_pattern="LG",          # alternating local / global
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    scale_embeds=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    act="gelu",
    microbatch=4,   # per data-shard microbatch rows
    sub_quadratic=True,
    notes="long_500k runs: half the layers are 4k-window local",
)
