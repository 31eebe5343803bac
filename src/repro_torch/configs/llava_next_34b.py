"""LLaVA-NeXT-34B — VLM: anyres vision tiles + 34B LM backbone
[hf:llava-hf/llava-v1.6-mistral-7b-hf family; 34B variant backbone = Yi-34B].

Backbone: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The vision tower is a STUB per the task spec: ``input_specs()`` provides
precomputed patch embeddings [B, n_patches, d_model] that are prepended to the
token sequence (anyres tiling = variable patch count; we fix the spec to the
5-tile 2x2+base grid = 5*576 = 2880 patches for prefill shapes, 576 for train).
"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    frontend="vision",
    n_prefix_embeds=576,       # base-resolution tile in the train shape
    tie_embeddings=False,
    microbatch=1,   # per data-shard microbatch rows
    sub_quadratic=False,
)
