"""DeepSeek-V2-236B — MLA + fine-grained MoE [arXiv:2405.04434].

60L d_model=5120 128H d_ff_expert=1536 vocab=102400; MLA kv_lora=512
(q_lora=1536, 128 nope + 64 rope qk dims, v=128); 2 shared + 160 routed
experts top-6; first layer is a dense FFN (d_ff=12288).
"""
from repro_torch.configs.base import MLACfg, ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,            # MLA: effectively MHA over the compressed cache
    head_dim=128,
    d_ff=12288,                # dense-FFN width (first layer)
    vocab_size=102400,
    attn_impl="mla",
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
               qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
               first_k_dense=1, capacity_factor=1.0),
    rope_theta=10000.0,
    tie_embeddings=False,
    optimizer="adafactor",     # memory-lean optimizer so 236B fits one v5e pod
    microbatch=1,   # per data-shard microbatch rows
    sub_quadratic=False,       # MLA narrows the cache but still scores all positions
)
