"""SeamlessM4T-medium — encoder-decoder multimodal translator [arXiv:2308.11596].

12L d_model=1024 16H d_ff=4096 vocab=256206; modelled as the transformer
BACKBONE (12 encoder + 12 decoder layers with cross-attention).  The speech
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
[B, S_enc, d_model] for the encoder; the decoder consumes text tokens.
"""
from repro_torch.configs.base import EncDecCfg, ModelCfg

CONFIG = ModelCfg(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=24,               # 12 enc + 12 dec
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    encdec=EncDecCfg(n_enc_layers=12, n_dec_layers=12),
    frontend="audio",
    rope_theta=10000.0,
    tie_embeddings=True,
    microbatch=4,   # per data-shard microbatch rows
    sub_quadratic=False,
)
