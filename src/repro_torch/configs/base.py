"""Config schema for the PyTorch port: a field-for-field copy of
``repro.configs.base`` so a config built in either package describes the
same model (the port imports nothing of ``repro``).

Every assigned architecture is described by a frozen ``ModelCfg``; the four
assigned input-shape cells are ``ShapeCell`` instances.  Configs are pure data
(hashable, JSON-dumpable) so they can cross process boundaries for the
dry-run launcher.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_k_dense: int = 0          # leading dense-FFN layers (deepseek-v2: 1)
    capacity_factor: float = 1.0
    router_aux_coef: float = 1e-2
    router_z_coef: float = 1e-3


@dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    """Mamba-style selective-SSM mixer (used by hymba's parallel SSM heads)."""
    state_dim: int = 16
    conv_width: int = 4
    dt_rank: int = 64
    head_dim: int = 64              # ssm heads = d_inner // head_dim


@dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64            # lora rank for data-dependent decay w
    mix_lora: int = 32              # lora rank for data-dependent token-shift


@dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int
    n_dec_layers: int


@dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention flavour ---------------------------------------------------
    attn_impl: str = "gqa"          # gqa | mla | none
    rope_theta: float = 10000.0
    window: Optional[int] = None    # sliding-window width for local layers
    layer_pattern: Optional[str] = None   # e.g. "LLLLLG" tiled over layers
    global_layers: Tuple[int, ...] = ()   # explicit global-attn layer indices
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    qk_norm: bool = False
    mla: Optional[MLACfg] = None
    # --- mixture of experts --------------------------------------------------
    moe: Optional[MoECfg] = None
    # --- recurrent families --------------------------------------------------
    ssm: Optional[SSMCfg] = None    # hybrid: parallel attn+ssm heads per layer
    rwkv: Optional[RWKVCfg] = None  # attn-free rwkv6 time-mix
    # --- encoder-decoder -----------------------------------------------------
    encdec: Optional[EncDecCfg] = None
    # --- modality frontends (STUBS per task: precomputed embeddings) ---------
    frontend: Optional[str] = None  # vision | audio
    n_prefix_embeds: int = 0        # patches/frames prepended in train shape
    meta_tokens: int = 0            # hymba learnable memory registers
    # --- misc ------------------------------------------------------------------
    tie_embeddings: bool = True
    post_norms: bool = False        # gemma-style post-attn/post-mlp RMSNorms
    scale_embeds: bool = False      # gemma-style sqrt(d_model) embed scaling
    norm_eps: float = 1e-6
    act: str = "silu"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"        # adamw | adafactor
    microbatch: int = 2             # PER-DATA-SHARD microbatch rows (grad accum)
    attn_chunk: int = 512           # query-chunk for memory-efficient attention
    use_pallas: bool = False        # TPU hot path (ref jnp path used for dry-run)
    # --- beyond-paper performance plan (OFF for the faithful baseline) -------
    head_pad_multiple: int = 0      # pad Q heads to a TP-divisible count
    scatter_cache_update: bool = False  # scatter (not vmapped DUS) cache writes
    cast_params_once: bool = False  # hoist f32->bf16 casts out of accum loop
    remat_policy: str = "nothing"   # nothing | save_attn (keep attn outputs)
    moe_impl: str = "gather"        # gather (AG expert outputs) | shard (EP psum)
    sub_quadratic: bool = False     # arch supports long_500k decode state
    notes: str = ""

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab padded to a multiple of 128 so the
        vocab axis shards evenly (Megatron-style); pad logits are masked to
        -1e9, so softmax/argmax semantics are unchanged."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def padded_heads(self) -> int:
        """Q-head count after optional TP padding (== n_heads when off)."""
        m = self.head_pad_multiple
        if m and self.n_heads % m:
            return ((self.n_heads + m - 1) // m) * m
        return self.n_heads

    def kv_head_map(self):
        """Static q-head -> kv-head index map honouring the ORIGINAL GQA
        grouping (padding must not reshuffle real heads across kv groups).
        Dead (padded) heads map to group 0 and are masked after attention."""
        if self.n_kv_heads <= 0:
            return None
        qpk = max(self.n_heads // self.n_kv_heads, 1)
        real = [min(h // qpk, self.n_kv_heads - 1)
                for h in range(self.n_heads)]
        return tuple(real + [0] * (self.padded_heads - self.n_heads))

    def layer_is_global(self, idx: int) -> bool:
        """True if layer `idx` uses global (full) attention."""
        if self.window is None:
            return True
        if self.global_layers:
            return idx in self.global_layers
        if self.layer_pattern:
            return self.layer_pattern[idx % len(self.layer_pattern)] == "G"
        return True

    def global_layer_mask(self) -> Tuple[bool, ...]:
        n = self.encdec.n_dec_layers if self.encdec else self.n_layers
        return tuple(self.layer_is_global(i) for i in range(n))

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_CELLS = {
    "train_4k":    ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeCell("long_500k", "decode", 524288, 1),
}


def reduced(cfg: ModelCfg, **overrides) -> ModelCfg:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        microbatch=2,
        attn_chunk=8,
        meta_tokens=4 if cfg.meta_tokens else 0,
        n_prefix_embeds=4 if cfg.n_prefix_embeds else 0,
        global_layers=(0,) if cfg.global_layers else (),
        window=8 if cfg.window else None,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32,
            n_shared=min(cfg.moe.n_shared, 1), first_k_dense=cfg.moe.first_k_dense)
    if cfg.mla:
        kw["mla"] = MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                           qk_rope_dim=8, v_head_dim=16)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=4, dt_rank=8, head_dim=16)
    if cfg.rwkv:
        kw["rwkv"] = RWKVCfg(head_dim=16, decay_lora=8, mix_lora=4)
    if cfg.encdec:
        kw["encdec"] = EncDecCfg(n_enc_layers=2, n_dec_layers=2)
    kw.update(overrides)
    return cfg.replace(**kw)
