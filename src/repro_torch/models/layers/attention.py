"""GQA attention over the paged KV pool, ported from
``repro.models.layers.attention``.

Only the paged path exists in this slice: every call writes its new K/V
into the layer's block pool and attends through the block table.

* ``Sq == 1`` (a decode step) goes to ``kernels.ops.paged_attention``:
  the CUDA kernel on the card, its plain version on the CPU.  The layers
  run as a Python loop, so ``is_global`` is a plain bool and the window is
  a run-time argument of the kernel (4096 on gemma2's local layers, none on
  its global ones).  The JAX package instead scans its layers with
  ``is_global`` traced, which keeps its TPU kernel gated off for windowed
  models; that changes how attention is dispatched, not what it computes.
* ``Sq > 1`` (a chunked-prefill chunk) gathers the logical K/V view and
  runs the plain masked attention, as the JAX package does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers.basic import apply_rope, rmsnorm, rope_tables

NEG_INF = -2.0e38


def _mask(qpos, kpos, *, window):
    """qpos [B,Sq], kpos [B,Skv] -> bool [B,Sq,Skv] (True = attendable):
    causal, inside ``window`` when set, and ``kpos >= 0`` (-1 marks an
    unwritten or unbacked slot)."""
    q = qpos[:, :, None]
    k = kpos[:, None, :]
    m = (k <= q) & (k >= 0)
    if window is not None:
        m &= (q - k) < window
    return m


def attend(q, k, v, qpos, kpos, *, scale, window=None, cap=None):
    """Masked attention.  q [B,Sq,H,D]; k,v [B,Skv,KH,D] -> [B,Sq,H,D]."""
    H, KH = q.shape[2], k.shape[2]
    if KH != H:                       # GQA: broadcast kv heads over groups
        k = torch.repeat_interleave(k, H // KH, dim=2)
        v = torch.repeat_interleave(v, H // KH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    m = _mask(qpos, kpos, window=window)
    s = torch.where(m[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _project_q(p, x, cfg):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_kv(p, x, cfg):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def paged_write(pool_k, pool_v, k_new, v_new, block_tables, write_pos):
    """Write ``Sq`` new tokens per row into one layer's pool, in place.

    pool_k/pool_v  [n_blocks + 1, bs, KH, hd]: the pool plus one trash page
                   at index n_blocks
    k_new, v_new   [B, Sq, KH, hd]
    block_tables   [B, NB] int32 (-1 = unbacked)
    write_pos      [B] first write position; may be negative (left-padded
                   prefill chunks, inactive rows at -1)

    JAX's ``.at[].set(mode="drop")`` drops writes at negative positions or
    into unbacked blocks.  Here they are routed to the trash page, so the
    scatter needs no data-dependent filtering (a boolean mask would cost a
    host sync on the card).  The update is in place in the preallocated
    pool: this stands in for JAX's buffer donation.
    """
    n_blocks, bs = pool_k.shape[0] - 1, pool_k.shape[1]
    B, Sq, KH, hd = k_new.shape
    NB = block_tables.shape[1]
    pos = write_pos.long()[:, None] + torch.arange(Sq, device=k_new.device)
    bt = block_tables.long()
    blk = torch.gather(bt, 1, torch.clamp(pos // bs, 0, NB - 1))
    phys = torch.where((pos >= 0) & (blk >= 0), blk * bs + pos % bs,
                       n_blocks * bs).reshape(-1)
    for pool, new in ((pool_k, k_new), (pool_v, v_new)):
        flat = pool.view((n_blocks + 1) * bs, KH, hd)
        flat[phys] = new.reshape(B * Sq, KH, hd).to(pool.dtype)


def paged_gather(pool, block_tables, write_pos, Sq):
    """The logical per-row view of one layer's pool after a write:
    (kv [B, L, KH, hd], kpos [B, L]) with L = NB * bs and kpos = -1 on
    slots that are unbacked or past the last written position."""
    bs = pool.shape[1]
    NB = block_tables.shape[1]
    lslot = torch.arange(NB * bs, device=pool.device)
    page = block_tables.long()[:, lslot // bs]                 # [B, L]
    idx = torch.where(page >= 0, page * bs + (lslot % bs)[None], 0)
    written = (page >= 0) & (lslot[None] <= write_pos.long()[:, None] + Sq - 1)
    kv = pool.reshape(-1, *pool.shape[2:])[idx]
    return kv, torch.where(written, lslot[None], -1)


def attention(p, x, *, cfg, positions, is_global: bool, pool_k, pool_v,
              write_pos, block_tables, paged_fn=None):
    """One paged attention layer.

    x             [B,Sq,D] layer input (post-norm)
    positions     [B,Sq] absolute positions of the tokens
    is_global     plain bool; local layers use ``cfg.window``
    pool_k/v      this layer's pool [n_blocks + 1, bs, KH, hd] (trash page
                  last), written in place
    write_pos     [B] int32 position of each row's first new token
    block_tables  [B,NB] int32
    paged_fn      the decode-attention function for ``Sq == 1`` (default
                  ``kernels.ops.paged_attention``); a check can pass the
                  plain version to compare the kernel inside the model
    Returns out [B,Sq,D].
    """
    cdt = x.dtype
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    scale = hd ** -0.5
    window = None if is_global else cfg.window

    q = _project_q(p, x, cfg)
    sin, cos = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new, v_new = _project_kv(p, x, cfg)
    k_new = apply_rope(k_new, sin, cos)
    paged_write(pool_k, pool_v, k_new, v_new, block_tables, write_pos)

    n_blocks = pool_k.shape[0] - 1
    if Sq == 1:
        fn = paged_fn or kops.paged_attention
        out_h = fn(q[:, 0].contiguous(), pool_k[:n_blocks], pool_v[:n_blocks],
                   block_tables, write_pos + 1, scale=scale, window=window,
                   softcap=cfg.attn_softcap)[:, None]
    else:
        k, kpos = paged_gather(pool_k[:n_blocks], block_tables, write_pos, Sq)
        v, _ = paged_gather(pool_v[:n_blocks], block_tables, write_pos, Sq)
        out_h = attend(q, k.to(cdt), v.to(cdt), positions, kpos, scale=scale,
                       window=window, cap=cfg.attn_softcap)
    out_h = out_h.reshape(B, Sq, cfg.n_heads * hd)
    return torch.matmul(out_h, p["wo"].to(cdt).reshape(cfg.n_heads * hd, -1))
