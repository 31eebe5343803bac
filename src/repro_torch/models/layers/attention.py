"""GQA attention, ported from ``repro.models.layers.attention``: the
uncached prefill (and hymba's train-mode forward), the dense slot cache
and the paged KV pool.

* **Uncached prefill** (``cache=None``): project, rope Q and K, and attend
  through ``kernels.ops.flash_attention`` (the CUDA kernel on the card,
  its plain version on the CPU), causal, with the layer's window and the
  attention softcap.  Returns rope'd K and raw V as the layer's cache.
  With meta tokens (hymba) it runs the plain query-chunked ``attend``
  instead, the tokens attendable from every query (sinks), as the
  reference does.
* **Dense slot cache** (``cache={'k','v': [B, Smax, KH, hd]}``): write the
  new K/V at ``write_pos`` in place, clamped as ``dynamic_update_slice``
  clamps, then the plain masked ``attend``, hymba's meta tokens (the
  cache's first slots) attendable outside the window; the JAX package
  runs no kernel here either.
* **Paged pool** (``block_tables`` given): every call writes its new K/V
  into the layer's block pool.  ``Sq == 1`` (a decode step) goes to
  ``kernels.ops.paged_attention``; ``Sq > 1`` (a chunked-prefill chunk)
  gathers the logical K/V view and runs the plain masked attention, as the
  JAX package does.

The layers run as a Python loop, so ``is_global`` is a plain bool and the
window is a run-time argument of both kernels (4096 on gemma2's local
layers, none on its global ones).  The JAX package instead scans its
layers with ``is_global`` traced, which keeps its TPU kernels gated off for
windowed models; that changes how attention is dispatched, not what it
computes.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers.basic import apply_rope, rmsnorm, rope_tables

NEG_INF = -2.0e38


def _mask(qpos, kpos, *, window, n_sink=0):
    """qpos [B,Sq], kpos [B,Skv] -> bool [B,Sq,Skv] (True = attendable):
    causal, inside ``window`` when set (the first ``n_sink`` positions,
    hymba's meta tokens, stay attendable outside it), and ``kpos >= 0``
    (-1 marks an unwritten or unbacked slot)."""
    q = qpos[:, :, None]
    k = kpos[:, None, :]
    m = (k <= q) & (k >= 0)
    if window is not None:
        inside = (q - k) < window
        if n_sink:
            inside |= k < n_sink
        m &= inside
    return m


def _pick_chunk(sq: int, chunk: int):
    """(chunk used, padded length): an exact divisor of ``sq`` in
    ``[chunk/2, chunk]`` where there is one, else ``chunk`` with ``sq``
    padded up to a multiple of it (``repro``'s ``_pick_chunk``)."""
    if sq % chunk == 0:
        return chunk, sq
    for c in range(chunk, chunk // 2 - 1, -1):
        if sq % c == 0:
            return c, sq
    return chunk, -(-sq // chunk) * chunk


def attend(q, k, v, qpos, kpos, *, scale, window=None, n_sink=0, cap=None,
           chunk=None):
    """Masked attention.  q [B,Sq,H,D]; k,v [B,Skv,KH,D] -> [B,Sq,H,D].

    With ``chunk`` the queries run in chunks of about that many rows, as
    the reference's query-chunked ``attend`` runs them, so the f32 scores
    are [chunk, Skv] at a time; padded query rows sit at position -2^30,
    attend nowhere and are sliced off."""
    H, KH = q.shape[2], k.shape[2]
    if KH != H:                       # GQA: broadcast kv heads over groups
        k = torch.repeat_interleave(k, H // KH, dim=2)
        v = torch.repeat_interleave(v, H // KH, dim=2)
    Sq = q.shape[1]
    if chunk is None or Sq <= chunk:
        return _attend_chunk(q, k, v, qpos, kpos, scale=scale, window=window,
                             n_sink=n_sink, cap=cap)
    c, padded = _pick_chunk(Sq, chunk)
    if padded != Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, padded - Sq))
        qpos = F.pad(qpos, (0, padded - Sq), value=-(2 ** 30))
    out = torch.cat([
        _attend_chunk(q[:, i:i + c], k, v, qpos[:, i:i + c], kpos,
                      scale=scale, window=window, n_sink=n_sink, cap=cap)
        for i in range(0, padded, c)], dim=1)
    return out[:, :Sq]


def _attend_chunk(q, k, v, qpos, kpos, *, scale, window, n_sink, cap):
    """One chunk of queries over all keys, k and v already [B,Skv,H,D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    m = _mask(qpos, kpos, window=window, n_sink=n_sink)
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


def dense_write(cache_k, cache_v, k_new, v_new, write_pos):
    """Write ``Sq`` new tokens per row into one layer's slot cache
    ``[B, Smax, KH, hd]``, in place (standing in for JAX's donation).

    Each row's start is clamped to ``[0, Smax - Sq]``, as
    ``lax.dynamic_update_slice`` clamps it: a free slot whose position has
    run past ``max_len`` writes into its own last slot instead of indexing
    past the end (which raises on the CPU and asserts on the card)."""
    B, Sq = k_new.shape[:2]
    start = torch.clamp(write_pos.long(), 0, cache_k.shape[1] - Sq)
    rows = torch.arange(B, device=k_new.device)[:, None]
    cols = start[:, None] + torch.arange(Sq, device=k_new.device)[None]
    cache_k[rows, cols] = k_new.to(cache_k.dtype)
    cache_v[rows, cols] = v_new.to(cache_v.dtype)


def attention(p, x, *, cfg, positions, is_global: bool, cache=None,
              write_pos=None, block_tables=None, paged_fn=None,
              flash_fn=None, pre_output=False):
    """One attention layer.

    x             [B,Sq,D] layer input (post-norm)
    positions     [B,Sq] absolute positions of the tokens
    is_global     plain bool; local layers use ``cfg.window``
    cache         None (uncached prefill); this layer's slot cache
                  {'k','v': [B, Smax, KH, hd]}; or, with ``block_tables``,
                  its pool {'k','v': [n_blocks + 1, bs, KH, hd]} (trash
                  page last).  Caches are written in place.
    write_pos     [B] int32 position of each row's first new token
    block_tables  [B,NB] int32 (paged pool only)
    paged_fn      the decode attention for a paged ``Sq == 1`` call
                  (default ``kernels.ops.paged_attention``)
    flash_fn      the prefill attention (default
                  ``kernels.ops.flash_attention``); a check can pass either
                  plain version to compare a kernel inside the model
    pre_output    return the heads' outputs [B,Sq,H*hd] before ``wo``
                  (hymba fuses them with its SSM path first)
    Returns (out [B,Sq,D], new_kv): the prefill's {'k': rope'd K,
    'v': V} [B,Sq,KH,hd], None for the cached paths.
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

    new_kv = None
    if cache is None and cfg.meta_tokens:
        out_h = attend(q, k_new, v_new, positions, positions, scale=scale,
                       window=window, n_sink=cfg.meta_tokens,
                       cap=cfg.attn_softcap, chunk=cfg.attn_chunk)
        new_kv = {"k": k_new, "v": v_new}
    elif cache is None:
        # tuned=True: the default kernel resolves its launch config from
        # the installed autotuner's cache (the engines install theirs
        # around each step); without one the defaults launch
        fn = flash_fn or functools.partial(kops.flash_attention, tuned=True)
        out_h = fn(q.contiguous(), k_new.contiguous(), v_new.contiguous(),
                   causal=True, window=window, softcap=cfg.attn_softcap,
                   scale=scale)
        new_kv = {"k": k_new, "v": v_new}
    elif block_tables is None:
        dense_write(cache["k"], cache["v"], k_new, v_new, write_pos)
        Smax = cache["k"].shape[1]
        slot = torch.arange(Smax, device=x.device)[None]
        # slots past the write head are unwritten -> kpos = -1 (masked)
        written = slot <= write_pos.long()[:, None] + Sq - 1
        out_h = attend(q, cache["k"].to(cdt), cache["v"].to(cdt), positions,
                       torch.where(written, slot, -1), scale=scale,
                       window=window, n_sink=cfg.meta_tokens,
                       cap=cfg.attn_softcap)
    else:
        pool_k, pool_v = cache["k"], cache["v"]
        paged_write(pool_k, pool_v, k_new, v_new, block_tables, write_pos)
        n_blocks = pool_k.shape[0] - 1
        if Sq == 1:
            # tuned=True: the chunk resolves from the installed tuning
            # cache, as the flash path's launch config does
            fn = paged_fn or functools.partial(kops.paged_attention,
                                               tuned=True)
            out_h = fn(q[:, 0].contiguous(), pool_k[:n_blocks],
                       pool_v[:n_blocks], block_tables, write_pos + 1,
                       scale=scale, window=window,
                       softcap=cfg.attn_softcap)[:, None]
        else:
            k, kpos = paged_gather(pool_k[:n_blocks], block_tables,
                                   write_pos, Sq)
            v, _ = paged_gather(pool_v[:n_blocks], block_tables, write_pos,
                                Sq)
            out_h = attend(q, k.to(cdt), v.to(cdt), positions, kpos,
                           scale=scale, window=window, cap=cfg.attn_softcap)
    out_h = out_h.reshape(B, Sq, cfg.n_heads * hd)
    if pre_output:
        return out_h, new_kv
    out = torch.matmul(out_h, p["wo"].to(cdt).reshape(cfg.n_heads * hd, -1))
    return out, new_kv


def init_kv_cache(cfg, batch, max_len, n_layers, device,
                  dtype=torch.bfloat16):
    """The dense slot cache: {'k','v': [n_layers, batch, max_len, KH, hd]}
    of zeros, bf16 whatever the compute dtype (as the JAX cache)."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
