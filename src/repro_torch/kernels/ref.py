"""Plain PyTorch versions of the paged-attention kernel: the oracle the
CUDA kernel is held against on the card, and what the wrapper runs for
tensors on the CPU.  Ports of ``repro.kernels.ref.gather_pages`` /
``paged_attention_ref`` plus the split-KV first pass and its merge."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def gather_pages(pages, block_tables):
    """Paged KV -> logical view.  pages [P,bs,KH,D]; block_tables [B,NB]
    (-1 = unbacked, gathered as page 0 and masked by the caller) ->
    [B, NB*bs, KH, D]."""
    P, bs = pages.shape[0], pages.shape[1]
    NB = block_tables.shape[1]
    lslot = torch.arange(NB * bs, dtype=torch.long, device=pages.device)
    page = block_tables.long()[:, lslot // bs]              # [B, NB*bs]
    idx = torch.where(page >= 0, page * bs + (lslot % bs)[None], 0)
    return pages.reshape((P * bs,) + tuple(pages.shape[2:]))[idx]


def _scores_and_valid(q, k_pages, v_pages, block_tables, context_lens, *,
                      scale, window, softcap):
    """f32 scores [B,H,L], GQA-expanded f32 values [B,L,H,D] and the
    validity mask [B,L] shared by the unsplit oracle and the split pass."""
    B, H, D = q.shape
    bs, KH = k_pages.shape[1], k_pages.shape[2]
    NB = block_tables.shape[1]
    k = gather_pages(k_pages, block_tables)                # [B, L, KH, D]
    v = gather_pages(v_pages, block_tables)
    if KH != H:
        k = torch.repeat_interleave(k, H // KH, dim=2)
        v = torch.repeat_interleave(v, H // KH, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    lslot = torch.arange(NB * bs, dtype=torch.long, device=q.device)[None]
    ctx = context_lens.long()[:, None]
    valid = (lslot < ctx) & (block_tables.long()[:, lslot[0] // bs] >= 0)
    if window is not None:
        valid &= (ctx - 1 - lslot) < window
    return s, v.float(), valid


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, *,
                        scale=None, window=None, softcap=None):
    """Single-token decode attention through a block table.  q [B,H,D];
    k/v_pages [P,bs,KH,D]; block_tables [B,NB]; context_lens [B] ->
    [B,H,D] (f32 accumulation, rows with ctx == 0 are zero)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s, v, valid = _scores_and_valid(q, k_pages, v_pages, block_tables,
                                    context_lens, scale=scale, window=window,
                                    softcap=softcap)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    out = torch.where((context_lens > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention_partials_ref(q, k_pages, v_pages, block_tables,
                                 context_lens, *, scale=None, window=None,
                                 softcap=None, num_splits=2):
    """The split-KV first pass: each sequence's valid pages cut into
    ``num_splits`` contiguous slices ``[s*pps, min((s+1)*pps, n_valid))``
    with ``pps = ceil(n_valid / num_splits)``; each slice yields its
    partial softmax row.  Returns m, l [B,H,S] and acc [B,H,S,D] (f32);
    an empty slice gives the identity partial (NEG_INF, 0, 0)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    bs = k_pages.shape[1]
    NB = block_tables.shape[1]
    s, v, valid = _scores_and_valid(q, k_pages, v_pages, block_tables,
                                    context_lens, scale=scale, window=window,
                                    softcap=softcap)
    ctx = context_lens.long().clamp(min=0)
    n_valid = torch.clamp((ctx + bs - 1) // bs, max=NB)
    pps = torch.clamp((n_valid + num_splits - 1) // num_splits, min=1)
    page = torch.arange(NB * bs, device=q.device) // bs      # [L]
    split = page[None] // pps[:, None]                       # [B, L]
    sid = torch.arange(num_splits, device=q.device)
    mask = valid[:, None, :] & (split[:, None, :] == sid[None, :, None])
    sm = torch.where(mask[:, None], s[:, :, None, :], NEG_INF)  # [B,H,S,L]
    m = sm.amax(dim=-1)
    p = torch.where(mask[:, None], torch.exp(sm - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhsk,bkhd->bhsd", p, v)
    return m, l, acc


def merge_partials(m, l, acc, out_dtype):
    """Second flash-decoding pass: fold per-split partial rows (m/l
    [B,H,S], acc [B,H,S,D]) with the log-sum-exp rescale.  Identity
    partials get weight exp(-huge) = 0; all-identity rows (ctx == 0)
    divide 0 by the 1e-30 floor and come out zero."""
    m_star = m.amax(dim=-1, keepdim=True)
    alpha = torch.exp(m - m_star)
    l_star = (l * alpha).sum(dim=-1)
    out = (acc * alpha[..., None]).sum(dim=2)
    return (out / torch.clamp(l_star, min=1e-30)[..., None]).to(out_dtype)


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens, *,
                          scale=None, window=None, softcap=None,
                          num_splits=1):
    """The plain version of the kernel wrapper: the unsplit oracle, or
    the split pass plus merge for ``num_splits > 1``."""
    if num_splits <= 1:
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, scale=scale, window=window,
                                   softcap=softcap)
    m, l, acc = paged_attention_partials_ref(
        q, k_pages, v_pages, block_tables, context_lens, scale=scale,
        window=window, softcap=softcap, num_splits=num_splits)
    return merge_partials(m, l, acc, q.dtype)
