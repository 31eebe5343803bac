"""Plain PyTorch versions of the CUDA kernels: the oracles each kernel is
held against on the card, and what the wrappers run for tensors on the
CPU.

* paged attention: ports of ``repro.kernels.ref.gather_pages`` /
  ``paged_attention_ref`` plus the split-KV first pass and its merge, and
  the CUDA kernel's partition into fixed token chunks;
* flash attention: ``flash_attention_ref`` (full softmax, a port of
  ``repro.kernels.ref.flash_attention_ref``) and ``flash_attention_plain``
  (the blocked online softmax of ``repro.kernels.flash_attention``, with
  its rounding points); its gradient in the two backward kernels'
  arithmetic, ``flash_attention_bwd_plain`` (CUDA-core, f32; with the
  forward's L, ``flash_lse_plain``, or recomputing it) beside
  ``flash_attention_bwd_split_plain`` (its parts' partials added in order)
  and ``flash_attention_bwd_mma_plain`` (tensor cores: L from the forward,
  P and dS rounded to bf16);
* the recurrences: ``wkv6_plain`` and ``ssm_scan_plain`` (ports of
  ``repro.kernels.ref``'s scans, with the dtypes of the Pallas kernels
  ``repro.kernels.wkv6`` and ``repro.kernels.ssm_scan``), each the zero
  start of ``wkv6_carry`` / ``ssm_scan_carry`` (a carried state in, the
  final state out: the models' prefill and decode recurrences);
* the paper's probes: ``alu_chain_plain`` over the 21-op table ``ALU_OPS``
  (a port of ``repro.core.microbench.harness.OPS``, with jnp's semantics:
  ``%`` is a floor-mod, ``popc``/``clz`` count the int32 bit pattern),
  ``pointer_chase_plain`` and ``mxu_probe_plain`` (ports of
  ``repro.kernels.ref.alu_chain_ref``, ``pointer_chase_ref`` and
  ``mxu_probe_ref``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -2.0e38
# accumulator dtype names accepted by flash attention's ``acc_dtype``
ACC_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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


def _partials(s, v, valid, part, n):
    """Partial softmax rows of the slots in each of ``n`` partitions: slot
    k of row b belongs to partition ``part[b, k]``.  Returns m, l [B,H,n]
    and acc [B,H,n,D] (f32); an empty partition gives the identity partial
    (NEG_INF, 0, 0)."""
    pid = torch.arange(n, device=s.device)
    mask = valid[:, None, :] & (part[:, None, :] == pid[None, :, None])
    sm = torch.where(mask[:, None], s[:, :, None, :], NEG_INF)  # [B,H,n,L]
    m = sm.amax(dim=-1)
    p = torch.where(mask[:, None], torch.exp(sm - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhsk,bkhd->bhsd", p, v)
    return m, l, acc


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
    return _partials(s, v, valid, page[None] // pps[:, None], num_splits)


def paged_attention_chunk_partials(q, k_pages, v_pages, block_tables,
                                   context_lens, *, scale=None, window=None,
                                   softcap=None, chunk_tokens=64):
    """The CUDA kernel's partition: every row's slots cut into fixed
    chunks of ``chunk_tokens`` tokens, ``ceil(NB*bs / chunk_tokens)`` of
    them whatever the context; each chunk yields its partial softmax row.
    Returns m, l [B,H,NC] and acc [B,H,NC,D] (f32); a chunk with no valid
    slot (past ctx, before the window, or all unbacked) gives the identity
    partial (NEG_INF, 0, 0)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    L = block_tables.shape[1] * k_pages.shape[1]
    s, v, valid = _scores_and_valid(q, k_pages, v_pages, block_tables,
                                    context_lens, scale=scale, window=window,
                                    softcap=softcap)
    chunk = torch.arange(L, device=q.device) // chunk_tokens
    return _partials(s, v, valid, chunk[None], -(-L // chunk_tokens))


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


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    """q [B,Sq,H,D]; k,v [B,Skv,KH,D] -> [B,Sq,H,D]: full softmax in f32,
    query i at position i and key j at position j (causal is top-left
    aligned), GQA by repeating KV heads."""
    D = q.shape[-1]
    H, KH = q.shape[2], k.shape[2]
    if KH != H:
        k = torch.repeat_interleave(k, H // KH, dim=2)
        v = torch.repeat_interleave(v, H // KH, dim=2)
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(q.shape[1], device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    m = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                   device=q.device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= (qi - ki) < window
    s = torch.where(m[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          scale=None, block_q=128, block_k=128,
                          acc_dtype="f32"):
    """The flash kernel's own arithmetic in plain torch: for each
    ``block_q`` query tile, an online softmax over ``block_k`` KV tiles.

    Ragged tails are padded to whole tiles; padded keys (position >= Skv)
    never attend and padded query rows are sliced off.  With ``causal``
    and no window, the tiles wholly above the diagonal are skipped, as in
    ``repro.kernels.flash_attention._fa_kernel``.  The running max ``m``,
    sum ``l`` and accumulator ``acc`` are kept in ``acc_dtype`` ("f32" or
    "bf16") and, for "bf16", rounded after every KV tile exactly where the
    Pallas kernel rounds them.  q [B,Sq,H,D]; k,v [B,Skv,KH,D] ->
    [B,Sq,H,D] in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    adt = ACC_DTYPES[acc_dtype]
    bq, bk = max(min(block_q, Sq), 1), max(min(block_k, Skv), 1)
    pad_q, pad_k = -Sq % bq, -Skv % bk
    # [B, KH, G, S, D]: query head h = kh * G + g reads KV head kh
    qf = F.pad(q.float(), (0, 0, 0, 0, 0, pad_q)) * scale
    qf = qf.reshape(B, Sq + pad_q, KH, G, D).permute(0, 2, 3, 1, 4)
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad_k)).permute(0, 2, 1, 3)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad_k)).permute(0, 2, 1, 3)
    n_k = (Skv + pad_k) // bk
    out = torch.empty_like(qf)
    for i in range((Sq + pad_q) // bq):
        qt = qf[:, :, :, i * bq:(i + 1) * bq]
        q_pos = i * bq + torch.arange(bq, device=q.device)
        m = torch.full(qt.shape[:-1], NEG_INF, dtype=adt, device=q.device)
        l = torch.zeros(qt.shape[:-1], dtype=adt, device=q.device)
        acc = torch.zeros(qt.shape, dtype=adt, device=q.device)
        upper = n_k
        if causal and window is None:
            upper = max(min(n_k, (i + 1) * bq // bk + (1 if bq % bk else 0)),
                        1)
        for j in range(upper):
            kt, vt = kf[:, :, j * bk:(j + 1) * bk], vf[:, :, j * bk:(j + 1) * bk]
            s = torch.einsum("bkgqd,bknd->bkgqn", qt, kt)
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            k_pos = j * bk + torch.arange(bk, device=q.device)
            mask = (k_pos < Skv)[None, :]
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1).to(adt))
            p = torch.exp(s - m_new.float()[..., None])
            alpha = torch.exp((m - m_new).float())
            l = l * alpha.to(adt) + p.sum(dim=-1).to(adt)
            acc = acc * alpha[..., None].to(adt) \
                + torch.einsum("bkgqn,bknd->bkgqd", p, vt).to(adt)
            m = m_new
        out[:, :, :, i * bq:(i + 1) * bq] = \
            acc.float() / torch.clamp(l.float(), min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq + pad_q, H, D)
    return out[:, :Sq].to(q.dtype)


def _flash_scores(q, k, *, causal, window, softcap, scale):
    """The flash backward's scores in f32 (f64 inputs stay f64): S [B, KH,
    G, Sq, Skv] (capped), tanh of the capped argument (None without a
    softcap) and the mask [Sq, Skv]; query head h = kh * G + g reads KV
    head kh."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc).reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(acc)) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= (qi - ki) < window
    return s, t, keep


def flash_lse_plain(q, k, *, causal=True, window=None, softcap=None,
                    scale=None):
    """The forward's row log-sum-exp, as ``csrc/flash_attention_mma.cu``
    and ``csrc/flash_attention.cu`` write it for the backward: L [B, H,
    Sq] in f32 (f64 stays f64) of the masked, capped scores, +inf for a
    row with no kept key (so that P = exp(S - L) = 0 there)."""
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s, _, keep = _flash_scores(q, k, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    lse = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1)
    lse = torch.where(keep.any(dim=-1), lse, torch.inf)
    return lse.reshape(B, H, Sq)


def _flash_bwd(q, k, v, out, d_out, lse, rnd, *, causal, window, softcap,
               scale):
    """The flash backward's arithmetic: L recomputed when ``lse`` is None,
    P and dS rounded to ``rnd`` before the products that read them when it
    is not None."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    # [B, Sq, KH, G, D]: query head h = kh * G + g reads KV head kh
    qf, of, gf = (t.to(acc).reshape(B, Sq, KH, G, D) for t in (q, out, d_out))
    kf, vf = k.to(acc), v.to(acc)
    s, t, keep = _flash_scores(q, k, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    if lse is None:
        lse = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1)
    else:
        lse = lse.to(acc).reshape(B, KH, G, Sq)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)

    def r(x):
        return x if rnd is None else x.to(rnd).to(acc)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", gf, of)
    dv = torch.einsum("bkgqs,bqkgd->bskd", r(p), gf)
    dp = torch.einsum("bqkgd,bskd->bkgqs", gf, vf)
    ds = p * (dp - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bkgqs,bskd->bqkgd", r(ds), kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", r(ds), qf) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_plain(q, k, v, out, d_out, lse=None, *,
                              causal=True, window=None, softcap=None,
                              scale=None):
    """The gradients of the flash forward, in the CUDA-core backward
    kernel's own arithmetic (``csrc/flash_attention_bwd.cu``), written out
    rather than taken by autograd.  q, out, d_out [B,Sq,H,D]; k,v
    [B,Skv,KH,D] -> (dq [B,Sq,H,D], dk, dv [B,Skv,KH,D]) in the inputs'
    dtype, every sum in f32 (f64 inputs stay f64).

    With S the capped score ``cap * tanh(scale q.k / cap)`` (the raw one
    without a softcap) under the forward's mask: the row log-sum-exp L is
    ``lse`` [B,H,Sq] (the forward's, as ``flash_lse_plain`` gives it;
    what the kernel reads) or, without it, recomputed from Q and K (the
    same values), P = exp(S - L) (0 where masked), D_i = sum_d dO.O,
    dV = P^T dO, dP = dO V^T, dS = P (dP - D), times 1 - (S / cap)^2 with
    a softcap, dQ = scale dS K, dK = scale dS^T Q; dK and dV sum over the
    query heads of each GQA group."""
    return _flash_bwd(q, k, v, out, d_out, lse, None, causal=causal,
                      window=window, softcap=softcap, scale=scale)


def _sum_in_order(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def flash_attention_bwd_split_plain(q, k, v, out, d_out, lse, work, *,
                                    causal=True, window=None, softcap=None,
                                    scale=None):
    """The CUDA-core backward's split in plain torch (f32; f64 stays
    f64), read from the schedule the kernels read: ``work`` is the
    wrapper's ``bwd_work`` of these shapes (tiles of ``work.T`` rows; per
    kernel a ``BwdTable`` of segments and shared units).  Each segment's
    product, as a block of ``csrc/flash_attention_bwd.cu`` forms it (dQ
    of a query tile and head over the segment's key tiles; dK and dV of a
    key tile and KV head over its (query head, query tile) steps, in step
    order), written where it is the whole unit, else kept as its partial;
    each shared unit's partials added in order, as the fold kernel adds
    them; then dQ and dK scaled.  P and dS are
    ``flash_attention_bwd_plain``'s with L given (``lse`` [B,H,Sq]).
    Returns (dq, dk, dv) in the inputs' dtype."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G, T = H // KH, work.T
    scale = scale if scale is not None else D ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, of, gf = (t.to(acc).reshape(B, Sq, KH, G, D) for t in (q, out, d_out))
    kf, vf = k.to(acc), v.to(acc)
    s, t, keep = _flash_scores(q, k, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    p = torch.where(keep, torch.exp(s - lse.to(acc).reshape(B, KH, G, Sq)
                                    [..., None]), 0.0)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", gf, of)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", gf, vf) - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.zeros((B, Sq, KH, G, D), dtype=acc, device=q.device)
    parts = [None] * work.dq.partials
    for i, b, h, lo, _, u, ue, dest in work.dq.segs.tolist():
        kh, g = divmod(h, G)
        rows, keys = slice(i * T, (i + 1) * T), slice((lo + u) * T,
                                                      (lo + ue) * T)
        x = ds[b, kh, g, rows, keys] @ kf[b, keys, kh]
        if dest < 0:
            dq[b, rows, kh, g] = x
        else:
            parts[dest] = x
    for i, b, h, p0, n in work.dq.folds.tolist():
        kh, g = divmod(h, G)
        dq[b, i * T:(i + 1) * T, kh, g] = _sum_in_order(parts[p0:p0 + n])
    dk = torch.zeros((B, Skv, KH, D), dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    parts = [None] * work.dkdv.partials
    for j, b, kh, lo, per, u, ue, dest in work.dkdv.segs.tolist():
        keys = slice(j * T, (j + 1) * T)
        sk = sv = torch.zeros_like(dk[b, keys, kh])
        for step in range(u, ue):
            g, ti = divmod(step, per)
            rows = slice((lo + ti) * T, (lo + ti + 1) * T)
            sk = sk + ds[b, kh, g, rows, keys].T @ qf[b, rows, kh, g]
            sv = sv + p[b, kh, g, rows, keys].T @ gf[b, rows, kh, g]
        if dest < 0:
            dk[b, keys, kh], dv[b, keys, kh] = sk, sv
        else:
            parts[dest] = (sk, sv)
    for j, b, kh, p0, n in work.dkdv.folds.tolist():
        keys = slice(j * T, (j + 1) * T)
        dk[b, keys, kh] = _sum_in_order([x[0] for x in parts[p0:p0 + n]])
        dv[b, keys, kh] = _sum_in_order([x[1] for x in parts[p0:p0 + n]])
    dq = dq.reshape(B, Sq, H, D) * scale
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_mma_plain(q, k, v, out, d_out, lse, *, causal=True,
                                  window=None, softcap=None, scale=None):
    """The tensor-core backward kernel's arithmetic
    (``csrc/flash_attention_bwd_mma.cu``): ``flash_attention_bwd_plain``'s
    function with L taken from the forward (``lse`` [B,H,Sq], as
    ``flash_lse_plain`` gives it) and P and dS rounded to the inputs' dtype
    before the three products that read them (dV = P^T dO, dQ = scale dS
    K, dK = scale dS^T Q; the tensor cores' bf16 A operands), every sum
    in f32.  In f32 nothing rounds: it is ``flash_attention_bwd_plain``
    with L given."""
    return _flash_bwd(q, k, v, out, d_out, lse,
                      None if q.dtype in (torch.float32, torch.float64)
                      else q.dtype, causal=causal, window=window,
                      softcap=softcap, scale=scale)


# --- the recurrences -------------------------------------------------------

def _acc(*tensors):
    """The recurrences' arithmetic type: f64 where an input is f64, else
    f32 (bf16 and f32 inputs are read in f32, as the kernels read them)."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def wkv6_carry(r, k, v, w, u, s0):
    """The RWKV6 recurrence from a carried state, a port of
    ``repro.models.layers.rwkv._wkv_scan_ref`` as a plain time loop (its
    sqrt-remat chunking only saves memory for gradients).  r,k,v,w
    [B,S,H,N]; u [H,N]; s0 [B,H,N,N] -> (y [B,S,H,N] f32, sT f32), every
    input read in f32 (f64 where one is f64).

      y_t = r_t . (S + diag(u) k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T"""
    B, S, H, N = r.shape
    acc = _acc(r, k, v, w, u)
    rf, kf, vf, wf, uf = (t.to(acc) for t in (r, k, v, w, u))
    s = s0.to(acc)
    y = torch.empty((B, S, H, N), dtype=acc, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # [B,H,N,N]
        y[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t],
                               s + uf[..., None] * kv)
        s = wf[:, t, :, :, None] * s + kv
    return y, s


def wkv6_plain(r, k, v, w, u, *, block_h=1):
    """RWKV6, a port of ``repro.kernels.ref.wkv6_ref`` with the Pallas
    kernel's dtypes.  r,k,v,w [B,S,H,N]; u [H,N] -> y [B,S,H,N]: an f32
    state [B,H,N,N] from zero, every input read in f32 (the model rounds
    ``u`` to r's dtype before the call, as the Pallas path does; an f32
    ``u``, as on the reference's scan path, is used as it is); y in r's
    dtype (``wkv6_carry`` from a zero state).

    ``block_h`` heads share a block in the kernel; heads are independent,
    so the blocking changes no value and this runs all heads at once."""
    del block_h
    B, _, H, N = r.shape
    s0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    return wkv6_carry(r, k, v, w, u, s0)[0].to(r.dtype)


def ssm_scan_carry(x, dt, B, C, A, h0):
    """The selective scan from a carried state, a port of
    ``repro.models.layers.mamba._ssm_scan_ref`` as a plain time loop.
    x,dt [Bt,S,Di]; B,C [Bt,S,N]; A [Di,N]; h0 [Bt,Di,N] -> (y [Bt,S,Di]
    f32, hT f32), every input read in f32 (f64 where one is f64).

      h_t = exp(dt_t A) h + (dt_t x_t) B_t;   y_t = h_t . C_t"""
    Bt, S, Di = x.shape
    acc = _acc(x, dt, B, C, A)
    xf, dtf, bf, cf, Af = (t.to(acc) for t in (x, dt, B, C, A))
    h = h0.to(acc)
    y = torch.empty((Bt, S, Di), dtype=acc, device=x.device)
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t])
    return y, h


def ssm_scan_plain(x, dt, B, C, A, *, block_d=256):
    """Selective scan, a port of ``repro.kernels.ref.ssm_scan_ref`` with
    the Pallas kernel's dtypes.  x,dt [Bt,S,Di]; B,C [Bt,S,N]; A [Di,N] ->
    y [Bt,S,Di] in x's dtype: an f32 state h [Bt,Di,N] from zero, every
    input read in f32 (``ssm_scan_carry`` from a zero state).

    Channels are independent, so the kernel's ``block_d`` tiling changes
    no value."""
    del block_d
    h0 = torch.zeros((x.shape[0], x.shape[2], A.shape[1]),
                     dtype=torch.float32, device=x.device)
    return ssm_scan_carry(x, dt, B, C, A, h0)[0].to(x.dtype)


# --- the recurrences' gradients ---------------------------------------------
#
# Closed forms of the gradients of ``wkv6_plain`` and ``ssm_scan_plain``
# (the models' train path: a zero start, the final state never read), in
# f32 (f64 where an input is f64).  Both need the forward state beside the
# reverse cotangent at each step: the state is kept at chunk boundaries by
# a forward sweep and a chunk's states are rebuilt from its boundary during
# the reverse walk (never recovered by dividing by a decay, which reaches
# 5e-6).  The ``*_parts`` functions keep the kernels' partial sums apart
# (column groups of a head for wkv6, channel groups and rows for the scan);
# the ``*_split_plain`` functions add them in the kernels' order.  The wkv6
# kernel also cuts the sequence into segments (``wkv6_bwd_local``,
# ``wkv6_bwd_combine``): both of its recurrences are linear with a per-row
# decay, so a segment's effect composes from its walk from zero and the
# product of its decays.

def _wkv_bwd_sweep(rf, kf, vf, wf, gf, chunk, cols, s0, g1):
    """The recurrence's reverse walk over ``chunk``-step chunks from the
    state ``s0`` before the first step and the cotangent ``g1`` after the
    last: per column slice in ``cols`` the partials (dr, dk, dw) of
    S_{t-1} dy_t, G_t v_t and sum_j G_t S_{t-1}, and dv = G_t^T k_t whole
    (f32/f64, [B,S,H,N]).  G_{t-1} = diag(w_t) G_t + r_t dy_t^T.  The time
    loops carry S and G alone; a chunk's sums are taken at once from its
    stacked states."""
    B, S, H, N = rf.shape
    s = s0
    bounds = []
    for t in range(S):
        if t % chunk == 0:
            bounds.append(s)
        s = torch.addcmul(wf[:, t, :, :, None] * s, kf[:, t, :, :, None],
                          vf[:, t, :, None, :])
    parts = {n: [torch.zeros_like(rf) for _ in cols] for n in ("dr", "dk",
                                                                "dw")}
    dv = torch.zeros_like(rf)
    G = g1
    for c in reversed(range(len(bounds))):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        states, gs, s = [], [], bounds[c]
        for t in range(t0, t1):
            states.append(s)
            s = torch.addcmul(wf[:, t, :, :, None] * s, kf[:, t, :, :, None],
                              vf[:, t, :, None, :])
        for t in reversed(range(t0, t1)):
            gs.append(G)
            G = torch.addcmul(wf[:, t, :, :, None] * G, rf[:, t, :, :, None],
                              gf[:, t, :, None, :])
        sp = torch.stack(states, 1)                 # [B,L,H,N,N] S_{t-1}
        gt = torch.stack(gs[::-1], 1)               # [B,L,H,N,N] G_t
        ts = slice(t0, t1)
        for i, cs in enumerate(cols):
            parts["dr"][i][:, ts] = torch.einsum(
                "blhij,blhj->blhi", sp[..., cs], gf[:, ts, :, cs])
            parts["dk"][i][:, ts] = torch.einsum(
                "blhij,blhj->blhi", gt[..., cs], vf[:, ts, :, cs])
            parts["dw"][i][:, ts] = (gt[..., cs] * sp[..., cs]).sum(-1)
        dv[:, ts] = torch.einsum("blhij,blhi->blhj", gt, kf[:, ts])
    return parts, dv


def _segments(S, seg):
    """The [t0, t1) of each ``seg``-step segment (one segment where seg is
    None)."""
    seg = seg or S
    return [(t0, min(S, t0 + seg)) for t0 in range(0, S, seg)]


def wkv6_bwd_local(r, k, v, w, dy, *, seg):
    """The wkv6 backward kernel's first pass: for each ``seg``-step
    segment [t0, t1) of each (row, head), from zero, the state after its
    last step (S_local = the forward over the segment), the cotangent
    before its first (G_local = the reverse walk, G_{t0-1} with G_{t1-1}
    = 0) and P, the product of its decays ([B,H,N]), each a product of w
    and never a quotient: a P that underflows to 0 is the true product.
    -> [(S_local, G_local, P)] in f32 (f64 where an input is f64)."""
    acc = _acc(r, k, v, w, dy)
    rf, kf, vf, wf, gf = (t.to(acc) for t in (r, k, v, w, dy))
    B, S, H, N = rf.shape
    out = []
    for t0, t1 in _segments(S, seg):
        s = rf.new_zeros((B, H, N, N))
        g = torch.zeros_like(s)
        p = rf.new_ones((B, H, N))
        for t in range(t0, t1):
            s = torch.addcmul(wf[:, t, :, :, None] * s, kf[:, t, :, :, None],
                              vf[:, t, :, None, :])
            p = p * wf[:, t]
        for t in reversed(range(t0, t1)):
            g = torch.addcmul(wf[:, t, :, :, None] * g, rf[:, t, :, :, None],
                              gf[:, t, :, None, :])
        out.append((s, g, p))
    return out


def wkv6_bwd_combine(local):
    """The kernel's second pass, a serial walk over the segments of
    ``wkv6_bwd_local``: each segment's start state S_start (S_start[0] =
    0, S_start[m+1] = diag(P_m) S_start[m] + S_local[m]) and end cotangent
    G_end (the last one 0, G_end[m-1] = diag(P_m) G_end[m] + G_local[m]).
    It only multiplies.  -> (starts, ends), one [B,H,N,N] a segment."""
    zero = torch.zeros_like(local[0][0])
    starts, ends = [zero], [zero]
    for s, _, p in local[:-1]:
        starts.append(p[..., None] * starts[-1] + s)
    for _, g, p in local[:0:-1]:
        ends.append(p[..., None] * ends[-1] + g)
    return starts, ends[::-1]


def wkv6_bwd_parts(r, k, v, w, u, dy, *, cols=32, chunk=8, seg=None,
                   bounds=None):
    """The wkv6 backward kernel's partial sums (``csrc/wkv6_bwd.cu``): the
    sequence cut into segments of ``seg`` steps (one where None), each
    walked from its start state and end cotangent (``bounds``, as
    ``wkv6_bwd_combine`` gives them, where None), a head's columns cut into
    blocks of ``cols``, each block's share of dr, dk and dw (the sums over
    columns j, bonus terms included) and of du for each row and segment,
    beside dv whole (a column block holds every row i).

      dr_t = S_{t-1} dy_t + (u o k_t)(v_t . dy_t)
      dk_t = G_t v_t + (u o r_t)(v_t . dy_t)
      dv_t = G_t^T k_t + (r_t . (u o k_t)) dy_t
      dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
      du = sum_{row,t} (r_t o k_t)(v_t . dy_t)

    Returns {"dr", "dk", "dw": one [B,S,H,N] per block, "du": [B][segment]
    [block] [H,N], "dv": [B,S,H,N]} in f32 (f64 where an input is f64)."""
    acc = _acc(r, k, v, w, u, dy)
    rf, kf, vf, wf, gf = (t.to(acc) for t in (r, k, v, w, dy))
    uf = u.to(acc)
    B, S, H, N = r.shape
    width = min(cols, N)
    blocks = [slice(j, j + width) for j in range(0, N, width)]
    segs = _segments(S, seg)
    if bounds is None:
        bounds = (wkv6_bwd_combine(wkv6_bwd_local(rf, kf, vf, wf, gf,
                                                  seg=seg))
                  if len(segs) > 1 else
                  ([rf.new_zeros((B, H, N, N))], [rf.new_zeros((B, H, N, N))]))
    parts = {n: [torch.zeros_like(rf) for _ in blocks]
             for n in ("dr", "dk", "dw")}
    dv = torch.zeros_like(rf)
    for (t0, t1), s0, g1 in zip(segs, *bounds):
        ts = slice(t0, t1)
        p, dv[:, ts] = _wkv_bwd_sweep(rf[:, ts], kf[:, ts], vf[:, ts],
                                      wf[:, ts], gf[:, ts], chunk, blocks,
                                      s0, g1)
        for n in parts:
            for i, x in enumerate(p[n]):
                parts[n][i][:, ts] = x
    vdy = [(vf[..., cs] * gf[..., cs]).sum(-1, keepdim=True) for cs in blocks]
    for i, d in enumerate(vdy):
        parts["dr"][i] += uf * kf * d
        parts["dk"][i] += uf * rf * d
    dv += (rf * uf * kf).sum(-1, keepdim=True) * gf
    parts["du"] = [[[(rf[b, t0:t1] * kf[b, t0:t1] * d[b, t0:t1]).sum(0)
                     for d in vdy] for t0, t1 in segs]
                   for b in range(B)]
    parts["dv"] = dv
    return parts


def wkv6_bwd_sum(p, r, w, u):
    """The parts of ``wkv6_bwd_parts`` added as the kernel adds them: dr,
    dk and dw over the column blocks in order, du over (row, segment,
    block) in order.  -> (dr, dk, dv in r's dtype, dw f32, du in u's
    dtype), each rounded once."""
    dr, dk, dw = (_sum_in_order(p[n]) for n in ("dr", "dk", "dw"))
    du = _sum_in_order([x for row in p["du"] for sg in row for x in sg])
    return (dr.to(r.dtype), dk.to(r.dtype), p["dv"].to(r.dtype),
            dw.to(_acc(w, r)), du.to(u.dtype))


def wkv6_bwd_split_plain(r, k, v, w, u, dy, *, cols=32, chunk=8, seg=None):
    """The wkv6 backward as the kernel splits and adds it
    (``wkv6_bwd_parts``, ``wkv6_bwd_sum``)."""
    p = wkv6_bwd_parts(r, k, v, w, u, dy, cols=cols, chunk=chunk, seg=seg)
    return wkv6_bwd_sum(p, r, w, u)


def wkv6_bwd_plain(r, k, v, w, u, dy, *, chunk=64):
    """The gradient of ``wkv6_plain(r, k, v, w, u)`` at the cotangent
    ``dy`` [B,S,H,N]: (dr, dk, dv, dw, du) from the closed forms of
    ``wkv6_bwd_parts`` over whole heads and one segment, the state kept
    every ``chunk`` steps.  dr, dk, dv in r's dtype, dw in f32 (f64 where
    an input is f64), du in u's dtype; every sum in f32 (f64)."""
    return wkv6_bwd_split_plain(r, k, v, w, u, dy, cols=r.shape[-1],
                                chunk=chunk)


def ssm_scan_bwd_parts(x, dt, B, C, A, dy, *, group=16, chunk=16):
    """The ssm_scan backward kernel's partial sums
    (``csrc/ssm_scan_bwd.cu``): dB and dC, sums over channels, as one
    partial per group of ``group`` channels; dA, a sum over rows and
    steps, as one partial per row; dx and ddt whole.  With a_t =
    exp(dt_t A), h_t = a_t h_{t-1} + (dt_t x_t) B_t and the state's
    cotangent G_t = dy_t C_t + a_{t+1} G_{t+1}:

      dC_t[n] = sum_d dy_t[d] h_t[d,n]
      dB_t[n] = sum_d G_t[d,n] dt_t[d] x_t[d]
      dx_t[d] = dt_t[d] sum_n G_t[d,n] B_t[n]
      ddt_t[d] = x_t[d] sum_n G_t[d,n] B_t[n]
                 + sum_n G_t[d,n] A[d,n] a_t[d,n] h_{t-1}[d,n]
      dA[d,n] = sum_{row,t} G_t[d,n] dt_t[d] a_t[d,n] h_{t-1}[d,n]

    Returns {"dB", "dC": one [Bt,S,N] a group, "dA": one [Di,N] a row,
    "dx", "ddt": [Bt,S,Di]} in f32 (f64 where an input is f64)."""
    acc = _acc(x, dt, B, C, A, dy)
    xf, dtf, bf, cf, Af, gf = (t.to(acc) for t in (x, dt, B, C, A, dy))
    Bt, S, Di = x.shape
    N = A.shape[1]
    groups = [slice(d, d + group) for d in range(0, Di, group)]
    dtx = dtf * xf
    h = torch.zeros((Bt, Di, N), dtype=acc, device=x.device)
    bounds = []
    for t0 in range(0, S, chunk):
        bounds.append(h)
        a = torch.exp(dtf[:, t0:t0 + chunk, :, None] * Af)
        for t in range(t0, min(S, t0 + chunk)):
            h = torch.addcmul(a[:, t - t0] * h, dtx[:, t, :, None],
                              bf[:, t, None, :])
    dB = [torch.zeros_like(bf) for _ in groups]
    dC = [torch.zeros_like(cf) for _ in groups]
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(xf)
    dA = torch.zeros((Bt, Di, N), dtype=acc, device=x.device)
    G = torch.zeros((Bt, Di, N), dtype=acc, device=x.device)
    a_next = torch.ones_like(G)
    # the time loops carry h and G alone; a chunk's sums are taken at once
    # from its stacked h_{t-1}, a_t, h_t and G_t ([Bt,L,Di,N])
    for c in reversed(range(len(bounds))):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        ts = slice(t0, t1)
        a = torch.exp(dtf[:, ts, :, None] * Af)
        hs, gs, h = [], [], bounds[c]
        for t in range(t0, t1):
            hs.append(h)
            h = torch.addcmul(a[:, t - t0] * h, dtx[:, t, :, None],
                              bf[:, t, None, :])
        hs.append(h)
        for t in reversed(range(t0, t1)):
            G = torch.addcmul(a_next * G, gf[:, t, :, None],
                              cf[:, t, None, :])
            gs.append(G)
            a_next = a[:, t - t0]
        hp, ht = torch.stack(hs[:-1], 1), torch.stack(hs[1:], 1)
        gt = torch.stack(gs[::-1], 1)
        gB = torch.einsum("bldn,bln->bld", gt, bf[:, ts])
        gah = gt * a * hp
        dx[:, ts] = dtf[:, ts] * gB
        ddt[:, ts] = xf[:, ts] * gB + (gah * Af).sum(-1)
        dA += (gah * dtf[:, ts, :, None]).sum(1)
        for i, gsl in enumerate(groups):
            dB[i][:, ts] = torch.einsum("bldn,bld->bln", gt[:, :, gsl],
                                        dtx[:, ts, gsl])
            dC[i][:, ts] = torch.einsum("bldn,bld->bln", ht[:, :, gsl],
                                        gf[:, ts, gsl])
    return {"dB": dB, "dC": dC, "dA": list(dA.unbind(0)), "dx": dx,
            "ddt": ddt}


def ssm_scan_bwd_split_plain(x, dt, B, C, A, dy, *, group=16, chunk=16):
    """The ssm_scan backward as the kernel adds its partials: dB and dC
    over the channel groups in order, dA over the rows in order
    (``ssm_scan_bwd_parts``).  -> (dx in x's dtype, ddt f32, dB, dC in
    B's dtype, dA f32), each rounded once."""
    p = ssm_scan_bwd_parts(x, dt, B, C, A, dy, group=group, chunk=chunk)
    f = _acc(x, dt, B, C, A)
    return (p["dx"].to(x.dtype), p["ddt"].to(f),
            _sum_in_order(p["dB"]).to(B.dtype),
            _sum_in_order(p["dC"]).to(C.dtype),
            _sum_in_order(p["dA"]).to(f))


def ssm_scan_bwd_plain(x, dt, B, C, A, dy, *, chunk=64):
    """The gradient of ``ssm_scan_plain(x, dt, B, C, A)`` at the cotangent
    ``dy`` [Bt,S,Di]: (dx, ddt, dB, dC, dA) from the closed forms of
    ``ssm_scan_bwd_parts`` over all channels at once, the state kept
    every ``chunk`` steps.  dx in x's dtype, dB and dC in B's, ddt and dA
    in f32 (f64 where an input is f64); every sum in f32 (f64)."""
    return ssm_scan_bwd_split_plain(x, dt, B, C, A, dy, group=x.shape[2],
                                    chunk=chunk)


# --- the paper's probes ----------------------------------------------------

def _u32(y):
    """The int32 bit pattern of ``y`` as a non-negative int64."""
    return y.to(torch.int64) & 0xFFFFFFFF


def _popc(y):
    """Population count of each int32 (``lax.population_count``)."""
    v = _u32(y)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(y.dtype)


def _clz(y):
    """Leading zeros of each int32 (``lax.clz``): 32 for 0."""
    v = _u32(y)
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        top_clear = v < (1 << (32 - s))
        n = n + top_clear * s
        v = torch.where(top_clear, v << s, v)
    return (n + (v == 0)).to(y.dtype)


# op name -> elementwise function of (y, c): the harness's 21 ops, a
# superset of the Pallas kernel's 11 (``microbench_alu._KERNEL_OPS``)
ALU_OPS = {
    "add": lambda y, c: y + c,
    "sub": lambda y, c: y - c,
    "mul": lambda y, c: y * c,
    "fma": lambda y, c: y * c + c,
    "max": lambda y, c: torch.maximum(y, c),
    "min": lambda y, c: torch.minimum(y, c),
    "abs": lambda y, c: torch.abs(y) + c * 0,
    "and": lambda y, c: y & c,
    "xor": lambda y, c: y ^ c,
    "popc": lambda y, c: _popc(y) + c * 0,
    "clz": lambda y, c: _clz(y) + c * 0,
    "div": lambda y, c: y / c,
    "rem": lambda y, c: torch.remainder(y, c),
    "rsqrt": lambda y, c: torch.rsqrt(torch.abs(y) + c * 0 + 1e-6),
    "sqrt": lambda y, c: torch.sqrt(torch.abs(y)) + c * 0,
    "exp": lambda y, c: torch.exp(y * 0.001) + c * 0,
    "log": lambda y, c: torch.log(torch.abs(y) + 1.0) + c * 0,
    "sin": lambda y, c: torch.sin(y) + c * 0,
    "tanh": lambda y, c: torch.tanh(y) + c * 0,
    "sigmoid": lambda y, c: torch.sigmoid(y) + c * 0,
    "select": lambda y, c: torch.where(y > c, y, c),
}
INT_OPS = {"and", "xor", "popc", "clz"}
FLOAT_ONLY = {"rsqrt", "sqrt", "exp", "log", "sin", "tanh", "sigmoid",
              "div", "fma"}


def alu_legal(op, dtype) -> bool:
    """Whether the harness runs ``op`` in ``dtype`` (int ops on ints,
    MUFU-class ops, ``div`` and ``fma`` on floats)."""
    is_int = not torch.empty((), dtype=dtype).is_floating_point()
    return not ((is_int and op in FLOAT_ONLY)
                or (not is_int and op in INT_OPS))


def alu_chain_plain(x, c, *, op="fma", length=64, dependent=True):
    """A ``length``-long chain of one op: threaded through one value
    (dependent) or over ``x + i`` for each i and kept live by
    ``out + y * 0`` (independent).  ``c`` is a 0-d tensor of x's dtype."""
    f = ALU_OPS[op]
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    if dependent:
        y = x
        for _ in range(length):
            y = f(y, c)
        return y
    out = f(x + 0, c)
    for i in range(1, length):
        out = out + f(x + i, c) * 0
    return out


def pointer_chase_plain(nxt, start, hops):
    """``hops`` dependent loads ``i <- nxt[i]`` from ``start`` -> the
    final index as a 0-d int32 tensor."""
    i = torch.as_tensor(start, dtype=torch.long, device=nxt.device)
    for _ in range(int(hops)):
        i = nxt[i].long()
    return i.to(torch.int32)


def mxu_probe_plain(a, b, *, chain=1):
    """Dependent tile-matmul chain: C <- (A @ C) * 0.001 in f32, cast to
    b's dtype after every step, ``chain`` times."""
    c = b
    for _ in range(chain):
        c = (a.float() @ c.float() * 0.001).to(b.dtype)
    return c
