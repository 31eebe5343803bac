"""Plain PyTorch versions of the CUDA kernels: the oracles each kernel is
held against on the card, and what the wrappers run for tensors on the
CPU.

* paged attention: ports of ``repro.kernels.ref.gather_pages`` /
  ``paged_attention_ref`` plus the split-KV first pass and its merge;
* flash attention: ``flash_attention_ref`` (full softmax, a port of
  ``repro.kernels.ref.flash_attention_ref``) and ``flash_attention_plain``
  (the blocked online softmax of ``repro.kernels.flash_attention``, with
  its rounding points);
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
