"""Blocked flash-attention forward: the wrapper around two CUDA kernels,
which replace the TPU Pallas kernel
``repro.kernels.flash_attention.flash_attention``.

A tensor on the CPU goes to the plain version (``ref.flash_attention_plain``);
a CUDA tensor launches a kernel or raises, with no fallback.

Dispatch (``kernel_for``, a function of dtype, ``acc_dtype`` and D alone,
never of a failure):

* bf16 with ``acc_dtype="f32"`` and D % 16 == 0, D <= 256 launches the
  tensor-core kernel ``csrc/flash_attention_mma.cu`` (``mma.sync`` bf16
  tiles, f32 accumulators, a ``cp.async`` K/V ring);
* f32 inputs, ``acc_dtype="bf16"`` and bf16 with D % 16 == 8 launch the
  CUDA-core kernel ``csrc/flash_attention.cu``: f32 stays full f32 (the
  tensor cores would round it to bf16 or tf32), and the bf16 accumulator
  rounds after every ``block_k`` tile where the Pallas kernel does.

Tiles (``kernel_tiles``): the tensor-core kernel runs 64 query rows of one
head a block and 64-key KV tiles whatever the hints.  The CUDA-core kernel
runs 64 query rows a block (the GQA group's heads times ``64 // G``
positions), 16 warps, one block an SM; with ``acc_dtype="f32"`` its KV
tiles are 64 keys, with ``"bf16"`` it honours ``block_k`` (clamped to
Skv, as the Pallas kernel clamps it; at most 256) and matches the plain
version's rounding points.

The work split (``work_split``, a function of the shapes alone): with an
f32 accumulator each query tile's KV range is cut into items of at most
``T`` tiles, ``T`` chosen so that the call makes about ``ITEMS_PER_SM``
items for each of the H100's ``SMS`` SMs; a tile with several items
writes f32 partials (m, l, acc) to a workspace, which a merge kernel
folds (``merge_partials`` is its arithmetic).  The bf16 accumulator is
never split.  ``split_plain`` runs the plain arithmetic item by item and
merges, the CPU's rehearsal of the kernel's split.

The gradient (``FlashAttentionFn``, a ``torch.autograd.Function``):
``flash_attention`` takes it whenever grad mode is on and q, k or v
requires grad.  Its forward is the forward above; it saves q, k, v, the
output and the row log-sum-exp L that either forward kernel writes beside
O when given a buffer (``flash_attention_with_lse``; O is the same bits
with and without it; on the CPU ``ref.flash_lse_plain``).  Its backward
(``flash_attention_bwd``) takes that L and follows the forward's rule
(``bwd_kernel_for``):

* bf16 with ``acc_dtype="f32"`` and D % 16 == 0, D <= 256 launches the
  tensor-core kernels of ``csrc/flash_attention_bwd_mma.cu`` (a dq kernel
  that also writes dO.O, then a dk/dv kernel over ``bwd_split`` parts of
  each GQA group, a cluster of blocks adding their f32 partials where
  there are several), fed the forward's L; its plain version is
  ``ref.flash_attention_bwd_mma_plain`` (P and dS rounded to bf16);
* everything else launches the CUDA-core kernels of
  ``csrc/flash_attention_bwd.cu`` (f32 FFMA, register-blocked: a dq kernel
  that also writes dO.O, a dk/dv kernel, each with one block an SM
  walking an equal span of its tile steps, and a fold kernel adding in
  block order the f32 partials of the tiles that several spans share);
  the schedule is the wrapper's (``bwd_work``, stream-K, a function of
  the shapes alone), copied to the card once a shape and read there, so
  call it once at a shape before capturing it in a CUDA graph.  Its plain
  version is ``ref.flash_attention_bwd_plain`` with L given, and
  ``ref.flash_attention_bwd_split_plain`` rehearses the split from the
  same schedule.

CPU tensors take the plain version of the kernel the rule picks.  A CUDA
tensor the kernel does not take raises.  The JAX package has no
hand-written backward: JAX differentiates the Pallas kernel's body.

``flash_attention.launches`` counts the launches of both forward kernels,
``flash_attention.mma_launches`` those of the tensor-core kernel,
``flash_attention.bwd_launches`` those of either backward and
``flash_attention.bwd_mma_launches`` those of the tensor-core backward
(plain integers; reset them to 0 before a run to prove which kernel it
took).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ACC_DTYPES, NEG_INF,
                                     flash_attention_bwd_mma_plain,
                                     flash_attention_bwd_plain,
                                     flash_attention_plain, flash_lse_plain)

SIMT = "flash_attention"          # the CUDA-core kernel (csrc name)
MMA = "flash_attention_mma"       # the tensor-core kernel (csrc name)
BWD = "flash_attention_bwd"       # the CUDA-core backward (csrc name)
BWD_MMA = "flash_attention_bwd_mma"   # the tensor-core backward (csrc name)
ROWS = 64                 # query rows per block (csrc: kRows, kBM)
SUB = 64                  # KV tile of the f32 accumulator (csrc: kSub, kBN)
SMEM_LIMIT = 232448       # shared memory a Hopper block may use (227 KB)
# the CUDA-core kernel's shared memory (csrc: kSlabD, kSlabV, kStages,
# kLdK, kLdP, kMaxSub)
SLAB_D, SLAB_V, STAGES = 64, 16, 4
LDK, LDP = SLAB_D + 16, ROWS + 4
MAX_LK = 4 * SUB
# the split's aim: about ITEMS_PER_SM items for each SM of an H100
SMS, ITEMS_PER_SM = 132, 2
# head dims the tensor-core kernel is built for (csrc: DP); a D in between
# runs at the next one, its extra columns zero
MMA_DIMS = (16, 32, 64, 128, 256)
MMA_SLOTS = 2             # slots of its K/V ring (csrc: kSlots)
# the split of a GQA group over dk/dv blocks aims at this many blocks an
# SM, in at most BWD_MAX_PARTS parts (csrc: kMaxCluster, a cluster's blocks)
BWD_BLOCKS_PER_SM = 1
BWD_MAX_PARTS = 8
BWD_T = 32                # rows of the CUDA-core backward's tiles (csrc kT)
# its spans' costs: a tile step and a segment's own (its prologue's loads,
# D, a partial out and back), in the same units
BWD_STEP_COST, BWD_SEGMENT_COST = 5, 3
_fns = {}


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_launch")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == MMA:
            fn.argtypes = [P] * 5 + [I] * 6 + [F, I, I, F, P]
        elif name == BWD_MMA:
            fn.argtypes = [P] * 10 + [I] * 7 + [F, I, I, F, P]
        elif name == BWD:
            fn.argtypes = [P] * 12 + [I] * 14 + [F, I, I, F, P]
        else:
            fn.argtypes = [P] * 6 + [I] * 13 + [F, I, I, F, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def kernel_for(dtype, acc_dtype: str, D: int) -> str:
    """The dispatch rule: ``MMA`` (the tensor-core kernel) for bf16 with
    an f32 accumulator and D % 16 == 0, D <= 256; ``SIMT`` (the CUDA-core
    kernel, which refuses what it does not take) for everything else."""
    if (dtype == torch.bfloat16 and acc_dtype == "f32" and D % 16 == 0
            and 0 < D <= MMA_DIMS[-1]):
        return MMA
    return SIMT


def bwd_kernel_for(dtype, acc_dtype: str, D: int) -> str:
    """The backward's rule, the forward's: ``BWD_MMA`` (the tensor-core
    backward) exactly where ``kernel_for`` picks ``MMA``, else ``BWD``."""
    return BWD_MMA if kernel_for(dtype, acc_dtype, D) == MMA else BWD


@functools.lru_cache(maxsize=256)
def bwd_split(B: int, Skv: int, H: int, KH: int) -> int:
    """Parts of each GQA group over the tensor-core dk/dv kernel's blocks
    (csrc ``ns``): the least divisor ``ns`` of G = H / KH, at most
    ``BWD_MAX_PARTS``, that gives ``BWD_BLOCKS_PER_SM`` blocks for each of
    the H100's ``SMS`` SMs (``B * KH * ceil(Skv / 64) * ns``), else the
    largest such divisor; a function of the shapes alone.  With ns > 1 a
    key tile's parts run as one thread-block cluster and add their f32
    partials in order.  Cached: a call at seen shapes costs the host
    nothing."""
    G = H // KH
    base = B * KH * -(-Skv // SUB)
    parts = [d for d in range(1, min(G, BWD_MAX_PARTS) + 1) if G % d == 0]
    return next((d for d in parts if base * d >= BWD_BLOCKS_PER_SM * SMS),
                parts[-1])


def _query_range(j: int, T: int, Sq: int, Skv: int, causal: bool,
                 window) -> Tuple[int, int]:
    """The query tiles ``[lo, hi)`` of ``T`` rows holding a row the mask
    lets see a key of key tile ``j``."""
    k_last = min((j + 1) * T, Skv) - 1
    q_hi = Sq - 1 if not window else min(k_last + window - 1, Sq - 1)
    lo = j if causal else 0
    return lo, max(q_hi // T + 1, lo)


class BwdUnits(NamedTuple):
    """One CUDA-core backward kernel's units (a tile of one head) in its
    step order, each field int64 [U]: ``tile``, batch row ``b``, ``head``
    (query head for the dq kernel, KV head for the dk/dv kernel), ``lo``
    (the first key tile, or query tile, of the tile's range), ``per`` (the
    range's tiles) and ``n``, its steps (``per``, or ``G * per`` for the
    dk/dv kernel, whose step u is query head ``head * G + u // per`` and
    query tile ``lo + u % per``)."""
    tile: torch.Tensor
    b: torch.Tensor
    head: torch.Tensor
    lo: torch.Tensor
    per: torch.Tensor
    n: torch.Tensor


def _units(B: int, ranges, heads: int, reps: int,
           last_first: bool) -> BwdUnits:
    """The units of tiles with ``ranges`` (each ``(lo, hi)``), tiles in
    order (``last_first``: the last first), each for every (batch row,
    head); tiles with an empty range have none."""
    order = [(i, lo, hi - lo) for i, (lo, hi) in enumerate(ranges)
             if hi > lo]
    if last_first:
        order.reverse()
    t = torch.tensor(order, dtype=torch.int64).reshape(-1, 3)
    rep = B * heads
    bh = torch.arange(rep, dtype=torch.int64).repeat(len(order))
    per = t[:, 2].repeat_interleave(rep)
    return BwdUnits(t[:, 0].repeat_interleave(rep), bh // heads, bh % heads,
                    t[:, 1].repeat_interleave(rep), per, per * reps)


def bwd_units(B: int, Sq: int, Skv: int, H: int, KH: int, *, causal=True,
              window=None) -> Tuple[BwdUnits, BwdUnits]:
    """Both CUDA-core backward kernels' units: the dq kernel's (32-row
    query tiles last-first, the longest under a causal mask, each for
    every batch row and query head; its steps the tile's key tiles) and
    the dk/dv kernel's (32-key tiles first-first, each for every batch
    row and KV head; its steps the (query head of the group, query tile)
    pairs, head-major)."""
    T = BWD_T
    q_ranges = [tile_range(i, T, T, Sq, Skv, causal, window)
                for i in range(-(-Sq // T))]
    k_ranges = [_query_range(j, T, Sq, Skv, causal, window)
                for j in range(-(-Skv // T))]
    return (_units(B, q_ranges, H, 1, True),
            _units(B, k_ranges, KH, H // KH, False))


def stream_k(units: BwdUnits, nb: int) -> torch.Tensor:
    """The first step of each of ``nb`` blocks' spans and the steps' end,
    int64 [nb + 1]: the units' cost (``BWD_SEGMENT_COST +
    BWD_STEP_COST * n`` a unit, its own cost first) cut into ``nb`` equal
    parts, each cut moved to the nearest step."""
    U = len(units.n)    # at least one: query 0 keeps key 0 under any mask
    zero = torch.zeros(1, dtype=torch.int64)
    cost = torch.cat([zero, (BWD_SEGMENT_COST + BWD_STEP_COST * units.n)
                      .cumsum(0)])
    u0 = torch.cat([zero, units.n.cumsum(0)])
    x = cost[-1] * torch.arange(nb + 1, dtype=torch.int64) // nb
    at = torch.searchsorted(cost, x, right=True) - 1
    k = at.clamp(max=U - 1)
    o = x - cost[k] - BWD_SEGMENT_COST
    step = torch.minimum(units.n[k], (o + BWD_STEP_COST // 2)
                         // BWD_STEP_COST).clamp(min=0)
    return torch.where(at >= U, u0[-1], u0[k] + step)


class BwdTable(NamedTuple):
    """One CUDA-core backward kernel's schedule, which its blocks read from
    the device (int32): ``segs`` [n, 8], each a run of one unit's steps in
    one block's span as ``(tile, b, head, lo, per, first step, end,
    dest)`` (``dest`` -1 where the segment is the whole unit and the block
    writes the gradient, else the index of its f32 partial in the
    workspace); ``offsets`` [nb + 1], block j's segments being ``segs[
    offsets[j]:offsets[j + 1]]``; ``folds`` [m, 5], each unit that several
    segments share as ``(tile, b, head, first partial, partials)``, its
    partials consecutive and in block order; ``partials``, their count."""
    segs: torch.Tensor
    offsets: torch.Tensor
    folds: torch.Tensor
    partials: int

    def blocks(self) -> int:
        return len(self.offsets) - 1


def bwd_table(units: BwdUnits, starts: torch.Tensor) -> BwdTable:
    """The schedule of blocks whose spans start at ``starts`` (int64
    [nb + 1], non-decreasing, from 0 to the steps' end): each span cut at
    the units' bounds into segments, in step order (so in block order and
    unit order at once).  Raises ``ValueError`` where a field or the
    segment count passes 2^31 - 1."""
    zero = torch.zeros(1, dtype=torch.int64)
    u0 = torch.cat([zero, units.n.cumsum(0)])
    s, e = starts[:-1], starts[1:]
    first = torch.searchsorted(u0, s, right=True) - 1
    last = torch.searchsorted(u0, e - 1, right=True) - 1
    count = torch.where(e > s, last - first + 1, 0)
    offsets = torch.cat([zero, count.cumsum(0)])
    blk = torch.repeat_interleave(torch.arange(len(s)), count)
    unit = first[blk] + torch.arange(int(offsets[-1])) - offsets[blk]
    s0 = torch.maximum(s[blk], u0[unit]) - u0[unit]
    s1 = torch.minimum(e[blk], u0[unit + 1]) - u0[unit]
    part = (s0 > 0) | (s1 < units.n[unit])
    dest = torch.where(part, part.cumsum(0) - 1, -1)
    segs = torch.stack([units.tile[unit], units.b[unit], units.head[unit],
                        units.lo[unit], units.per[unit], s0, s1, dest], 1)
    shared, cnt = torch.unique_consecutive(unit[part], return_counts=True)
    p0 = cnt.cumsum(0) - cnt
    folds = torch.stack([units.tile[shared], units.b[shared],
                         units.head[shared], p0, cnt], 1)
    big = max([int(x.max()) for x in (segs, offsets, folds) if x.numel()]
              + [0])
    if big > 2 ** 31 - 1:
        raise ValueError(f"flash_attention_bwd: a schedule field of {big} "
                         f"exceeds 2^31 - 1 (int32)")
    return BwdTable(segs.int(), offsets.int(), folds.int(),
                    int(part.sum()))


class BwdWork(NamedTuple):
    """The CUDA-core backward's schedule: ``dq`` and ``dkdv``, each
    kernel's ``BwdTable`` over its ``bwd_units``, tiles of ``T`` rows;
    ``empty``: whether some query tile sees no key (its dq rows are not
    written) and whether some key tile is seen by no query (dk, dv)."""
    T: int
    dq: BwdTable
    dkdv: BwdTable
    empty: Tuple[bool, bool]

    def blocks(self) -> Tuple[int, int]:
        """The grids of the dq and the dk/dv kernel."""
        return self.dq.blocks(), self.dkdv.blocks()

    def workspace(self, D: int) -> int:
        """f32 elements of the workspace (csrc ``ws``): the dQ partials of
        ``T`` x D, then the dK and dV partials, two such tiles each."""
        return self.T * D * (self.dq.partials + 2 * self.dkdv.partials)

    def plan(self) -> torch.Tensor:
        """Both tables in one int32 tensor, in the launcher's order."""
        return torch.cat([x.reshape(-1) for t in (self.dq, self.dkdv)
                          for x in t[:3]])


def bwd_schedule(Sq: int, Skv: int, units, tables) -> BwdWork:
    """The ``BwdWork`` of ``tables`` (the dq and the dk/dv kernel's) over
    ``units`` (``bwd_units`` of these shapes)."""
    return BwdWork(BWD_T, *tables, tuple(
        len(torch.unique(u.tile)) < -(-S // BWD_T)
        for u, S in zip(units, (Sq, Skv))))


@functools.lru_cache(maxsize=256)
def bwd_work(B: int, Sq: int, Skv: int, H: int, KH: int, D: int, *,
             causal=True, window=None) -> BwdWork:
    """The CUDA-core backward's schedule (stream-K), from the shapes alone
    (cached: a call at seen shapes costs the host nothing): each kernel's
    units cut into spans of equal cost (``stream_k``), one a block, one
    block for each of the H100's ``SMS`` SMs, the dq kernel two at D <=
    128 (csrc: its launch bounds)."""
    uq, uk = bwd_units(B, Sq, Skv, H, KH, causal=causal, window=window)
    return bwd_schedule(Sq, Skv, (uq, uk), (
        bwd_table(uq, stream_k(uq, SMS * (2 if D <= 128 else 1))),
        bwd_table(uk, stream_k(uk, SMS))))


# each BwdWork's plan on a device, uploaded at its first call: (the work,
# kept alive so that its id is not reused, and the tensor)
_plans = {}


def _bwd_plan(work: BwdWork, device) -> torch.Tensor:
    key = (id(work), device)
    hit = _plans.get(key)
    if hit is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_attention_bwd: call it once at these shapes before "
                "capturing a CUDA graph (its schedule is copied to the "
                "device at the first call)")
        hit = _plans[key] = (work, work.plan().to(device))
    return hit[1]


def smem_bytes(D: int, lk: int, kernel: str = SIMT, elem: int = 4) -> int:
    """Dynamic shared memory of one block.  ``SIMT`` (csrc
    ``smem_bytes``): the scaled Q tile (64 rows of D + 4 f32), the
    ``cp.async`` ring's 4 slots in the inputs' type (``elem`` bytes), each
    a K slab of 64 keys x 80 or a V slab of 16 keys x (D + 16 / elem),
    the P tile (``ceil(lk / 64)`` x 64 keys of 68 f32) and seven per-row
    f32 vectors.  ``MMA`` (csrc ``Tile<DP>::kSmem``): the Q tile and the
    K/V ring's slots, each 64 rows of DP + 8 bf16 (``lk`` is its fixed
    64)."""
    if kernel == MMA:
        dp = next(d for d in MMA_DIMS if d >= D)
        return 2 * ROWS * (dp + 8) * (1 + MMA_SLOTS)
    slot = max(SUB * LDK, SLAB_V * (D + 16 // elem))
    nsub = -(-lk // SUB)
    return (4 * ROWS * (D + 4) + elem * STAGES * slot
            + 4 * (nsub * SUB * LDP + 7 * ROWS))


def _simt_lk(Skv: int, block_k: int, acc_dtype: str) -> int:
    return SUB if acc_dtype == "f32" else max(min(int(block_k), Skv), 1)


def kernel_tiles(H: int, KH: int, D: int, Skv: int, block_k: int,
                 acc_dtype: str, dtype):
    """The launch shape of the kernel that ``kernel_for(dtype, acc_dtype,
    D)`` picks, as ``(nc, bq, lk)``.  ``SIMT``: 16-byte column chunks of O
    a thread owns (1 for D <= 128, else 2), query positions per block, KV
    tile.  ``MMA``: the padded head dim's n8 tiles of O a warp (DP / 8),
    the block's 64 query positions of one head, the 64-key KV tile.
    Raises ``ValueError`` on what the kernel does not take."""
    if kernel_for(dtype, acc_dtype, D) == MMA:      # takes every such D
        return next(d for d in MMA_DIMS if d >= D) // 8, ROWS, SUB
    G = H // KH
    if G > ROWS:
        raise ValueError(f"flash_attention kernel takes GQA groups <= {ROWS}, "
                         f"got {G}")
    if not 0 < D <= 256 or D % 8:
        raise ValueError(f"flash_attention kernel takes head_dim <= 256 "
                         f"with head_dim % 8 == 0, got {D}")
    lk = _simt_lk(Skv, block_k, acc_dtype)
    if lk > MAX_LK:
        raise ValueError(f"flash_attention: a bf16-accumulator KV tile of "
                         f"{lk} keys > {MAX_LK}")
    elem = 2 if dtype == torch.bfloat16 else 4
    if smem_bytes(D, lk, elem=elem) > SMEM_LIMIT:
        raise ValueError(f"flash_attention: a KV tile of {lk} keys at "
                         f"head_dim {D} needs {smem_bytes(D, lk, elem=elem)} "
                         f"bytes of shared memory > {SMEM_LIMIT}")
    return (1 if D <= 128 else 2), ROWS // G, lk


def tile_range(i: int, bq: int, lk: int, Sq: int, Skv: int, causal: bool,
               window) -> Tuple[int, int]:
    """The KV tiles ``[lo, hi)`` of ``lk`` keys that hold a key the mask
    keeps for a row of query tile ``i`` (positions ``i * bq`` ..), as the
    kernel computes them (csrc ``tile_range``)."""
    nt = -(-Skv // lk)
    q0 = i * bq
    q_last = min(q0 + bq, Sq) - 1
    hi = min(q_last // lk + 1, nt) if causal else nt
    lo = max(q0 - window + 1, 0) // lk if window else 0
    return lo, max(hi, lo)


class Split(NamedTuple):
    """The CUDA-core kernel's work split: ``bq`` query positions a tile,
    ``lk`` keys a KV tile, ``nq`` query tiles, at most ``T`` KV tiles an
    item, at most ``smax`` items a query tile, and each query tile's KV
    tile range."""
    bq: int
    lk: int
    nq: int
    T: int
    smax: int
    ranges: Tuple[Tuple[int, int], ...]

    def items(self, i: int) -> List[Tuple[int, int]]:
        """Query tile ``i``'s items, each a KV tile range ``[jb, je)``: its
        range cut into ``max(1, ceil(n / T))`` near-equal parts (csrc)."""
        lo, hi = self.ranges[i]
        n = hi - lo
        ns = max(1, -(-n // self.T))
        return [(lo + s * n // ns, lo + (s + 1) * n // ns) for s in range(ns)]


@functools.lru_cache(maxsize=256)
def work_split(B: int, Sq: int, Skv: int, H: int, KH: int, *, causal=True,
               window=None, acc_dtype="f32", block_k=128) -> Split:
    """The CUDA-core kernel's split, from the shapes alone (cached: a call
    at seen shapes costs the host nothing).  With an f32 accumulator
    ``T`` is the KV tiles of the whole call over ``ITEMS_PER_SM * SMS``
    (at least 1); with a bf16 one every query tile is one item (``T`` =
    every KV tile)."""
    bq = ROWS // (H // KH)
    lk = _simt_lk(Skv, block_k, acc_dtype)
    nq = -(-Sq // bq)
    ranges = tuple(tile_range(i, bq, lk, Sq, Skv, causal, window)
                   for i in range(nq))
    if acc_dtype == "f32":
        work = B * KH * sum(hi - lo for lo, hi in ranges)
        T = max(1, -(-work // (ITEMS_PER_SM * SMS)))
    else:
        T = max(1, -(-Skv // lk))
    smax = max(max(1, -(-(hi - lo) // T)) for lo, hi in ranges)
    return Split(bq, lk, nq, T, smax, ranges)


def item_partial(q, k, v, q_lo: int, q_hi: int, k_lo: int, k_hi: int, *,
                 causal=True, window=None, softcap=None, scale=None):
    """One work item's partial in plain f32: ``(m, l, acc)`` of the query
    positions ``[q_lo, q_hi)`` over the keys ``[k_lo, k_hi)`` (clipped to
    Skv), m and l [B, n, H], acc [B, n, H, D]; masked keys score
    ``NEG_INF``."""
    D, G = q.shape[-1], q.shape[2] // k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    k_hi = min(k_hi, k.shape[1])
    qf = q[:, q_lo:q_hi].float() * scale
    kf = k[:, k_lo:k_hi].float().repeat_interleave(G, dim=2)
    vf = v[:, k_lo:k_hi].float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", qf, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(q_lo, q_hi, device=q.device)[:, None]
    kp = torch.arange(k_lo, k_hi, device=q.device)[None, :]
    ok = torch.ones_like(qp - kp, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= (qp - kp) < window
    s = torch.where(ok[None, :, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bqhk,bkhd->bqhd", p, vf)


def merge_partials(parts):
    """The merge kernel's fold of partials ``[(m, l, acc), ...]``: each
    weighted by exp(m_s - m*), m* the largest m; out = sum w acc /
    max(sum w l, 1e-30)."""
    m = torch.stack([p[0] for p in parts])
    w = torch.exp(m - m.amax(dim=0))
    l = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
    acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(dim=0)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def split_plain(q, k, v, *, causal=True, window=None, softcap=None,
                scale=None):
    """The f32-accumulator kernel's split in plain torch: every query
    tile's items (``work_split``) as ``item_partial``, folded by
    ``merge_partials``; a query tile with no KV tile gives 0, as the
    kernel does.  q [B,Sq,H,D]; k,v [B,Skv,KH,D] -> [B,Sq,H,D] f32."""
    B, Sq, H, _ = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    sp = work_split(B, Sq, Skv, H, KH, causal=causal, window=window)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    for i in range(sp.nq):
        q_lo, q_hi = i * sp.bq, min((i + 1) * sp.bq, Sq)
        parts = [item_partial(q, k, v, q_lo, q_hi, jb * sp.lk, je * sp.lk,
                              **kw) for jb, je in sp.items(i) if je > jb]
        if parts:
            out[:, q_lo:q_hi] = merge_partials(parts)
    return out


def _check_args(q, k, v, window, softcap, acc_dtype):
    """What both the kernel and the plain version require."""
    if acc_dtype not in ACC_DTYPES:
        raise ValueError(f"acc_dtype must be one of {sorted(ACC_DTYPES)}, "
                         f"got {acc_dtype!r}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,Sq,H,D] and k, v [B,Skv,KH,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, KH, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} KV heads")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty query or key sequence")
    if (window is not None and window <= 0) or (softcap is not None
                                                 and softcap <= 0):
        raise ValueError("window and softcap must be positive or None")


def _check_cuda(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q, k, v must be bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, block_q=128, block_k=128, acc_dtype="f32"):
    """q [B,Sq,H,D]; k,v [B,Skv,KH,D] -> [B,Sq,H,D] in q's dtype.

    Attention of every query over the keys, query i at position i and key
    j at position j: ``causal`` (top-left aligned), optional sliding
    ``window`` and logit ``softcap``, GQA (query head h reads KV head
    h // (H/KH)), online softmax with an ``acc_dtype`` accumulator.  With
    grad mode on and an input that requires grad, through
    ``FlashAttentionFn``, whose backward is ``flash_attention_bwd``."""
    _check_args(q, k, v, window, softcap, acc_dtype)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                      scale, block_q, block_k, acc_dtype)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale, block_q=block_q, block_k=block_k,
                    acc_dtype=acc_dtype)[0]


def flash_attention_with_lse(q, k, v, *, causal=True, window=None,
                             softcap=None, scale=None, block_q=128,
                             block_k=128, acc_dtype="f32"):
    """``flash_attention``'s forward (no autograd node) with the row
    log-sum-exp the backward takes: ``(out, lse)``, lse [B,H,Sq] f32 (+inf
    for a row with no kept key), which either forward kernel writes beside
    the same O (the bf16 accumulator's L from an unrounded f32 sum).  On
    the CPU lse is ``ref.flash_lse_plain``."""
    _check_args(q, k, v, window, softcap, acc_dtype)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale, block_q=block_q, block_k=block_k,
                    acc_dtype=acc_dtype, with_lse=True)


def _forward(q, k, v, *, causal, window, softcap, scale, block_q, block_k,
             acc_dtype, with_lse=False):
    """The forward kernels (or, on the CPU, the plain version), arguments
    checked and ``scale`` resolved: ``(out, lse)``, lse None unless
    ``with_lse``."""
    D = q.shape[-1]
    kernel = kernel_for(q.dtype, acc_dtype, D)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, block_q=block_q,
                                    block_k=block_k, acc_dtype=acc_dtype,
                                    **kw)
        return out, flash_lse_plain(q, k, **kw) if with_lse else None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    _check_cuda(q, k, v)
    B, Sq, H, _ = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    nc, bq, lk = kernel_tiles(H, KH, D, Skv, block_k, acc_dtype, q.dtype)
    if kernel == MMA and (B > 65535 or -(-Sq // ROWS) > 65535):
        raise ValueError(f"flash_attention_mma: a grid of B={B} x "
                         f"{-(-Sq // ROWS)} query tiles exceeds 65535")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (int(bool(causal)), int(window) if window else 0,
            float(softcap) if softcap else 0.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if kernel == MMA:
        rc = _launcher(MMA)(*ptrs, lse.data_ptr() if with_lse else None, B,
                            Sq, Skv, H, KH, D, scale, *tail)
    else:
        sp = work_split(B, Sq, Skv, H, KH, causal=bool(causal),
                        window=int(window) if window else None,
                        acc_dtype=acc_dtype, block_k=int(block_k))
        if B * KH * sp.nq * sp.smax > 2 ** 31 - 1:
            raise ValueError(f"flash_attention: {B * KH * sp.nq * sp.smax} "
                             f"blocks exceed 2^31 - 1")
        ws = None
        if sp.smax > 1:     # split partials: m, l and acc of every item
            ws = torch.empty(B * KH * sp.nq * sp.smax * ROWS * (D + 2),
                             dtype=torch.float32, device=q.device)
        rc = _launcher(SIMT)(*ptrs, ws.data_ptr() if ws is not None else None,
                             lse.data_ptr() if with_lse else None,
                             int(q.dtype == torch.bfloat16), B, Sq, Skv, H,
                             KH, D, nc, bq, lk, sp.T, sp.smax,
                             int(acc_dtype == "bf16"), scale, *tail)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed (rc={rc})")
    flash_attention.launches += 1
    if kernel == MMA:
        flash_attention.mma_launches += 1
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernels, then
    ``flash_attention_bwd`` on the saved q, k, v, output and row
    log-sum-exp.  Arguments after v are ``flash_attention``'s
    keywords in order (``scale`` resolved); they get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, block_q,
                block_k, acc_dtype):
        out, lse = _forward(q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale, block_q=block_q,
                            block_k=block_k, acc_dtype=acc_dtype,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale, acc_dtype=acc_dtype)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, out, d_out, lse, **ctx.kw)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) \
            + (None,) * 7


def flash_attention_bwd(q, k, v, out, d_out, lse=None, *, causal=True,
                        window=None, softcap=None, scale=None,
                        acc_dtype="f32"):
    """(dq, dk, dv) of ``flash_attention(q, k, v, ..., acc_dtype=...)`` at
    the output ``out``, its row log-sum-exp ``lse`` and the cotangent
    ``d_out`` (cast to q's dtype and made contiguous, as autograd may hand
    it over strided), in q's dtype.  ``bwd_kernel_for`` picks the kernel,
    ``BWD_MMA`` (bf16, f32 accumulator, D % 16 == 0) or ``BWD``; both take
    ``lse`` [B,H,Sq] f32 from ``flash_attention_with_lse`` and raise
    without it.  On CUDA tensors the kernels (one launch counted in
    ``flash_attention.bwd_launches``, and in ``bwd_mma_launches`` for the
    tensor-core one); on CPU tensors their plain versions."""
    _check_args(q, k, v, window, softcap, acc_dtype)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if out.shape != q.shape or d_out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and d_out "
                         f"{tuple(d_out.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    kernel = bwd_kernel_for(q.dtype, acc_dtype, D)
    if (lse is None or lse.shape != (B, H, Sq)
            or lse.dtype != torch.float32):
        raise ValueError(f"{kernel} takes the forward's lse, f32 "
                         f"[{B}, {H}, {Sq}]; got "
                         f"{None if lse is None else (lse.dtype, tuple(lse.shape))}")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    d_out = d_out.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        if kernel == BWD_MMA:
            return flash_attention_bwd_mma_plain(q, k, v, out, d_out, lse,
                                                 **kw)
        return flash_attention_bwd_plain(q, k, v, out, d_out, lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU, not "
                         f"{q.device}")
    _check_cuda(q, k, v)
    if out.dtype != q.dtype or not out.is_contiguous():
        raise ValueError("out must be contiguous in q's dtype")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_bwd takes B, H <= 65535; got "
                         f"{tuple(q.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (scale, int(bool(causal)), int(window) if window else 0,
            float(softcap) if softcap else 0.0, stream)
    for name, t in (("out", out), ("d_out", d_out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be contiguous on q's device")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if kernel == BWD_MMA:
        rc = _launcher(BWD_MMA)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            d_out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, Sq, Skv, H, KH, D,
            bwd_split(B, Skv, H, KH), *tail)
    else:
        if D > 256 or D % 8:
            raise ValueError(f"flash_attention_bwd takes head_dim <= 256 "
                             f"with head_dim % 8 == 0; got {tuple(q.shape)}")
        w = bwd_work(B, Sq, Skv, H, KH, D, causal=bool(causal),
                     window=int(window) if window else None)
        plan = _bwd_plan(w, q.device)
        # rows that no key (no query) reaches are not written: zero them
        for t, empty in zip((dq, dk, dv), w.empty + w.empty[1:]):
            if empty:
                t.zero_()
        ws = torch.empty(max(w.workspace(D), 1), dtype=torch.float32,
                         device=q.device)
        rc = _launcher(BWD)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            d_out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), ws.data_ptr(), plan.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Skv, H, KH, D,
            *(len(x) for t in (w.dq, w.dkdv) for x in t[:3]),
            w.dq.partials, *tail)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed (rc={rc})")
    flash_attention.bwd_launches += 1
    if kernel == BWD_MMA:
        flash_attention.bwd_mma_launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.mma_launches = 0
flash_attention.bwd_launches = 0
flash_attention.bwd_mma_launches = 0
