"""Paged KV-cache bookkeeping: block allocator, per-request block tables,
and copy-on-retire compaction planning.  The port's own copy of
``repro.serve.paging`` (pure Python; the port imports nothing of ``repro``).

The physical KV store is a fixed pool of ``n_blocks`` blocks of
``block_size`` token slots each (one pool shared by every layer — the
device tensors are ``[L, n_blocks + 1, block_size, KH, hd]`` with a trash
page last, allocated once by ``Model.init_paged_cache``).  A request owns a *block table*: the list
of physical block ids backing its logical token positions, grown one block
at a time as prefill chunks land and decode extends the context.  Slot
granularity therefore drops from ``max_len`` tokens (the slot engine's
per-sequence stripe) to ``block_size`` tokens, which is exactly the access
granularity the paper's hierarchy tables say governs realized memory cost.

Everything in this module is host-side Python over plain ints, so the allocator can be property-tested exhaustively and the engine's
device arrays stay pure data.  Determinism: ``alloc`` always hands out the
lowest free block id, so identical request traces produce identical block
tables (and identical gather indices) run over run.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to back ``n_tokens`` logical slots."""
    return -(-max(n_tokens, 0) // block_size)


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks.

    ``alloc`` pops the lowest free id (deterministic layouts);
    ``free`` returns blocks to the pool; ``check`` asserts the
    free/allocated sets always partition the pool (the leak invariant the
    property tests and the CI smoke step pin down).
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError("n_blocks and block_size must be positive")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(n_blocks))
        heapq.heapify(self._free)
        self._allocated: set[int] = set()
        self.peak_in_use = 0

    # -- core -----------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return len(self._allocated)

    @property
    def occupancy(self) -> float:
        return self.n_in_use / self.n_blocks

    def alloc(self) -> Optional[int]:
        """Lowest free block id, or None when the pool is exhausted."""
        if not self._free:
            return None
        b = heapq.heappop(self._free)
        self._allocated.add(b)
        self.peak_in_use = max(self.peak_in_use, self.n_in_use)
        return b

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"double free / foreign block {b}")
            self._allocated.remove(b)
            heapq.heappush(self._free, b)

    def check(self) -> None:
        """Assert the pool invariant: free ⊎ allocated == [0, n_blocks)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate ids on the free list")
        if free & self._allocated:
            raise AssertionError("block both free and allocated")
        if free | self._allocated != set(range(self.n_blocks)):
            raise AssertionError("pool leaked or grew")

    # -- compaction -----------------------------------------------------------
    def watermark(self) -> int:
        """1 + the highest allocated block id (0 when empty): the span of
        the physical pool that decode gathers can touch."""
        return max(self._allocated) + 1 if self._allocated else 0

    def compaction_plan(self) -> Optional[Tuple[List[int], List[int]]]:
        """Plan a copy-on-retire compaction: map the allocated blocks,
        in ascending id order, onto the lowest ids.  Returns ``(src, dst)``
        move lists (only ids that actually move), or None when the
        allocation is already dense.  The caller must copy the physical
        pages ``src -> dst`` (gather-then-scatter, so overlap is safe),
        remap every live block table through :func:`apply_remap`, and then
        call :meth:`commit_compaction`.
        """
        used = sorted(self._allocated)
        moves = [(s, d) for d, s in enumerate(used) if s != d]
        if not moves:
            return None
        return [s for s, _ in moves], [d for _, d in moves]

    def commit_compaction(self) -> None:
        """Re-key the pool after the physical copy: allocated blocks become
        ``[0, n_in_use)`` and everything above is free again."""
        n = self.n_in_use
        self._allocated = set(range(n))
        self._free = list(range(n, self.n_blocks))
        heapq.heapify(self._free)


def remap_table(table: Sequence[int], src: Sequence[int],
                dst: Sequence[int]) -> List[int]:
    """Rewrite one block table through a compaction move list (-1 entries —
    unbacked logical blocks — pass through untouched)."""
    m: Dict[int, int] = dict(zip(src, dst))
    return [m.get(b, b) for b in table]
