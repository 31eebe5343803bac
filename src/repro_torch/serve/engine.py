"""Paged serving engine: continuous batching over a block-paged KV pool
with chunked prefill, ported from ``repro.serve.engine.PagedServingEngine``
(its fused path).

* The KV store is one pool of ``n_blocks`` blocks (``serve.paging``),
  preallocated on the device and updated in place by every step (this
  stands in for JAX's buffer donation).  Requests own block tables.
* Prompts prefill in fixed ``chunk_size`` chunks through the decode path
  (``serve.scheduler``): the final chunk overlaps already written
  positions, short prompts are left-padded with negative write positions,
  and the pool drops those writes.
* When the pool runs dry the youngest placed request is evicted and
  replayed from scratch later; the oldest is never evicted, so the engine
  always makes progress.  Retiring a request may compact the pool
  (copy-on-retire) so the allocated blocks stay dense.
* The decode step samples greedily on the device, tokens stay resident on
  the device between steps, block tables upload only when a row mutates
  (``stats.table_uploads``), and the loop is pipelined one step ahead:
  step N+1 is dispatched before step N's ``[2, B]`` token echo (inputs and
  outputs) is read back.  Every device->host read goes through ``_sync``
  (``stats.host_syncs``), so a run can be checked for one sync per step;
  under ``torch.cuda.set_sync_debug_mode("error")`` any other sync raises.
* Profiler spans: ``prefill_chunk``, ``decode_step`` and ``sync`` mark
  the engine's three kinds of work for ``torch.profiler``
  (``launch/serve.py --profile`` reads them).

Not ported yet (each raises ``NotImplementedError`` when passed):
``cost_model=``, ``autotuner=``, ``telemetry=``, ``mesh=``, ``fused=False``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.models.zoo import Model
from repro_torch.serve.paging import (BlockAllocator, blocks_for_tokens,
                                      remap_table)
from repro_torch.serve.scheduler import ChunkedPrefillScheduler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineStats:
    """Cumulative counters, as the JAX engine's (less those of the
    cost-model, telemetry and cluster layers, which are not ported yet)."""
    steps: int = 0
    prefills: int = 0               # completed prefills (net of evictions)
    decoded_tokens: int = 0         # delivered tokens (replays rolled back)
    completed: int = 0
    host_syncs: int = 0             # device->host reads (via _sync)
    table_uploads: int = 0          # block-table host->device uploads
    decode_dispatches: int = 0      # batched decode steps launched
    prefill_chunks: int = 0
    preemptions: int = 0
    compactions: int = 0
    peak_blocks_in_use: int = 0
    integrity_failures: int = 0     # corrupted step echoes dropped


def _echo_ok(arr: np.ndarray) -> bool:
    """Integrity probe over the synced ``[2, B]`` echo: token ids are
    non-negative by construction, so a negative value means a corrupt
    step."""
    return bool((arr >= 0).all())


@dataclasses.dataclass
class _Row:
    """One decode row: the request it serves plus its prefill progress
    (the row's block table lives in ``engine.block_tables``)."""
    req: Request
    filled: int = 0                 # prompt tokens whose K/V are written
    ready: bool = False             # prefill complete; decodes each step
    pos: int = 0                    # context length == next write position
    dispatched: int = 0             # decode dispatches incl. in-flight


class PagedServingEngine:
    """Continuous batching over a paged KV cache with chunked prefill.

    ``n_blocks`` defaults to the slot-equivalent pool (``max_batch x
    ceil(max_len / block_size)``); a smaller pool serves the same traffic
    in less memory, with eviction keeping the engine correct."""

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_len: int = 512, block_size: int = 16,
                 n_blocks: Optional[int] = None, chunk_size: int = 32,
                 cost_model=None, autotuner=None, telemetry=None, mesh=None,
                 fused: bool = True):
        unported = {"cost_model": cost_model, "autotuner": autotuner,
                    "telemetry": telemetry, "mesh": mesh}
        for name, val in unported.items():
            if val is not None:
                raise NotImplementedError(f"{name}= is not ported yet")
        if not fused:
            raise NotImplementedError("fused=False is not ported yet")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks_per_seq = blocks_for_tokens(max_len, block_size)
        if n_blocks is None:
            n_blocks = max_batch * self.max_blocks_per_seq
        if n_blocks < self.max_blocks_per_seq:
            # one sequence must always be able to reach max_len, or the
            # oldest-request progress guarantee (and so termination) breaks
            raise ValueError(
                f"n_blocks={n_blocks} < blocks for one max_len sequence "
                f"({self.max_blocks_per_seq})")
        self.n_blocks = n_blocks
        self.allocator = BlockAllocator(n_blocks, block_size)
        self.scheduler = ChunkedPrefillScheduler(chunk_size)
        self.chunk_size = chunk_size
        self.cache = model.init_paged_cache(n_blocks, block_size)
        self.block_tables = np.full(
            (max_batch, self.max_blocks_per_seq), -1, np.int32)
        self._bt_dev = None             # device copy of block_tables
        self.rows: List[Optional[_Row]] = [None] * max_batch
        self.done: Dict[int, Request] = {}
        self.stats = EngineStats()
        self._rid = itertools.count()
        self._pending = None
        self._step_fn = model.decode_step
        self._toks = self._dev(np.zeros(max_batch, np.int32))

    # -- public ---------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            # rejected here: mid-trace it would outgrow the block table
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit "
                             f"max_len={self.max_len} (needs >= 1 decode "
                             "slot)")
        rid = next(self._rid)
        self.scheduler.submit(Request(rid, prompt, max_new_tokens, eos_id))
        return rid

    @property
    def queue(self):
        return self.scheduler.queue

    def kv_cache_bytes(self) -> int:
        """Resident bytes of the paged pool (trash page included)."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.cache.values()))

    # -- host <-> device ------------------------------------------------------
    def _dev(self, x) -> torch.Tensor:
        """THE host->device boundary for per-step operands.  On the card
        the copy is asynchronous from pinned memory (the caching host
        allocator keeps the buffer alive until the copy ran), so an upload
        never blocks the host on the device."""
        t = torch.from_numpy(np.array(x, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _stage(self, x: torch.Tensor):
        """Start the device->host copy of ``x`` right behind the work that
        produces it, so a later ``_sync`` waits for that work only, not for
        steps dispatched after it."""
        if self.device.type != "cuda":
            return x.clone(), None
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    def _sync(self, staged) -> np.ndarray:
        """THE device->host boundary: every value the engine reads back
        crosses here, counted.  The wait is on the staged copy's event, with
        sync debugging lifted for that one declared wait."""
        self.stats.host_syncs += 1
        buf, ev = staged
        if ev is not None:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                with record_function("sync"):
                    ev.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return buf.numpy().copy()

    def _bt_device(self):
        """The device block tables, uploaded only after a row mutated."""
        if self._bt_dev is None:
            self._bt_dev = self._dev(self.block_tables)
            self.stats.table_uploads += 1
        return self._bt_dev

    # -- block management -----------------------------------------------------
    def _retirement_bound(self, row: _Row) -> bool:
        """True when the row cannot legitimately decode again: its
        retirement (cache ceiling or token budget) is already in the
        pending drain, so a further dispatch would be a pure shadow step."""
        if row.dispatched > 0 and row.pos >= self.max_len - 1:
            return True
        return row.dispatched >= max(row.req.max_new_tokens - 1, 1)

    def _row_blocks(self, idx: int) -> List[int]:
        return [int(b) for b in self.block_tables[idx] if b >= 0]

    def _free_row(self, idx: int) -> None:
        self.allocator.free(self._row_blocks(idx))
        self.block_tables[idx] = -1
        self._bt_dev = None
        self.rows[idx] = None

    def _placed(self) -> List[int]:
        return [i for i, r in enumerate(self.rows) if r is not None]

    def _evict_for(self, needy: int) -> bool:
        """Evict the youngest placed request other than ``needy`` and the
        oldest (never evicted: that guarantees termination).  Returns False
        when no eligible victim exists."""
        placed = self._placed()
        oldest = min(placed, key=lambda i: self.rows[i].req.rid)
        cands = [i for i in placed if i != needy and i != oldest]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self.rows[i].req.rid)
        row = self.rows[victim]
        req = row.req
        self._free_row(victim)
        # the victim replays from scratch: roll back its delivered tokens
        # (``row.ready`` keys it: a ready row's first token may still be in
        # flight in the echo)
        if row.ready:
            self.stats.decoded_tokens -= max(len(req.tokens) - 1, 0)
            self.stats.prefills -= 1
        req.tokens.clear()
        self.scheduler.requeue(req)
        self.stats.preemptions += 1
        return True

    def _ensure_blocks(self, idx: int, n_needed: int) -> bool:
        """Grow row ``idx``'s table to ``n_needed`` blocks, evicting if the
        pool is dry.  Returns False when the row must wait."""
        if n_needed > self.max_blocks_per_seq:
            raise AssertionError(
                f"row {idx} needs {n_needed} blocks > table width "
                f"{self.max_blocks_per_seq}")
        bt = self.block_tables[idx]
        have = int((bt >= 0).sum())
        while have < n_needed:
            b = self.allocator.alloc()
            if b is None:
                if not self._evict_for(idx):
                    return False
                continue
            bt[have] = b
            have += 1
            self._bt_dev = None
        return True

    def _maybe_compact(self) -> None:
        """Copy-on-retire compaction: move the allocated blocks down to the
        lowest ids (a gather then a scatter per pool, so overlapping moves
        are safe) and remap every live table."""
        plan = self.allocator.compaction_plan()
        if plan is None:
            return
        src, dst = plan
        s = self._dev(np.asarray(src, np.int64))
        d = self._dev(np.asarray(dst, np.int64))
        for pool in self.cache.values():
            pool[:, d] = pool[:, s]
        for i in self._placed():
            self.block_tables[i] = remap_table(
                list(self.block_tables[i]), src, dst)
        self._bt_dev = None
        self.allocator.commit_compaction()
        self.stats.compactions += 1

    # -- prefill chunks -------------------------------------------------------
    def _place(self, req: Request) -> Optional[int]:
        free = [i for i, r in enumerate(self.rows) if r is None]
        if not free:
            return None
        idx = free[0]
        self.rows[idx] = _Row(req)
        self.scheduler.take(req)
        return idx

    def _run_chunk(self, idx: int) -> None:
        """Advance row ``idx``'s prefill by one ``chunk_size`` chunk.  The
        final chunk overlaps written positions (rewriting identical K/V);
        prompts shorter than a chunk are left-padded at negative positions,
        whose writes the pool drops.  The final chunk's greedy token lands
        in the device token array; it reaches ``req.tokens`` through the
        first decode step's echo."""
        row = self.rows[idx]
        req, C = row.req, self.chunk_size
        S = len(req.prompt)
        end = min(row.filled + C, S)
        start = end - C              # < filled on overlap, < 0 on left-pad
        if not self._ensure_blocks(idx, blocks_for_tokens(end,
                                                          self.block_size)):
            return                   # pool dry, no victim: retry next step
        if self.rows[idx] is not row:
            return                   # the eviction chain took this row
        toks = np.zeros(C, np.int32)
        lo = max(start, 0)
        toks[C - (end - lo):] = req.prompt[lo:end]
        with record_function("prefill_chunk"):
            bt = self._bt_device()[idx:idx + 1]
            nxt, _ = self._step_fn(self.params, self.cache,
                                   self._dev(toks[None]),
                                   self._dev(np.asarray([start], np.int32)),
                                   bt)
            if end == S:
                self._toks[idx:idx + 1].copy_(nxt[:1])
        row.filled = end
        self.stats.prefill_chunks += 1
        if end == S:
            row.ready = True
            row.pos = S
            self.stats.prefills += 1

    # -- the engine iteration -------------------------------------------------
    def step(self) -> int:
        """One iteration: plan, run prefill chunks, dispatch the decode,
        then drain the PREVIOUS step, so step N's tokens are read only
        after step N+1 is queued on the device.  Returns the number of
        placed rows (>= 1 while a step is still in flight)."""
        prev, self._pending = self._pending, None
        unfinished = sorted(
            ((i, self.rows[i].req.rid, self.rows[i].req)
             for i in self._placed() if not self.rows[i].ready),
            key=lambda t: t[1])
        n_free = self.rows.count(None)
        any_ready = any(r is not None and r.ready for r in self.rows)
        if not unfinished and not any_ready and not self.scheduler.queue:
            self._drain(prev)        # flush the tail step, if any
            return 0
        plan = self.scheduler.plan(
            unfinished=unfinished, n_free_rows=n_free, any_ready=any_ready,
            decode_s=0.0, chunk_s=0.0, gated=False)

        for item in plan.items:
            if item.row is None:
                idx = self._place(item.request)
                if idx is None:      # an eviction refilled the rows
                    continue
            else:
                idx = item.row
                if (self.rows[idx] is None
                        or self.rows[idx].req.rid != item.rid):
                    continue         # evicted mid-step; replanned later
            self._run_chunk(idx)

        active = self._decode_phase()
        self.stats.peak_blocks_in_use = self.allocator.peak_in_use
        did_work = bool(plan.items) or active
        self._drain(prev)
        if did_work:
            self.stats.steps += 1
        n = len(self._placed())
        return n if self._pending is None else max(n, 1)

    def _decode_phase(self) -> int:
        """Batched decode over the ready rows; rows mid-prefill (or whose
        block growth must wait) ride along masked out at write_pos = -1."""
        ready = [i for i in self._placed() if self.rows[i].ready]
        if not ready:
            return 0
        stepping = []
        for i in ready:
            row = self.rows[i]
            if row is None or not row.ready:
                continue             # evicted by an earlier row's growth
            if self._retirement_bound(row):
                continue             # its retirement is in the pending drain
            need = blocks_for_tokens(row.pos + 1, self.block_size)
            if self._ensure_blocks(i, need) and self.rows[i] is row:
                stepping.append((i, row))
        # a LATER row's growth may have evicted a row collected above
        stepping = [(i, row) for i, row in stepping if self.rows[i] is row]
        if not stepping:
            return 0
        pos = np.full(self.max_batch, -1, np.int32)
        for i, row in stepping:
            pos[i] = row.pos
        with record_function("decode_step"):
            pos_dev = self._dev(pos)
            nxt, _ = self._step_fn(self.params, self.cache,
                                   self._toks[:, None], pos_dev,
                                   self._bt_device())
            io = torch.stack([self._toks, nxt])      # input echo + outputs
            # masked rows (pos < 0) keep their resident token
            self._toks = torch.where(pos_dev >= 0, nxt, self._toks)
        self.stats.decode_dispatches += 1
        # the snapshot carries each row's post-step position for the
        # retire checks at drain time (row.pos may advance again first)
        self._pending = (self._stage(io),
                         [(i, row, row.pos + 1) for i, row in stepping])
        for i, row in stepping:
            row.pos += 1
            row.dispatched += 1
        return len(stepping)

    def _drain(self, pending) -> None:
        """Sync and book one in-flight step; rows evicted or retired since
        dispatch are dropped by identity, so replays and shadow steps never
        double-count."""
        if pending is None:
            return
        staged, snap = pending
        arr = self._sync(staged)
        if not _echo_ok(arr):
            self.stats.integrity_failures += 1
            return
        in_t, out_t = arr[0], arr[1]
        for i, row, pos_after in snap:
            if self.rows[i] is not row:
                continue
            req = row.req
            if not req.tokens:
                req.tokens.append(int(in_t[i]))      # echoed prefill token
            req.tokens.append(int(out_t[i]))
            self.stats.decoded_tokens += 1
            hit_eos = req.eos_id is not None and req.tokens[-1] == req.eos_id
            out_of_budget = len(req.tokens) >= req.max_new_tokens
            out_of_cache = pos_after >= self.max_len - 1
            if hit_eos or out_of_budget or out_of_cache:
                self._retire(i)

    def _retire(self, idx: int) -> None:
        req = self.rows[idx].req
        self.done[req.rid] = req
        self._free_row(idx)
        self.stats.completed += 1
        self._maybe_compact()

    def run_until_done(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            active = self.step()
            if active == 0 and not self.scheduler.queue:
                break
        if self._pending is not None:        # max_steps exhausted mid-flight
            self._drain(self._pending)
            self._pending = None
        self.allocator.check()
        return self.stats
