"""Serving engines, ported from ``repro.serve.engine``:
``ServingEngine`` with slot-granular KV stripes, and
``PagedServingEngine`` with a block-paged pool and chunked prefill.

Both keep the fused hot path of the JAX engines (``fused=True``, the
default):

* The KV store is preallocated on the device and updated in place by every
  step and every admission (this stands in for JAX's buffer donation).
* The decode step samples greedily on the device, tokens (and, for the
  slot engine, positions) stay resident on the device between steps, and
  the loop is pipelined one step ahead: step N+1 is dispatched before step
  N's ``[2, B]`` token echo (inputs and outputs) is read back.  Every
  device->host read goes through ``_sync`` (``stats.host_syncs``), so a
  run can be checked for one sync per step; under
  ``torch.cuda.set_sync_debug_mode("error")`` any other sync raises.

``ServingEngine``: every admitted request reserves a full ``max_len``
stripe of the ``[L, max_batch, max_len, KH, hd]`` slot cache.  Admission
runs one uncached prefill per request (``Model.prefill``, whose attention
is the flash-attention kernel on the card), splices its cache into the
slot and sets the slot's device token (argmax) and position, with nothing
crossing to the host.  The step decodes every slot, free ones included,
as the JAX engine's does; rows are independent, so a free slot's writes
(clamped to its own stripe) touch no live row.

``PagedServingEngine``:

* The KV store is one pool of ``n_blocks`` blocks (``serve.paging``);
  requests own block tables, uploaded only when a row mutates
  (``stats.table_uploads``).
* Prompts prefill in fixed ``chunk_size`` chunks through the decode path
  (``serve.scheduler``): the final chunk overlaps already written
  positions, short prompts are left-padded with negative write positions,
  and the pool drops those writes.
* When the pool runs dry the youngest placed request is evicted and
  replayed from scratch later; the oldest is never evicted, so the engine
  always makes progress.  Retiring a request may compact the pool
  (copy-on-retire) so the allocated blocks stay dense.

Admission is priced by a ``repro_torch.core.costmodel.CostModel`` when
one is passed (``cost_model=``): with a ``step_budget_s`` as well, an
iteration admits prefills (slot) or prefill chunks (paged) only while the
predicted iteration time - the decode step plus what it admits - stays
within the budget, and always at least one.  Pricing is cached host
arithmetic over analytic censuses: it launches nothing on the card and
reads nothing back.  Each counted step appends its predicted time and the
host's measured time (``stats.predicted_step_s``/``measured_step_s``);
steps are asynchronous with one drain, so the measured time is the host's
time per iteration, not the device's.

``fused=False`` keeps the JAX engines' legacy blocking path, the baseline
of the ``decode_hotpath`` experiment: every step uploads its tokens (and
positions) fresh from host arrays, ``Model.decode`` returns the ``[B,
vocab]`` logits, an eager argmax runs over them and one blocking ``_sync``
reads the tokens back; tokens are booked and rows retired at once, with no
pipelining.  A prefill's (slot) or a prompt's final chunk's (paged) first
token is read back through its own ``_sync``.  The JAX legacy step is
undonated, so XLA writes a new cache every step; here the step writes into
a fresh copy of the KV store (``_copy_store``) and swaps it in before
anything else touches the store, so its peak device memory holds two
stores, as the reference's does.

Profiler spans: ``prefill`` (slot admission), ``prefill_chunk``,
``decode_step`` and ``sync`` mark the engines' kinds of work for
``torch.profiler`` (``launch/serve.py --profile`` reads them).

Both engines take ``autotuner=`` (a ``repro_torch.core.autotune.
Autotuner``): ``step()`` installs it as the process-global tuning handle
for one iteration, so every kernel called with ``tuned=True`` resolves its
launch config from that tuner's cache, and restores the previous handle
after.  ``PagedServingEngine`` also reads the tuner's ``paged_attention``
entry when it lays out its pool: ``block_size=None`` takes the tuned page
size (16 without a tuner), and ``kernel_chunk``, the tuned chunk, is
passed to every paged decode explicitly.

Both engines take ``clock=`` (any object with ``time()`` and
``perf_counter()``, the ``time`` module by default; ``serve.sim.SimClock``
scripts it): every step's measured time and every submit and retirement
stamp (``Request.submitted_s``/``finished_s``) reads it.  And both take
``telemetry=`` (a ``serve.telemetry.TelemetryController``, bound at
construction): ``_step_budget`` asks its ``begin_step()`` first (an SLO
token bucket's budget, else the static ``step_budget_s``), each productive
step hands it one ``StepRecord`` (``on_step``), built from host values
only (no device read, no upload), with ``measured_s`` the span of
``_record_step``, and each retirement one request (``on_retire``).

Not ported yet: ``mesh=`` (paged) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ShapeCell
from repro_torch.core import autotune
from repro_torch.core.costmodel.analytic import analytic_census
from repro_torch.core.costmodel.model import CostModel, Prediction
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import CHUNK_TOKENS
from repro_torch.models.zoo import Model
from repro_torch.serve.paging import (BlockAllocator, blocks_for_tokens,
                                      remap_table)
from repro_torch.serve.scheduler import ChunkedPrefillScheduler
from repro_torch.serve.telemetry.metrics import StepRecord


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0        # clock.time() at submit
    finished_s: float = 0.0         # clock.time() at retirement


@dataclasses.dataclass
class EngineStats:
    """Cumulative counters, as the JAX engine's."""
    steps: int = 0
    prefills: int = 0               # completed prefills (net of evictions)
    decoded_tokens: int = 0         # delivered tokens (replays rolled back)
    completed: int = 0
    deferred_prefills: int = 0      # admissions the budget pushed later
    host_syncs: int = 0             # device->host reads (via _sync)
    table_uploads: int = 0          # block-table host->device uploads
    decode_dispatches: int = 0      # batched decode steps launched
    # with a cost model, one entry per counted step: the predicted time of
    # the iteration and the host's time for it (seconds)
    predicted_step_s: List[float] = dataclasses.field(default_factory=list)
    measured_step_s: List[float] = dataclasses.field(default_factory=list)
    prefill_chunks: int = 0
    preemptions: int = 0
    compactions: int = 0
    peak_blocks_in_use: int = 0
    # paged: the pool's occupancy after each counted step
    block_occupancy: List[float] = dataclasses.field(default_factory=list)
    admission_order: List[int] = dataclasses.field(default_factory=list)
    integrity_failures: int = 0     # corrupted step echoes dropped


def _echo_ok(arr: np.ndarray) -> bool:
    """Integrity probe over the synced ``[2, B]`` echo: token ids are
    non-negative by construction, so a negative value means a corrupt
    step."""
    return bool((arr >= 0).all())


def _analytic_prefill_prediction(cost_model, cfg, n_tokens: int
                                 ) -> Prediction:
    """Price a prefill of ``n_tokens`` from its analytic census.  The one
    pricer both engines' cached ``_predict_*`` methods wrap, so slot and
    paged admission never price the same prompt differently."""
    cell = ShapeCell("admission", "prefill", n_tokens, 1)
    return cost_model.predict(analytic_census(cfg, cell, n_devices=1,
                                              n_model=1))


class _DeviceLoop:
    """What both engines share: the run loop, the KV store's size, the
    host<->device boundary (uploads through ``_dev``, staged read-backs
    through ``_stage`` / ``_sync``) and the cost-model pricing of a step."""

    device: torch.device
    stats: EngineStats
    cache: Dict[str, torch.Tensor]
    cost_model: Optional[CostModel]
    step_budget_s: Optional[float]
    _pred_cache: Dict
    autotuner = None
    telemetry = None
    engine_name = "slot"        # a step record's ``engine``
    # the paged decode attention with the engine's resolved launch config
    # (None: the layers' default, tuned dispatch)
    _paged_fn = None

    def step(self) -> int:
        """One iteration (``_step``), with the engine's autotuner installed
        as the tuning handle for its duration only, so ``tuned=True``
        kernel lookups hit this engine's cache without leaking a
        process-global handle."""
        if self.autotuner is not None:
            with autotune.using(self.autotuner):
                return self._step()
        return self._step()

    def run_until_done(self, max_steps: int = 10_000) -> EngineStats:
        """Step until every request is done (or ``max_steps``), then
        drain a step still in flight."""
        for _ in range(max_steps):
            active = self.step()
            if active == 0 and not self.queue:
                break
        if self._pending is not None:        # max_steps exhausted mid-flight
            self._drain(self._pending)
            self._pending = None
        return self.stats

    def kv_cache_bytes(self) -> int:
        """Resident bytes of the preallocated KV store: the slot stripes,
        or the paged pool with its trash page.  Fused steps update it in
        place, so this is also its peak; a legacy step holds two."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.cache.values()))

    @staticmethod
    def _copy_store(cache: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The legacy step's fresh store: a copy of every KV tensor."""
        return {k: t.clone() for k, t in cache.items()}

    def _decode_legacy(self, tokens: np.ndarray, pos: np.ndarray,
                       block_tables=None) -> torch.Tensor:
        """One legacy ``Model.decode`` call: tokens and positions uploaded
        fresh from host arrays, the step written into a copy of the store,
        which is swapped in before it returns (so compaction, eviction and
        admission only ever write the live store); returns the logits."""
        store = self._copy_store(self.cache)
        logits, _ = self.model.decode(self.params, store, self._dev(tokens),
                                      self._dev(pos), block_tables,
                                      paged_fn=self._paged_fn)
        self.cache = store
        return logits

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

    def _bind(self, clock, telemetry) -> None:
        """Take the clock and bind the controller where the JAX engines
        bind it: once ``max_batch`` is set and before ``chunk_size`` is, so
        the controller's chunk bucket stays empty and only pure-decode
        steps feed its drift detector, as in the reference."""
        self._clock = clock if clock is not None else time
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.bind(self)

    # -- cost-model pricing ---------------------------------------------------
    def _step_budget(self) -> Optional[float]:
        """The admission budget of this iteration: the SLO token bucket's
        when the telemetry controller carries one (refilled here: call once
        an iteration), else the static ``step_budget_s``.  Either number
        feeds the same gate arithmetic."""
        if self.telemetry is not None:
            budget = self.telemetry.begin_step()
            if budget is not None:
                return budget
        return self.step_budget_s

    def set_cost_model(self, cost_model) -> None:
        """Swap the pricing model; every later admission re-prices against
        the new tables."""
        self.cost_model = cost_model
        self._pred_cache.clear()

    def _predict_decode(self) -> Prediction:
        """Price one decode step at ``(max_len, max_batch)`` from the
        analytic census: on the fused path ``donated`` (the step writes the
        cache in place) and ``device_sampling`` (only the ``[2, B]`` echo
        crosses to the host), on the legacy path neither (a full second
        store written, the ``[B, vocab]`` logits at the boundary).  The JAX
        engines price the HLO of their compiled step instead; the port
        compiles none.

        APPROXIMATION: a census at ``seq_len = max_len`` prices the whole
        cache stripe of every row, as the slot engine's step reads it; the
        paged kernel reads only the filled pages, so on the paged engine
        this is an upper bound on the step's cache traffic."""
        key = ("decode", self.max_batch)
        if key not in self._pred_cache:
            cell = ShapeCell("decode", "decode", self.max_len, self.max_batch)
            self._pred_cache[key] = self.cost_model.predict(analytic_census(
                self.model.cfg, cell, n_devices=1, n_model=1,
                donated=self.fused, device_sampling=self.fused))
        return self._pred_cache[key]

    def _record_step(self, planned: float, t0: float) -> float:
        """Book a counted step's predicted and measured (host) seconds;
        returns the measured seconds."""
        measured = self._clock.perf_counter() - t0
        if self.cost_model is not None:
            self.stats.predicted_step_s.append(planned)
            self.stats.measured_step_s.append(measured)
        return measured

    def _step_record(self, planned: float, measured: float, n_active: int,
                     decode_ran: bool, n_units: int,
                     budget: Optional[float]) -> StepRecord:
        """One telemetry ``StepRecord`` for this iteration, from host values
        only."""
        pred = self._pred_cache.get(("decode", self.max_batch))
        return StepRecord(
            engine=self.engine_name, step=self.stats.steps,
            t_s=self._clock.time(), n_active=n_active,
            queue_depth=len(self.queue), predicted_s=planned,
            predicted_decode_s=pred.step_s if pred else 0.0,
            measured_s=measured, decode_ran=decode_ran,
            n_prefill_units=n_units,
            bottleneck=getattr(pred, "bottleneck", ""),
            budget_s=budget if budget is not None else 0.0,
            host_syncs=self.stats.host_syncs,
            table_uploads=self.stats.table_uploads,
            decoded_tokens=self.stats.decoded_tokens,
            preemptions=self.stats.preemptions,
            deferred=self.stats.deferred_prefills,
            integrity_failures=self.stats.integrity_failures,
            **self._pool_fields())

    def _pool_fields(self) -> Dict[str, int]:
        """The block-pool fields of a step record: 0 without a pool."""
        return {"blocks_in_use": 0, "n_blocks": 0, "kernel_splits": 0}

    def _stamp_retired(self, req: Request) -> None:
        """A retirement's clock stamp, and its telemetry sample."""
        req.finished_s = self._clock.time()
        if self.telemetry is not None:
            self.telemetry.on_retire(req)


@dataclasses.dataclass
class _Row:
    """One decode row: the request it serves plus its prefill progress
    (the row's block table lives in ``engine.block_tables``)."""
    req: Request
    filled: int = 0                 # prompt tokens whose K/V are written
    ready: bool = False             # prefill complete; decodes each step
    pos: int = 0                    # context length == next write position
    last_tok: int = 0               # legacy path only; fused keeps it on device
    dispatched: int = 0             # fused: decode dispatches incl. in-flight


class PagedServingEngine(_DeviceLoop):
    """Continuous batching over a paged KV cache with chunked prefill.

    ``block_size`` defaults to the autotuner's cached ``paged_attention``
    pick when a tuner is attached (the tunable page-size axis), else 16.
    ``n_blocks`` defaults to the slot-equivalent pool (``max_batch x
    ceil(max_len / block_size)``); a smaller pool serves the same traffic
    in less memory, with eviction keeping the engine correct."""

    engine_name = "paged"

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_len: int = 512, block_size: Optional[int] = None,
                 n_blocks: Optional[int] = None, chunk_size: int = 32,
                 cost_model: Optional[CostModel] = None,
                 step_budget_s: Optional[float] = None,
                 autotuner=None, clock=None, telemetry=None, mesh=None,
                 fused: bool = True):
        if mesh is not None and not fused:
            raise ValueError("a sharded replica (mesh=...) requires the "
                             "fused decode path (fused=True); the legacy "
                             "blocking path is single-device by design")
        if mesh is not None:
            raise NotImplementedError("mesh= is not ported yet")
        self.fused = fused
        self.autotuner = autotuner
        self.model = model
        self.params = params
        self.device = model.device
        self.cost_model = cost_model
        self.step_budget_s = step_budget_s
        self._pred_cache: Dict = {}
        self.max_batch = max_batch
        self.max_len = max_len
        self._bind(clock, telemetry)
        # the tuning cache resolves both paged axes here: block_size is a
        # cache-LAYOUT parameter (fixed at pool construction), the chunk a
        # launch parameter every decode is given explicitly (_paged_fn);
        # kernel_splits and kernel_chunk record the resolved values
        cfg = model.cfg
        self.kernel_splits, self.kernel_chunk = 1, CHUNK_TOKENS
        tuned_cfg = None
        if autotuner is not None:
            shapes = {"batch": max_batch, "heads": cfg.n_heads,
                      "kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.head_dim, "ctx": max_len}
            tuned_cfg = autotuner.config_for("paged_attention", shapes)
            self.kernel_splits = int(tuned_cfg.get("num_splits", 1))
        if block_size is None:
            block_size = (int(tuned_cfg["block_size"])
                          if tuned_cfg is not None else 16)
        self.block_size = block_size
        self.max_blocks_per_seq = blocks_for_tokens(max_len, block_size)
        if autotuner is not None:
            # the decode's launch config, looked up once at the shapes
            # ops.paged_attention sees (the table's width in tokens, the
            # model's compute dtype) and passed to every decode, so no
            # call looks it up again
            run = autotuner.config_for(
                "paged_attention",
                dict(shapes, ctx=self.max_blocks_per_seq * block_size),
                cfg.compute_dtype)
            self.kernel_chunk = int(run["chunk_tokens"])
            self._paged_fn = functools.partial(
                kops.paged_attention, chunk_tokens=self.kernel_chunk,
                num_splits=int(run.get("num_splits", 1)))
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
        self.scheduler = ChunkedPrefillScheduler(
            chunk_size, step_budget_s=step_budget_s)
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
        if fused:
            self._step_fn = functools.partial(model.decode_step,
                                              paged_fn=self._paged_fn)
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
        self.scheduler.submit(Request(rid, prompt, max_new_tokens, eos_id,
                                      submitted_s=self._clock.time()))
        return rid

    @property
    def queue(self):
        return self.scheduler.queue

    def _pool_fields(self) -> Dict[str, int]:
        return {"blocks_in_use": self.allocator.n_in_use,
                "n_blocks": self.n_blocks,
                "kernel_splits": self.kernel_splits}

    def _predict_chunk(self) -> Prediction:
        """Price one prefill chunk as a ``chunk_size``-token prefill (chunks
        never shrink: final partial chunks overlap).

        APPROXIMATION: the analytic census is parameter-streaming dominated
        and linear in tokens; it does not price attention over the row's
        already filled context, so late chunks of a long prompt cost
        somewhat more than the gate charges them.  The budget bounds the
        count of chunks a step, not long-context attention."""
        key = ("chunk", self.chunk_size)
        if key not in self._pred_cache:
            self._pred_cache[key] = _analytic_prefill_prediction(
                self.cost_model, self.model.cfg, self.chunk_size)
        return self._pred_cache[key]

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
        self.stats.admission_order.append(req.rid)
        return idx

    def _run_chunk(self, idx: int) -> None:
        """Advance row ``idx``'s prefill by one ``chunk_size`` chunk.  The
        final chunk overlaps written positions (rewriting identical K/V);
        prompts shorter than a chunk are left-padded at negative positions,
        whose writes the pool drops.  Fused: the final chunk's greedy token
        lands in the device token array and reaches ``req.tokens`` through
        the first decode step's echo.  Legacy: the chunk decodes into a
        copy of the pool, and the final chunk's token is synced into
        ``row.last_tok`` and ``req.tokens``."""
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
            start_arr = np.asarray([start], np.int32)
            if self.fused:
                nxt, _ = self._step_fn(self.params, self.cache,
                                       self._dev(toks[None]),
                                       self._dev(start_arr), bt)
                if end == S:
                    self._toks[idx:idx + 1].copy_(nxt[:1])
            else:
                logits = self._decode_legacy(toks[None], start_arr, bt)
                if end == S:
                    staged = self._stage(
                        torch.argmax(logits[0]).to(torch.int32))
        row.filled = end
        self.stats.prefill_chunks += 1
        if end == S:
            row.ready = True
            row.pos = S
            self.stats.prefills += 1
            if not self.fused:
                row.last_tok = int(self._sync(staged))
                req.tokens.append(row.last_tok)

    # -- the engine iteration -------------------------------------------------
    def _step(self) -> int:
        """One iteration: plan, run prefill chunks, dispatch the decode,
        then drain the PREVIOUS step, so step N's tokens are read only
        after step N+1 is queued on the device.  Returns the number of
        placed rows (>= 1 while a step is still in flight)."""
        t0 = self._clock.perf_counter()
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
        budget = self._step_budget()
        priced = self.cost_model is not None
        plan = self.scheduler.plan(
            unfinished=unfinished, n_free_rows=n_free, any_ready=any_ready,
            decode_s=self._predict_decode().step_s if priced else 0.0,
            chunk_s=self._predict_chunk().step_s if priced else 0.0,
            gated=priced and budget is not None, budget_s=budget)
        self.stats.deferred_prefills += plan.deferred
        chunks_before = self.stats.prefill_chunks

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
        if did_work:
            # sampled iff the step counts: occupancy and steps one-to-one
            self.stats.block_occupancy.append(self.allocator.occupancy)
        self._drain(prev)
        if did_work:
            self.stats.steps += 1
            measured = self._record_step(plan.predicted_s, t0)
            if self.telemetry is not None:
                # n_prefill_units counts the chunks RUN (a planned chunk
                # waits when the pool is dry)
                self.telemetry.on_step(self._step_record(
                    plan.predicted_s, measured, len(self._placed()),
                    active > 0, self.stats.prefill_chunks - chunks_before,
                    budget))
        n = len(self._placed())
        return n if self._pending is None else max(n, 1)

    def _decode_phase(self) -> int:
        """Batched decode over the ready rows; rows mid-prefill (or whose
        block growth must wait) ride along masked out at write_pos = -1.
        The legacy path books and retires its rows at once."""
        ready = [i for i in self._placed() if self.rows[i].ready]
        if not ready:
            return 0
        stepping = []
        for i in ready:
            row = self.rows[i]
            if row is None or not row.ready:
                continue             # evicted by an earlier row's growth
            if self.fused and self._retirement_bound(row):
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
        if not self.fused:
            return self._decode_blocking(stepping, pos)
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

    def _decode_blocking(self, stepping, pos: np.ndarray) -> int:
        """The legacy decode: ``[B, 1]`` tokens uploaded from the rows'
        ``last_tok``, the argmax synced, rows booked and retired at once."""
        toks = np.zeros((self.max_batch, 1), np.int32)
        for i, row in stepping:
            toks[i, 0] = row.last_tok
        with record_function("decode_step"):
            logits = self._decode_legacy(toks, pos, self._bt_device())
            staged = self._stage(torch.argmax(logits, dim=-1)
                                 .to(torch.int32))
        self.stats.decode_dispatches += 1
        nxt = self._sync(staged)
        for i, row in stepping:
            req = row.req
            req.tokens.append(int(nxt[i]))
            self.stats.decoded_tokens += 1
            row.last_tok = int(nxt[i])
            row.pos += 1
            hit_eos = req.eos_id is not None and nxt[i] == req.eos_id
            out_of_budget = len(req.tokens) >= req.max_new_tokens
            out_of_cache = row.pos >= self.max_len - 1
            if hit_eos or out_of_budget or out_of_cache:
                self._retire(i)
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
        self._stamp_retired(req)
        self._maybe_compact()

    def run_until_done(self, max_steps: int = 10_000) -> EngineStats:
        stats = super().run_until_done(max_steps)
        self.allocator.check()
        return stats


class ServingEngine(_DeviceLoop):
    """Slot-granular continuous batching (see the module docstring)."""

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_len: int = 512, cost_model: Optional[CostModel] = None,
                 step_budget_s: Optional[float] = None, autotuner=None,
                 clock=None, telemetry=None, fused: bool = True):
        self.fused = fused
        self.autotuner = autotuner
        self.model = model
        self.params = params
        self.device = model.device
        self.cost_model = cost_model
        self.step_budget_s = step_budget_s
        self._pred_cache: Dict = {}
        self.max_batch = max_batch
        self.max_len = max_len
        self._bind(clock, telemetry)
        self.queue: deque[Request] = deque()
        self.done: Dict[int, Request] = {}
        self.stats = EngineStats()
        self._rid = itertools.count()
        self.cache = model.init_cache(max_batch, max_len)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)     # host mirror
        self.slot_tok = np.zeros(max_batch, np.int32)     # legacy path only
        self._pending = None
        if fused:
            # device-resident loop state: the step consumes and advances
            # it, so nothing but the [2, B] token echo crosses to the host
            self._toks = self._dev(np.zeros(max_batch, np.int32))
            self._pos = self._dev(np.zeros(max_batch, np.int32))

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               eos_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit "
                             f"max_len={self.max_len} (needs >= 1 decode "
                             "slot)")
        rid = next(self._rid)
        self.queue.append(Request(rid, prompt, max_new_tokens, eos_id,
                                  submitted_s=self._clock.time()))
        return rid

    def _predict_prefill(self, prompt_len: int) -> Prediction:
        """Price one prefill at this prompt length (cached per length)."""
        key = ("prefill", prompt_len)
        if key not in self._pred_cache:
            self._pred_cache[key] = _analytic_prefill_prediction(
                self.cost_model, self.model.cfg, prompt_len)
        return self._pred_cache[key]

    def _admit(self):
        """Prefill queued requests into the free slots, oldest first; returns
        ``(planned, admitted, budget)``: the iteration's predicted seconds
        (0.0 without a cost model), the prefills admitted and the budget the
        gate used (None when ungated).

        With a cost model and a budget, admission stops once the decode
        step plus the admitted prefills would exceed the budget, but it
        always admits one prefill when a slot is free, so an over-tight
        budget cannot starve the engine.  A deferral is counted only for a
        queued request that a free slot could have taken and whose own
        prefill would not fit in what is left; a request that would fit
        but waits behind the head in FIFO order is not counted."""
        budget = self._step_budget()
        priced = self.cost_model is not None
        gated = priced and budget is not None
        planned = self._predict_decode().step_s if priced else 0.0
        admitted = 0
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        for idx, slot in enumerate(free):
            if not self.queue:
                break
            if priced:
                head = self.queue[0]
                pre_s = self._predict_prefill(len(head.prompt)).step_s
                if gated and admitted > 0 and planned + pre_s > budget:
                    for q in itertools.islice(self.queue, len(free) - idx):
                        q_s = self._predict_prefill(len(q.prompt)).step_s
                        if planned + q_s > budget:
                            self.stats.deferred_prefills += 1
                    break
                planned += pre_s
            self._prefill_into_slot(slot, self.queue.popleft())
            admitted += 1
        return planned, admitted, budget

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """One uncached prefill, spliced into ``slot`` in place.  Fused: the
        slot's device token is set to the prefill's argmax and its device
        position to the prompt length, and nothing crosses to the host (the
        first token reaches ``req.tokens`` through the next step's echo).
        Legacy: the argmax is synced into ``slot_tok`` and ``req.tokens``."""
        S = len(req.prompt)
        with record_function("prefill"):
            logits, cache1 = self.model.prefill(
                self.params, {"tokens": self._dev(req.prompt[None, :])},
                max_len=self.max_len)
            for key, big in self.cache.items():
                big[:, slot:slot + 1].copy_(cache1[key])
            # flattened, as jnp.argmax over logits[0] is
            tok0 = torch.argmax(logits[0].reshape(-1)).to(torch.int32)
            if self.fused:
                self._toks[slot:slot + 1].copy_(tok0.reshape(1))
                self._pos[slot:slot + 1].fill_(S)
            else:
                staged = self._stage(tok0)
        if not self.fused:
            self.slot_tok[slot] = int(self._sync(staged))
            req.tokens.append(int(self.slot_tok[slot]))
        self.slot_req[slot] = req
        self.slot_pos[slot] = S
        self.stats.prefills += 1
        self.stats.admission_order.append(req.rid)

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.done[req.rid] = req
        self.slot_req[slot] = None
        self.stats.completed += 1
        self._stamp_retired(req)

    def _drain(self, pending) -> None:
        """Sync and book one in-flight step: append its tokens (plus the
        echoed prefill token for rows on their first decode), advance the
        host position mirror, retire.  Rows whose slot changed hands since
        dispatch were retired in an earlier drain: their shadow tokens are
        dropped."""
        if pending is None:
            return
        staged, snap = pending
        arr = self._sync(staged)
        if not _echo_ok(arr):
            self.stats.integrity_failures += 1
            return
        in_t, out_t = arr[0], arr[1]
        for i, req in snap:
            if self.slot_req[i] is not req:
                continue                     # shadow step of a retired row
            if not req.tokens:
                req.tokens.append(int(in_t[i]))      # prefill's first token
            req.tokens.append(int(out_t[i]))
            self.stats.decoded_tokens += 1
            self.slot_pos[i] += 1
            hit_eos = req.eos_id is not None and req.tokens[-1] == req.eos_id
            out_of_budget = len(req.tokens) >= req.max_new_tokens
            out_of_cache = self.slot_pos[i] >= self.max_len - 1
            if hit_eos or out_of_budget or out_of_cache:
                self._retire(i)

    def _step(self) -> int:
        """One iteration: admit (host work in the shadow of the in-flight
        step), dispatch step N over every slot, then drain step N-1, so a
        step's tokens are read only after the next step is queued on the
        device.  Returns the number of occupied slots at dispatch."""
        if not self.fused:
            return self._step_blocking()
        t0 = self._clock.perf_counter()
        prev, self._pending = self._pending, None
        planned, admitted, budget = self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if active:
            with record_function("decode_step"):
                nxt, _ = self.model.decode_step(
                    self.params, self.cache, self._toks[:, None], self._pos)
                io = torch.stack([self._toks, nxt])  # input echo + outputs
                # every row advances, free slots included, as in JAX
                self._toks, self._pos = nxt, self._pos + 1
            self._pending = (self._stage(io),
                             [(i, self.slot_req[i]) for i in active])
            self.stats.steps += 1
            self.stats.decode_dispatches += 1
        self._drain(prev)
        if active:
            measured = self._record_step(planned, t0)
            if self.telemetry is not None:
                self.telemetry.on_step(self._step_record(
                    planned, measured, len(active), True, admitted, budget))
        return len(active)

    def _step_blocking(self) -> int:
        """The legacy iteration: admit, decode every slot from host-uploaded
        tokens and positions into a copy of the store, sync the argmax,
        book and retire at once."""
        t0 = self._clock.perf_counter()
        planned, admitted, budget = self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        with record_function("decode_step"):
            logits = self._decode_legacy(self.slot_tok[:, None],
                                         self.slot_pos)
            staged = self._stage(torch.argmax(logits, dim=-1)
                                 .to(torch.int32))
        self.stats.decode_dispatches += 1
        nxt = self._sync(staged)
        self.stats.steps += 1
        measured = self._record_step(planned, t0)
        if self.telemetry is not None:
            self.telemetry.on_step(self._step_record(
                planned, measured, len(active), True, admitted, budget))
        for i in active:
            req = self.slot_req[i]
            req.tokens.append(int(nxt[i]))
            self.stats.decoded_tokens += 1
            self.slot_tok[i] = nxt[i]
            self.slot_pos[i] += 1
            hit_eos = req.eos_id is not None and nxt[i] == req.eos_id
            out_of_budget = len(req.tokens) >= req.max_new_tokens
            out_of_cache = self.slot_pos[i] >= self.max_len - 1
            if hit_eos or out_of_budget or out_of_cache:
                self._retire(i)
        return len(active)
