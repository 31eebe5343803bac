"""The port's sim harness (``repro_torch.serve.sim``) and its engines on
scripted traces, mirroring ``tests/test_serve_sim.py`` test for test.

The torch ``FakeModel`` (next token = last + 1 mod vocab) runs on the CPU
through the port's ``PagedServingEngine`` and ``ServingEngine`` under a
``SimClock``: no request lost, FIFO admission, exact deferral accounting,
every evicted request completes, the slot engine's ``deferred_prefills``
semantics.  The exact-accounting test also runs with ``decode_s !=
prefill_s`` (the port prices decode and prefill through one
``predict(census)``, so the fake must tell the censuses apart), and
against the JAX engine on the same trace.
"""
import numpy as np
import pytest

from repro.serve import PagedServingEngine as JPagedServingEngine
from repro.serve import sim as jsim
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import PagedServingEngine, ServingEngine
from repro_torch.serve.sim import (FakeCostModel, FakeModel, SimClock, drive,
                                   expected_tokens, is_decode_census)


def fake():
    return FakeModel(device="cpu")


def paged(model, clock=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("chunk_size", 4)
    return PagedServingEngine(model, params=None, clock=clock, **kw)


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


def test_no_request_lost_and_outputs_exact():
    model = fake()
    clock = SimClock()
    eng = paged(model, clock)
    rng = np.random.default_rng(0)
    arrivals = [(float(i // 3), rng.integers(0, 97, size=int(l)), 4, None)
                for i, l in enumerate(rng.integers(1, 12, size=9))]
    rids = drive(eng, clock, arrivals)
    assert eng.stats.completed == len(arrivals)      # no request lost
    assert sorted(eng.done) == sorted(rids)
    for rid, t in rids.items():
        req = eng.done[rid]
        assert req.tokens == expected_tokens(req.prompt, 4, 97)
        # timestamps are scripted values, not wall time
        assert req.submitted_s == t
        assert req.finished_s == int(req.finished_s) >= t


def test_fifo_admission_and_eos_retire():
    model = fake()
    clock = SimClock()
    eng = paged(model, clock)
    arrivals = [(0.0, [5, 6, 7], 8, 10),     # eos after 3 tokens (8,9,10)
                (0.0, [20], 8, None),
                (1.0, [40, 41], 8, None)]
    rids = drive(eng, clock, arrivals)
    assert eng.stats.completed == 3
    # FIFO: admission order == submission (rid) order, no preemption here
    assert eng.stats.admission_order == sorted(rids)
    first = eng.done[min(rids)]
    assert first.tokens == [8, 9, 10]
    assert first.eos_id == 10


def test_recorded_shapes_are_the_two_engine_calls():
    """The fake model's shape census: chunked prefill runs [1, chunk] and
    batched decode [max_batch, 1], each against a full-width block table —
    and nothing else; each distinct shape is listed once, in the order
    first seen (the chunk runs first)."""
    model = fake()
    clock = SimClock()
    eng = paged(model, clock, max_batch=3, chunk_size=4)
    drive(eng, clock, [(0.0, list(range(1, 7)), 3, None)])
    nb = eng.max_blocks_per_seq
    assert model.decode_shapes == [((1, 4), (1, nb)), ((3, 1), (3, nb))]


@pytest.mark.parametrize("decode_s,predicted", [
    (1.0, [2.0, 2.0, 2.0]),
    (0.25, [2.0, 2.0, 1.25, 1.25]),
    (2.0, [2.0, 2.0, 3.0, 3.0])])
def test_deferred_prefills_exact_accounting(decode_s, predicted):
    """Hand-checkable budget arithmetic (chunk=1.0, budget=2.5): 3
    requests of exactly 2 chunks each defer one candidate in each of the
    first two planning steps and nothing afterwards.  From step 3 the
    decode price is in the plan, so with ``decode_s != prefill_s`` the
    predicted step times show which price the engine charged; the JAX
    engine charges the same on the same trace."""
    def run(eng):
        for p in ([*range(10, 18)], [*range(30, 38)], [*range(50, 58)]):
            eng.submit(np.asarray(p, np.int32), max_new_tokens=3)
        seen = []
        for _ in range(3):
            eng.step()
            seen.append((eng.stats.deferred_prefills,
                         eng.stats.prefill_chunks, eng.stats.prefills))
        eng.run_until_done()
        return seen

    eng = paged(fake(), SimClock(), chunk_size=4,
                cost_model=FakeCostModel(decode_s=decode_s, prefill_s=1.0),
                step_budget_s=2.5)
    seen = run(eng)
    # r0+r1 chunks fit (0+1+1 <= 2.5), r2 deferred; r0+r1 final chunks,
    # r2 deferred again; decode + r2's first chunk (always-admit-one)
    assert seen == [(1, 2, 0), (2, 4, 2), (2, 5, 2)]
    assert eng.stats.completed == 3
    assert eng.stats.deferred_prefills == 2   # nothing counted after
    assert eng.stats.predicted_step_s[:len(predicted)] == predicted
    for rid, req in eng.done.items():
        assert req.tokens == expected_tokens(req.prompt, 3, 97)

    jeng = JPagedServingEngine(
        jsim.FakeModel(), params=None, clock=jsim.SimClock(), max_batch=4,
        max_len=32, block_size=4, chunk_size=4, step_budget_s=2.5,
        cost_model=jsim.FakeCostModel(decode_s=decode_s, prefill_s=1.0))
    assert run(jeng) == seen
    assert jeng.stats.predicted_step_s == eng.stats.predicted_step_s
    assert ({r: q.tokens for r, q in jeng.done.items()}
            == {r: q.tokens for r, q in eng.done.items()})


def test_fake_cost_model_tells_decode_from_prefill_censuses():
    """The engine's two censuses reach the fake's two prices."""
    cm = FakeCostModel(decode_s=0.5, prefill_s=3.0,
                       predict_fn=lambda c: 7.0)
    eng = paged(fake(), SimClock(), cost_model=cm)
    assert eng._predict_decode().step_s == 0.5
    assert eng._predict_chunk().step_s == 7.0
    assert not is_decode_census({"flops": 1.0})


def test_evicted_requests_eventually_complete():
    """Pool of exactly one max_len sequence: concurrent requests must
    preempt each other, and every evicted request still completes with
    the right tokens (greedy replay is deterministic)."""
    model = fake()
    clock = SimClock()
    eng = paged(model, clock, max_batch=2, max_len=16, block_size=4,
                n_blocks=4, chunk_size=4)
    arrivals = [(0.0, list(range(10, 18)), 4, None),
                (0.0, list(range(30, 38)), 4, None),
                (2.0, list(range(50, 57)), 4, None)]
    rids = drive(eng, clock, arrivals, max_steps=200)
    assert eng.stats.completed == 3
    assert eng.stats.preemptions > 0          # evictions actually happened
    for rid in rids:
        req = eng.done[rid]
        assert req.tokens == expected_tokens(req.prompt, 4, 97)
    # leak-free teardown: every block back on the free list
    eng.allocator.check()
    assert eng.allocator.n_free == eng.n_blocks
    assert eng.stats.peak_blocks_in_use == eng.n_blocks


def test_decode_phase_eviction_of_collected_row_does_not_crash():
    """A ready row already collected for this decode step can be evicted
    by a LATER ready row's block growth in the same loop — the engine must
    drop it from the batch, not dereference its cleared row.  Also pins
    delivered-token accounting: eviction replays must not double-count
    decoded_tokens."""
    model = fake()
    clock = SimClock()
    eng = paged(model, clock, max_batch=3, max_len=16, block_size=4,
                n_blocks=6, chunk_size=4)
    rng = np.random.default_rng(1)
    arrivals = [(float(i // 3), rng.integers(0, 97, size=int(l)), 4, None)
                for i, l in enumerate(rng.integers(4, 13, size=9))]
    rids = drive(eng, clock, arrivals, max_steps=400)
    assert eng.stats.completed == 9
    assert eng.stats.preemptions > 0
    for rid in rids:
        req = eng.done[rid]
        assert req.tokens == expected_tokens(req.prompt, 4, 97)
    delivered = sum(len(r.tokens) - 1 for r in eng.done.values())
    assert eng.stats.decoded_tokens == delivered
    assert eng.stats.prefills == 9
    assert eng.allocator.n_free == eng.n_blocks


def test_overlong_prompts_rejected_at_submit(tiny_lm):
    """A prompt that cannot fit max_len is rejected at submit on BOTH
    engines."""
    model, params = tiny_lm
    eng = PagedServingEngine(model, params, max_batch=2, max_len=16,
                             block_size=4)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(np.arange(16, dtype=np.int32))
    slot = ServingEngine(model, params, max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="cannot fit"):
        slot.submit(np.arange(20, dtype=np.int32))
    # one-under-the-cap is fine and completes
    rid = eng.submit(np.arange(15, dtype=np.int32), max_new_tokens=4)
    eng.run_until_done()
    assert rid in eng.done


def test_block_occupancy_stats_tracked():
    model = fake()
    clock = SimClock()
    eng = paged(model, clock)
    drive(eng, clock, [(0.0, [3, 4, 5, 6, 7], 4, None)])
    assert eng.stats.peak_blocks_in_use >= 2
    assert len(eng.stats.block_occupancy) == eng.stats.steps
    assert all(0.0 <= o <= 1.0 for o in eng.stats.block_occupancy)
    assert max(eng.stats.block_occupancy) > 0


def test_fused_path_skips_predictable_shadow_steps():
    """A row whose retirement is already host-computable must NOT be
    dispatched again.  Solo 4-token prompt, one chunk, max_new=4: the
    chunk step also runs the first decode, then two more decode steps —
    exactly 3 steps, no trailing shadow."""
    model = fake()
    clock = SimClock()
    eng = paged(model, clock)
    drive(eng, clock, [(0.0, [10, 11, 12, 13], 4, None)])
    assert eng.stats.completed == 1
    req = next(iter(eng.done.values()))
    assert req.tokens == expected_tokens(req.prompt, 4, 97)
    assert eng.stats.steps == 3          # chunk+decode, decode, decode
    assert eng.stats.decoded_tokens == 3


def test_fused_and_blocking_paths_agree_on_scripted_trace():
    """The fused hot path against the legacy blocking path on the same
    scripted trace: every request's tokens — computable in closed form
    for FakeModel — must match, and only the fused engine stays at <= 1
    sync/step."""
    rng = np.random.default_rng(4)
    arrivals = [(float(i // 2), rng.integers(0, 97, size=int(l)), 4, None)
                for i, l in enumerate(rng.integers(1, 12, size=8))]

    def run(fused):
        model = fake()
        clock = SimClock()
        eng = paged(model, clock, fused=fused)
        rids = drive(eng, clock, arrivals)
        return eng, {eng.done[r].prompt.tobytes(): eng.done[r].tokens
                     for r in rids}

    blocking_eng, blocking = run(False)
    fused_eng, fused = run(True)
    assert fused == blocking
    for req in fused_eng.done.values():
        assert req.tokens == expected_tokens(req.prompt, 4, 97)
    assert fused_eng.stats.host_syncs <= fused_eng.stats.steps
    assert blocking_eng.stats.host_syncs > blocking_eng.stats.steps


# ---------------------------------------------------------------------------
# the slot engine's deferred_prefills semantics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_lm():
    cfg = reduced(ARCHS["gemma2-2b"], n_layers=2, vocab_size=64)
    model = build_model(cfg, device="cpu")
    return model, model.init(0)


def test_slot_deferred_count_excludes_requests_that_would_fit(tiny_lm):
    """With a huge prompt at the queue head and a tiny one behind it, only
    the huge one is budget-deferred — the tiny one (which would have fit)
    is blocked by FIFO order, not by the budget, and is NOT counted."""
    model, params = tiny_lm
    # price prefills proportional to prompt length, decode at ~0
    cm = FakeCostModel(decode_s=0.0,
                       predict_fn=lambda census: census["flops"])
    probe = ServingEngine(model, params, max_batch=4, max_len=96,
                          cost_model=cm)
    cost = lambda n: probe._predict_prefill(n).step_s
    budget = cost(4) + cost(6) + 1.0          # fits small+tiny, not huge
    assert cost(64) > budget
    assert probe._predict_decode().step_s == 0.0

    eng = ServingEngine(model, params, max_batch=4, max_len=96,
                        cost_model=cm, step_budget_s=budget)
    eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)    # admitted
    eng.submit(np.arange(64, dtype=np.int32), max_new_tokens=2)   # too big
    eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=2)    # would fit
    eng.step()
    assert eng.stats.prefills == 1
    assert eng.stats.deferred_prefills == 1
    # FIFO is preserved: the tiny request is NOT admitted around the head
    assert len(eng.queue) == 2
    stats = eng.run_until_done()
    assert stats.completed == 3
