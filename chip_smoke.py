#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines (a failing phase raises, so the run
exits non-zero):

1. card: the ``nvidia-smi`` name and power limit, and the build of every
   CUDA kernel from this checkout's sources (one nvcc per source, all
   started at once, in the background), beside them the ``alu_chain``
   fault controls' builds.
2. kernel: the paged-attention kernels (chunks, then merge) against their
   plain PyTorch version at the serving shapes (B=8, H=8, KH=4, D=256,
   block 16, 64-entry tables, bf16 pools), ragged contexts {0, 1, 17, 300,
   1024} with a -1 entry inside one context, window {None, 8, 4096} x
   softcap {None, 50} x num_splits {1, 4}; with times for the kernel, the
   plain version, ``F.scaled_dot_product_attention`` over the gathered K/V
   (a yardstick only) and the memory bound.  ``ms`` and ``library_ms``
   are one call between a CUDA event pair, host cost included;
   ``graph_ms`` and ``library_graph_ms`` are 20 calls captured in one
   CUDA graph and replayed between one event pair, over 20 (device time
   alone; the calls cycle over copies of the inputs larger together than
   the L2, and the capture shows the call reads no device value).  Then
   a sweep of the kernel's chunk (32, 64, 128 tokens) at the main case,
   and contexts at and beside the chunk boundaries {31, 32, 33, 63, 64,
   65, 128, 1024} (windows {None, 8, 40, 4096}, softcap {None, 50}, and
   q x 30 where the softcap binds) beside fault controls the gate must
   catch (``PAGED_MUST_CATCH``): the plain version with the window one
   token wider, the softcap dropped, the query's own token excluded, the
   unbacked page read as page 0, and a token at a chunk boundary
   dropped.
3. serve: full-width gemma2-2b (26 layers, seeded random bf16 weights)
   through ``PagedServingEngine`` (max_batch 8, max_len 1024, block 16,
   chunk 64) on 8 requests of 16-900 prompt tokens, 32 new tokens each,
   under ``torch.cuda.set_sync_debug_mode("error")``; every decode step of
   every layer must go through the kernel.
4. parity: one batched full-width decode step through the kernel and
   through the plain version; logits must agree.
5. flash_kernel: the flash-attention kernels against their plain
   version: the tensor-core kernel (``flash_attention_mma.cu``) on bf16,
   B=1, H=8, KH=4, D=256, Sq=Skv in {1, 52, 768, 900} (ragged tails of
   the serve trace) and B=8, Sq=Skv=512, each causal with window {None,
   64, 4096} x softcap {None, 50}, one non-causal case and one case where
   the softcap binds (q scaled so raw scores pass +-50); the CUDA-core
   kernel (``flash_attention.cu``) in f32 at B=1, Sq=Skv=900 over window
   {None, 64, 4096} x softcap {None, 50}, at B=8, Sq=Skv=512, non-causal,
   where the softcap binds and at a GQA group of 7 (H=56, KH=8, D=128),
   each held at ``FLASH_F32_TOL`` (1e-5, scaled by max|want|), and with
   the bf16 accumulator (``acc_dtype="bf16"``, bf16 inputs) at block_k
   {16, 128, 256}.  Each case gives the share of outputs not bit-equal to
   the plain version's, the CUDA-core kernel's work split (``T``,
   ``smax``) and times for the kernel, the plain version,
   ``F.scaled_dot_product_attention`` where it computes the same function
   (no window, no softcap; a yardstick only) and the bound.  ``ms`` and
   ``library_ms`` are one call between a CUDA event pair, median of 20,
   the host's cost of the call included, as every kernel on the
   ``kernels`` line is timed; ``stream_ms`` and ``library_stream_ms`` are
   20 calls back to back between one event pair, over 20, where that cost
   hides behind the card's work.  Beside the checks, fault controls the
   gate must catch in bf16 and in f32 (``FLASH_MUST_CATCH``): the plain
   version with the window one key wider, with the softcap dropped where
   it binds, and with the diagonal key excluded; and in f32 the split's
   own (``SPLIT_MUST_CATCH``): the plain version item by item with one
   item's partial dropped, merged without its rescale, and with the key
   at each item boundary counted twice.
6. serve_slot: the same model and prompts through ``ServingEngine``
   (max_batch 8, max_len 1024), under sync debugging; every layer of
   every prefill must go through the tensor-core flash kernel.
7. parity_slot: one full-width prefill of a 900-token prompt through the
   flash kernel and through its plain version; logits must agree.  Beside
   it, readings (not gates) of two faults in every layer: the plain
   version with the softcap dropped and with the diagonal key excluded,
   each against the sound plain prefill.
8. reference: a reduced f32 gemma2 served on the card and on the CPU
   (where attention runs the plain versions), through the paged and the
   slot engine, must give identical tokens; the f32 prefills must go
   through the CUDA-core flash kernel, none through the tensor-core one.
9. probes: the paper's three probe kernels against their plain versions:
   ``alu_chain`` for every (op, dtype, dependent) the harness runs, at
   lengths 12 and 256 (a counted loop, and a body of the sweep's own),
   beside its gates, each with fault controls it must catch
   (``ALU_MUST_CATCH``): one call is one device kernel and no copy under
   torch.profiler, for c as a number, a CUDA tensor and a CPU tensor
   (one_kernel); a length-1 call's event-timed ms at most
   ``ALU_LAUNCH_FACTOR`` x one ``torch.add`` on 1,024 elements
   (launch_cost); no reading under one cycle per op (folded); the
   independent f32 and int32 add/mul/fma readings at most
   ``ALU_SERIAL_FACTOR`` x their 256-op body's SASS instructions per op
   (serial; the SASS by ``cuobjdump``, ``alu_chain.timed_body``); and
   dependent fma and independent add at length 256 with ``chain_ms`` (the
   in-kernel ``%globaltimer`` span) and the bound, 256 x the cycles per op
   the same case measured over its measured clock; ``pointer_chase`` in shared memory and in global memory under
   ``.ca``/``.cg``/``.cv``, on cycles of 64, 4096 and 2^20 entries (shared
   where the array fits); ``mxu_probe`` in bf16 and f32 on the JAX kernel
   tests' sweep, the ``mxu_shapes`` grid's shapes and chains that keep A
   resident or stream it (``MXU_CASES``), and the calibration's
   independent launches at their widest (``mxu_wide_cells``: L * reps
   products side by side, reps from the card's occupancy), each within
   ``REL_TOL`` of the plain version on seeded random inputs, with the share
   of outputs not bit-equal per dtype, beside fault controls the gate must
   catch (``MXU_MUST_CATCH``: a step reading the panel of two steps back,
   the last 16-wide k-slab dropped, the next row block's A rows) and the
   kernel's SASS opcode mix; with
   times for the kernel, the plain version, ``torch.matmul`` (``mxu_probe``
   at chain 1) and the bound: ``ms``/``library_ms`` one call,
   ``stream_ms``/``library_stream_ms`` 20 calls back to back (every probe;
   no library call for ``alu_chain`` and ``pointer_chase``).
10. calibration: the port's campaign runs the full grids of the four
   calibration experiments (alu_chain, memory_chase, mxu_shapes,
   roofline_calibration) through the probe kernels into
   ``chiprun_out/campaign/`` and writes the table they make to
   ``chiprun_out/hopper_h100.json``; it fails on an error cell other than
   the three ``(512,512,128)`` dependent ``mxu_shapes`` cells that the
   reference fails too, an ALU cell under 1 cycle per op in either mode (a
   folded chain), a 64 MiB chase no slower per hop than a 16 KiB one, or a
   tensor-core reading no card can give (``mxu_rate_faults``: an
   ``mxu_shapes`` cell or ``mxu_peak_tflops`` not above 0 or above its
   type's dense peak, or a per-op time at the harness's floor).
11. costmodel: the cost model (``repro_torch.core.costmodel``) built
   from the table the calibration phase wrote and from the committed one:
   each table's round trip within ``COST_MAX_ERR_PCT`` (10%) and its
   hardware the H100 spec; the predicted terms of full-width gemma2-2b's
   decode step (B=8, 1,024 positions), a 64-token chunk and a 900-token
   prefill; then phase serve's trace through the paged and the slot engine
   priced by the fresh table, under sync debugging, with a budget of 1e9 s
   (nothing deferred) and a tight one (``cost_budget``: deferrals, every
   request completes), each with one predicted and one measured time a
   step, at most one sync a step beyond the first and the attention kernel
   in every layer; the medians of the predicted and measured (host) step
   times and their ratio (a reading); reduced f32 gemma2 under tight
   budgets on the card and on the CPU with identical tokens, admission
   order and deferrals; and the faults of ``COST_MUST_CATCH``, which the
   gates must catch (an engine that ignores its budget, every prefill
   priced at 0, a table whose hardware resolves to the A100).
12. hotpath: phase serve's model and trace through both engines with
   ``fused=False`` (the legacy blocking path) beside a fused run of each,
   under sync debugging: greedy tokens identical to phases serve and
   serve_slot, the legacy paths reading the device more than once a step
   and the fused ones at most once a step beyond the first, the legacy
   decode step holding one more KV store than the fused one
   (``hotpath_probe``: device memory allocated when ``Model.decode``
   returns, within ``HOTPATH_PEAK_SLACK``), the attention kernel in every
   layer; tok/s, the median step, syncs a step and both memory readings
   printed.  Then reduced f32 gemma2 on the card and the CPU
   (``hotpath_reduced``): legacy tokens equal fused and CPU tokens.  The
   controls of ``HOTPATH_MUST_CATCH`` (the legacy step writing the store
   in place; each step's tokens one step stale) must be caught; the stale
   control at full width is a reading, since the random full-width model
   gives one token for every step of a request.
13. campaign: the port's runner runs ``paged_serve``, ``decode_hotpath``
   and ``isa_mapping`` at their full grids into ``chiprun_out/campaign/``;
   the ``report`` command's code renders them (Table V's rows printed);
   gates: no failed cell, paged_serve leak-free, under the slot cache's
   bytes and complete, decode_hotpath's tokens identical and its legacy
   syncs a step above the fused, Table V's (``isa_gates``: counts, the
   one-instruction counterparts ``ISA_EXPECT``, scan8's 8 FMUL, gather's
   LDG, no directive or label counted); each case kernel launched on a
   seeded 64 x 64 input against its plain version (``isa_values``: 1e-5 of
   max|want|, exp and tanh within 2 ulp of the float64 value); the
   controls of ``ISA_MUST_CATCH`` (a dead store, rsqrt built as sqrt, a
   PTX parser that counts directives and labels); the PTX and SASS texts
   go to ``chiprun_out/isa/`` (``tools/isa_fixtures.py`` cuts the test
   fixtures from them).
14. autotune: the autotuner (``repro_torch.core.autotune``) against the
   calibration phase's fresh table at the main path's shapes
   (``AUTOTUNE_SHAPES``: paged B=8, H=8, KH=4, D=256, ctx 1024; flash
   B=1, 900 x 900 bf16 with the bf16 accumulator opened; mxu_probe bf16
   512^3; ssm_scan 4 x 4224 x 1600, N 16; wkv6 4 x 4096 x 32 x 64): an
   analytic tune of the five tunables, then a measured one (top 3 and the
   default, each timed ``AUTOTUNE_ITERS`` times in a CUDA graph cycling
   over input copies larger than the L2; ``ssm_scan`` and ``wkv6`` have
   one candidate and are not timed), every timed candidate first held
   against its plain version (``autotune_checker``: the paged kernel at
   ``PAGED_REL_TOL`` of max|want|, the others at their kernel phase's
   tolerance) and every timed kernel launched, one line a kernel
   (candidates, best and default, their predicted and measured seconds,
   the measured speedup); the cache persisted under a temporary
   directory and reloaded by a fresh ``TuningCache(path)``, then phase
   hotpath's reduced f32 gemma2 and trace through the paged engine with
   an autotuner whose cache holds ``AUTOTUNE_CACHED`` (page 32, chunk
   128) on the card and on the CPU (``autotune_round_trip``: the engine
   reads them, every decode launches chunk 128, tokens identical to each
   other and to the untuned engine's); ``decode_longctx``'s full grid (9
   cells) into ``chiprun_out/campaign/`` with each cell's output within
   ``PAGED_REL_TOL`` of the oracle's max; and the controls of
   ``AUTOTUNE_MUST_CATCH`` (an entry of another calibration served, a
   timed candidate with its context one token short at ctx 1,024, an
   unlaunchable cached chunk replaced by the default, decode_longctx's
   kernel one token short at ctx 4,096).
15. telemetry: the telemetry layer (``repro_torch.serve.telemetry``) on
   the card, after autotune: (a) the drift and overload scenarios of the
   sim harness with the fake model's tensors on the card, their result
   dicts equal to the CPU's (``scenario_gate``); (b) phase serve's model
   and trace in the fused paged engine priced by the committed H100
   table, ``TELEMETRY_RUNS`` runs each with a ``TelemetryController``
   (drift gate 10%, recalibration on) and without, interleaved: gated on
   equal steps, syncs, uploads and decode dispatches, no device read in
   a step record (``record_sync_gate``), one step record a counted step
   and one request record a completion, every drift sample attributable
   (``attribution_gate``), paged attention in every layer of every decode,
   and the snapshot's round trip (``chiprun_out/telemetry_snapshot.json``);
   it prints the recalibration events, the decode prediction's error at
   the first event and after it, the host step's p50 and p99 and tok/s on
   and off (least and most); (c) the same engine, priced by the model (b)
   recalibrated, the trace's requests arriving one every
   ``SLO_ARRIVAL_GAP`` iterations, first without an SLO and then under
   one at ``SLO_TARGET_FACTOR`` of that run's p99 (the sim overload
   scenario's bucket: window ``SLO_WINDOW``, burst one step's rate, no
   increase): every request completes and first placements stay FIFO,
   with p99 held or not, deferrals and the requests shed (newest first,
   the steps each lost) as readings; reduced f32 gemma2 (phase hotpath's
   trace) for token parity with telemetry on and off, and under the SLO
   against the ungated run of the same arrivals (``telemetry_reduced``);
   and
   ``TELEMETRY_MUST_CATCH`` (a record reading the device, mixed steps fed
   to the detector as decode samples, a retirement stamped by the wall
   clock in place of the injected one).
16. cluster: the serving cluster and the chaos tier
   (``repro_torch.serve.cluster``, ``repro_torch.serve.chaos``): (a) the
   skewed sim trace of ``tests/test_cluster.py`` under round-robin and
   cost-aware placement and the ``chaos_serving`` quick drills, the fake
   model's tensors on the card, each result equal to the CPU's; (b) two
   fused paged replicas of full-width gemma2-2b on one set of weights
   (max_batch 4, max_len 1024, page 16, chunk 64, ``cluster_pool``
   blocks each) serving ``CLUSTER_TRACE`` (12 requests, every second a
   768-token prompt with 32 new tokens, the rest 16 with 8) at
   ``CLUSTER_LOAD`` times a warm replica's step rate through
   ``serve_trace`` (a ``SimClock`` advanced by each tick's largest host
   wall) under sync debugging, once a policy: tokens conserved, the
   router drained, no leaked block, ``host_syncs <= steps + 1`` a
   replica, paged attention in every layer of every decode dispatch,
   tokens in the vocabulary; tok/s, p50/p99, shed rate, reroutes,
   preemptions, each replica's counters and the ranked 2-device topology
   printed; (c) reduced f32 gemma2 (the trace's long prompts cut to
   max_len 64) under the drill's unit prices: equal tokens under both
   policies and from a 1-replica cluster and the bare engine; ``crash``
   and ``corrupt`` on replica 0 of 2 real replicas (``ServingCluster``,
   ``FaultPlan.wrap``, ``ChaosSupervisor``) against the fault-free twin:
   survivors' tokens equal, nothing lost or leaked, the router drained,
   the failure detected, one integrity failure for ``corrupt`` and its
   requests recovered; and ``CLUSTER_MUST_CATCH`` (``_origin`` left
   after collection, the poison written into a copy of the staged
   buffer, a reclaimed request that drops its delivered tokens).
17. wkv6_kernel: the RWKV6 recurrence kernel against its plain version on
   the reference sweep's shapes (B=2, S=24, (H,N) in {(2,32), (4,64)},
   f32) and at the eval shape (B=4, S=4096, H=32, N=64; r, k, v bf16, w
   f32; block_h 1, which changes no value on the card) in three cases
   (``WKV_CASES``): "short", w in [0.7, 0.999]; "long", w = exp(-exp(x))
   with x in [-9, -5] (w in [0.9933, 0.99988], states that carry over
   thousands of steps); "fast", x in [-1, 2.5] (w in [5e-6, 0.69]); with
   times for the kernel (``ms``, ``stream_ms``), the plain version (once)
   and the bound (``wkv_bound``).  In bf16 at most 1% of the outputs may
   differ from the plain version's at all; beside the checks, the
   controls of ``WKV_MUST_CATCH`` on the case where each shows (w one
   step late, w rounded to bf16, u's term dropped, head 0's u for every
   head; the state zeroed every 256 steps, one thread's rows left out of
   y), which they must catch; then "long" and "fast" in f32 at B=1.
18. ssm_kernel: the selective-scan kernel against its plain version on the
   sweep's (Di,N) in {(256,8), (512,16)} in f32 and bf16 (Bt=2, S=32) and
   at the eval shape (Bt=4, S=4224, Di=1600, N=16; x, B, C bf16, dt, A
   f32; block_d 256 -> 64) in two cases (``SSM_CASES``): "eval", init_mamba's
   A (one row for every channel), and "long", an A drawn for each channel
   and dt in [1e-4, 2e-3] (states that carry over thousands of steps);
   with the same times and checks, ``stream_ms`` as the flash kernels',
   the bound counting one exponential a (row, step, channel, state) on
   the special-function units (``EX2_PER_S``), the controls of
   ``SSM_MUST_CATCH`` on the case where each shows (dt or B one step late,
   dt rounded to bf16; channel 0's A for every channel, the state zeroed
   every 256 steps, the last state's term left out of y), and the
   kernel's SASS (MUFU.EX2 count); then "long" in f32 at Bt=1, where a
   biased exponential shows against the f32 tolerance.
19. wkv6_bwd_kernel: the RWKV6 recurrence's gradient (``wkv6_bwd``,
   ``csrc/wkv6_bwd.cu``) against its plain version
   (``ref.wkv6_bwd_plain``) run in f64 on the same inputs and a seeded
   cotangent: phase 17's sweep shapes in f32 and bf16, a ragged shape
   over 16 of the kernel's 64-step segments (the last one 40 steps) in
   f32, the train shape (``WKV_BWD_TRAIN``: B=2, S=4096, H=32, N=64, one
   micro-batch of phase train (c)) in bf16 in every case of
   ``WKV_CASES``, and in f32 at B=1 in every case.  Every gradient (dr,
   dk, dv, dw, du) within ``REC_BWD_TOL`` (f32 1e-4, bf16 1e-2) of its
   max|want|, a second call the same bits, one launch counted; the
   train-shape bf16 runs timed
   (``ms``, ``stream_ms`` as the flash kernels', the bound
   ``wkv_bwd_bound``: 14 N^2 + 16 N f32 operations a (row, step, head);
   no library call), the first also the plain backward once; the
   controls of ``WKV_BWD_MUST_CATCH`` on the f32 run of their case (G
   decayed one step late, dw from S_t, u's term dropped from dk, a column
   group's partial dropped from dr; a segment's start state or end
   cotangent not carried, the segments' decay products left out of the
   combine), each caught by the f32 gate.
20. ssm_bwd_kernel: the same for the scan's gradient (``ssm_scan_bwd``,
   ``csrc/ssm_scan_bwd.cu``; dx, ddt, dB, dC, dA) on phase 18's sweep
   shapes and the train shape (``SSM_BWD_TRAIN``: Bt=2, S=4224, Di=1600,
   N=16) in every case of ``SSM_CASES``, the bound ``ssm_bwd_bound`` (one
   exponential a state element, 18 N + 4 f32 operations a (row, step,
   channel)), and ``SSM_BWD_MUST_CATCH`` (a one step late in the reverse
   walk, a channel group's partial dropped from dB, a row's from dA, a
   chunk-boundary state zeroed).
21. eval_rwkv6: full-width rwkv6-1.6b (24 layers, seeded random bf16
   weights) through ``make_eval_step`` on one ``SyntheticLM`` batch of
   4 x 4096 tokens, under sync debugging; the loss must be finite and
   ``wkv6`` launched once a layer; then ``EVAL_REPS`` more steps timed
   (median, least, most).  Then parity_eval: one 1 x 512 forward through
   the kernel and through its plain version, in f32 and in bf16; logits
   and loss must agree (``PARITY_*``, ``LOSS_RTOL``; in bf16 also the
   mean distance to the f32 forward, ``PARITY_BF16_EXCESS``).  Each line
   holds controls, the plain version with a fault injected (an input one
   step late; in bf16 also the decay rounded to bf16 and ``u`` left in
   f32); the gates must catch those ``MUST_CATCH`` names.
22. eval_hymba: the same for full-width hymba-1.5b (32 layers, 128 meta
   tokens, window 2048 binding at 4224 positions) and ``ssm_scan``, with
   its parity_eval.  Both eval lines hold ``kernel_ms``: one more step
   with a CUDA event pair around each call of the recurrence kernel.
23. reference_eval: reduced f32 rwkv6 and hymba on the card (kernels) and
   on the CPU (plain versions): the losses must agree to 1e-5 relative.
24. recurrent_serve: (a) full-width rwkv6-1.6b and hymba-1.5b (seeded
   random bf16 weights) through the fused slot engine (max_batch 4,
   max_len 1024; 8 prompts of 16-384 tokens, 8 new tokens each, so rows
   are reused) under sync debugging: every request complete in
   vocabulary, at most one sync a step, no ``wkv6``/``ssm_scan`` launch
   (prefill and decode run the reference's scans); readings tok/s, the
   prefill's ms a prompt token, the median step, ``kv_cache_bytes`` and
   peak memory.  (b) decode equivalence at full width in f32 and bf16:
   a prefill of 2 x 256 tokens, then 8 teacher-forced decode steps, each
   step's logits against the train-mode forward (through the recurrence
   kernels) and the cache after them against a prefill of all 264
   tokens (``RECURRENT_LOGIT_TOL``, ``RECURRENT_STATE_TOL``), beside the
   controls of ``RECURRENT_MUST_CATCH`` (a state leaf zeroed before
   every step; hymba decoding at S instead of meta_tokens + S), each of
   which the gate must catch.  (c) reduced f32 rwkv6 and hymba through
   the fused and legacy engines, rows reused, on the card and the CPU:
   tokens equal to the port's teacher-forced greedy decode on the card.

25. flash_bwd_kernel: the flash backward (``flash_attention_bwd``) at
   the train path's shapes (``FLASH_BWD_CASES``, 512 tokens: gemma2-2b's
   B=4, H=8, KH=4, D=256 with softcap 50 and window None or 128, and with
   both off; gemma3-1b's H=4, KH=1, D=256; internlm2-20b's B=2, H=48,
   KH=8, D=128), each in bf16 and in f32 at B=1.  Each case's line names
   the backward that ran (``kernel``), fed the forward's row log-sum-exp
   (``flash_attention_with_lse``, from ``csrc/flash_attention_mma.cu``
   in bf16 and ``csrc/flash_attention.cu`` in f32, whose O must equal
   the plain forward call's bit for bit and whose L must have the +inf
   rows of ``flash_lse_plain`` of the f64 scores and its finite rows
   within ``FLASH_LSE_TOL``): bf16 must take the tensor-core kernels of
   ``csrc/flash_attention_bwd_mma.cu``, held against
   ``flash_attention_bwd_mma_plain`` (P and dS rounded to bf16) fed that
   plain L; f32 must take the CUDA-core kernels of
   ``csrc/flash_attention_bwd.cu``, held against
   ``flash_attention_bwd_plain`` fed that plain L; every gradient within
   ``FLASH_BWD_TOL`` (f32 1e-4, bf16 3e-2) of its max|want|, a second
   call the same bits.  ``ms`` and
   ``stream_ms`` as the flash kernels', the plain version's time, SDPA's
   backward alone (``torch.autograd.grad`` through
   ``F.scaled_dot_product_attention``, causal, GQA) where window and
   softcap are off, and the bound (``_flash_bound_ms(backward=True)``: 5
   products of 2 D a kept pair and query head against 8 tensors moved
   once); the controls of ``FLASH_BWD_MUST_CATCH`` on an f32 case where
   the softcap binds (among them the CUDA-core split's: a part's partial
   dropped, L one row off, the 32 x 32 diagonal tiles dropped from dQ)
   and of ``FLASH_BWD_MMA_MUST_CATCH`` (the rounded plain version with L
   one row off, the diagonal tiles dropped from dQ, a head missing from a
   group's dK and dV) on the bf16 case with both, each caught by its
   dtype's gate, and of ``FLASH_LSE_MUST_CATCH`` (L a row off, a head
   off, the softcap left out) on those two cases' L, each caught by the L
   gate; and ``paged_attention``, the one kernel left without a
   backward, refusing inputs that require grad on the card
   (``guards_raise``).
26. train: (a) full-width gemma2-2b (26 layers, d_model 2304, vocab
   256,000; f32 params, bf16 compute, AdamW) through ``train()``,
   ``TRAIN_FULL`` (3 steps of 8 x 512 tokens, accum 2), priced by the
   committed H100 table, no checkpoint: losses and grad norms finite,
   the params moved, and each step's flash launches exactly remat's,
   2 x 26 x 2 forward and 26 x 2 backward, every backward on the tensor
   cores (``train_launch_gate``);
   readings the losses, the median step of steps 2-3 (host wall around
   a step that ends in a synchronize), tokens/s, the predicted step and
   peak memory.  (b) reduced f32 gemma2 (``TRAIN_REDUCED``, 8 steps) on
   the card and on the CPU from one init, losses within
   ``TRAIN_LOSS_RTOL``, its backward the CUDA-core kernels; then a run of
   4 steps with a checkpoint and a restarted run to 8, its losses the
   uninterrupted run's.  (c) full-width rwkv6-1.6b (24 layers) and
   hymba-1.5b (32 layers, 128 meta tokens) through ``train()``, seeded
   random weights, f32 params, bf16 compute, AdamW, remat,
   ``TRAIN_RECURRENT`` (3 steps of 4 x 4096 tokens, accum 2: the
   configs' microbatch cut to ``TRAIN_RECURRENT_MICRO`` rows): losses and
   grad norms finite, params moved (the recurrence's own among them), and
   each step's launches exactly remat's, ``wkv6`` 2 x 24 x 2 forward and
   24 x 2 backward, ``ssm_scan`` 2 x 32 x 2 and 32 x 2
   (``train_want_per_step``); readings the median step of steps 2-3,
   tokens/s and peak memory.  (d) reduced f32 rwkv6 and hymba,
   ``TRAIN_REDUCED`` on the card (the recurrences' kernels) and on the
   CPU (their plain versions) from one init: losses within
   ``TRAIN_LOSS_RTOL``, backward launches above 0 on the card.

Run order: the card phase starts every build and returns; phases 2-8
then run, each waiting for the kernels it launches, then phases 17-20,
while the probe kernels finish building; ``build_wait`` (the card line,
with each build's seconds) waits for the rest before phase 9.

A ``timing`` line gives each phase's seconds; the line before the last
holds every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
sources beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
BF16_OPS_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
# exponentials: one MUFU.EX2 each, 16 a cycle on each of 132 SMs at the
# H100 SXM's nominal 1,980 MHz boost clock
EX2_PER_S = 132 * 16 * 1.98e9
OUT = ROOT / "chiprun_out"
KERNEL_TOL = dict(atol=1e-2, rtol=1e-2)
LOGIT_ATOL = 0.1
# parity of the full-width recurrent forward, kernel vs plain version,
# each gate run beside faults it must catch (``_faults``, ``MUST_CATCH``).
# In f32 only the summation order inside the recurrence differs: the
# strict check, for every fault that is not bf16's own.  In bf16 an
# output of the recurrence one bf16 ulp apart is carried through every
# later layer, so the largest of 512 x 65536 logits moves by about a tenth
# (0.113 on rwkv6): the max gate, a quarter of the logits' scale, catches
# gross faults only.  The bf16 faults are held by the mean distance to the
# f32 forward on the same weights: the kernel's may exceed the plain
# version's by 5% (sound runs: 0.45% and -0.09%; ``w`` staged in bf16:
# +85%).
PARITY_BF16_ATOL = 0.25
LOSS_RTOL = 1e-3
PARITY_BF16_EXCESS = 1.05
PARITY_F32_ATOL = 1e-3
PARITY_F32_LOSS_RTOL = 1e-5
# the controls each parity gate must catch in every run
MUST_CATCH = {"rwkv6-1.6b": {"float32": ("k_late", "w_late"),
                             "bfloat16": ("k_late", "w_bf16")},
              "hymba-1.5b": {"float32": ("B_late", "dt_late"),
                             "bfloat16": ()}}
EVAL_REPS = 3                     # timed eval steps after the checked one


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_ms(torch, fn, reps, flush=None):
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the L2 cache flushed before each when ``flush`` is given."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_card(torch):
    """The card's name and power limit, printed; every kernel's build
    started at once in the background (``card_builds`` waits for them).
    A phase that launches a kernel still being built waits for that
    build (``_build.build``)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    pool = ThreadPoolExecutor(max_workers=1)
    builds = (pool.submit(_build.build_all, variants=alu_control_sources()),
              time.perf_counter())
    pool.shutdown(wait=False)
    return card, builds


def card_builds(torch, card, builds):
    """Wait for phase card's builds and print their line: nvcc's output of
    each to stderr, the seconds from their start to the last one's end
    (``build_s``) and each one's own."""
    from repro_torch.kernels import _build
    future, t0 = builds
    libs = future.result()
    build_s = time.perf_counter() - t0
    for name in libs:
        print(f"[{name}] nvcc:\n{_build.BUILD_LOG[name]['log']}",
              file=sys.stderr)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "kernels_built": sorted(libs),
          "build_seconds": {n: _build.BUILD_LOG[n]["seconds"]
                            for n in sorted(libs)}})
    return card


# the paged gate's fault controls, each the plain version with one fault,
# run on the chunk-boundary contexts (short rows, where one token moves the
# output past ``KERNEL_TOL``), with the case's window, softcap and q scale:
# the window one token wider, the softcap dropped where raw scores pass
# +-50, the query's own token (ctx-1) excluded, the unbacked page read as
# page 0, and the first token of the kernel's second chunk dropped
PAGED_MUST_CATCH = {"window_wider": dict(window=8, softcap=None, q_mul=1.0),
                    "softcap_dropped": dict(window=None, softcap=50.0,
                                            q_mul=30.0),
                    "last_token_excluded": dict(window=None, softcap=None,
                                                q_mul=1.0),
                    "unbacked_read_as_page0": dict(window=None, softcap=None,
                                                   q_mul=1.0),
                    "chunk_token_dropped": dict(window=None, softcap=None,
                                                q_mul=1.0)}
# contexts at and beside the kernel's chunk boundaries and the full table
BOUNDARY_CTXS = [31, 32, 33, 63, 64, 65, 128, 1024]
# copies of the inputs a graph's calls cycle over, so that what they read
# (88 MB of touched pool pages; 128 MB of SDPA's gathered K/V) exceeds the
# H100's 50 MB L2 and no call finds its bytes there
POOL_COPIES = 8
GATHERED_COPIES = 2


def _kernel_inputs(torch, np, dev, seed, ctxs, hole):
    B, H, KH, D, bs, NB = 8, 8, 4, 256, 16, 64
    rng = np.random.default_rng(seed)
    pages = sum(-(-c // bs) for c in ctxs)
    P = 256
    perm = rng.permutation(P)
    bt = np.full((B, NB), -1, np.int32)
    used = 0
    for b, c in enumerate(ctxs):
        n = -(-c // bs)
        bt[b, :n] = perm[used:used + n]
        used += n
    assert used == pages <= P
    bt[hole] = -1                           # an unbacked page inside a ctx
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((P, bs, KH, D), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((P, bs, KH, D), generator=g, device=dev).to(torch.bfloat16)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.tensor(ctxs, dtype=torch.int32, device=dev), bt, ctxs)


def _bound_ms(bt, ctxs, window, H, KH, D, bs):
    """Least time for the work these inputs need: every K and V row of the
    valid context (inside the window, in a backed page) read once, q read
    and the output written once; against the bf16 op count."""
    tokens = 0
    for b, c in enumerate(ctxs):
        lo = max(0, c - window) if window else 0
        tokens += sum(1 for t in range(lo, c) if bt[b, t // bs] >= 0)
    nbytes = tokens * KH * D * 2 * 2 + 2 * len(ctxs) * H * D * 2 \
        + bt.size * 4 + len(ctxs) * 4
    ops = tokens * H * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def graph_ms(calls, n=20):
    """Device time in ms of one call, by the measurement harness's
    ``device_time``: ``n`` calls captured in one CUDA graph, call i running
    ``calls[i % len(calls)]`` (each on its own copy of the inputs), the
    graph replayed between one CUDA event pair, over ``n``; the median of
    5 replays.  No host cost is in it, and a call that read a device value
    on the host could not be captured."""
    from repro_torch.core.microbench.harness import device_time
    return 1e3 * device_time(calls, iters=n)


def _paged_fault(torch, ref, name, q, kp, vp, bt, ctx, kw, chunk):
    """The plain version with fault ``name`` on the case's inputs."""
    if name == "window_wider":
        return ref.paged_attention_plain(q, kp, vp, bt, ctx,
                                         **{**kw, "window": kw["window"] + 1})
    if name == "softcap_dropped":
        return ref.paged_attention_plain(q, kp, vp, bt, ctx,
                                         **{**kw, "softcap": None})
    if name == "last_token_excluded":
        # without a window, attention over [0, ctx-1) is ctx - 1's
        return ref.paged_attention_plain(q, kp, vp, bt,
                                         (ctx - 1).clamp(min=0), **kw)
    if name == "unbacked_read_as_page0":
        return ref.paged_attention_plain(q, kp, vp, bt.clamp(min=0), ctx, **kw)
    # token `chunk` (the first of the second chunk) masked in every row
    s, v, valid = ref._scores_and_valid(
        q, kp, vp, bt, ctx, scale=kw["scale"], window=kw["window"],
        softcap=kw["softcap"])
    valid[:, chunk] = False
    p = torch.softmax(torch.where(valid[:, None, :], s, ref.NEG_INF), -1)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    return torch.where((ctx > 0)[:, None, None], out, 0.0).to(q.dtype)


def phase_kernel(torch, np, dev, seed):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (CHUNK_TOKENS, CHUNKS,
                                                     paged_attention)

    ctxs = [0, 1, 17, 300, 1024, 1024, 300, 17]
    q, kp, vp, bt, ctx, bt_np, ctxs = _kernel_inputs(torch, np, dev, seed,
                                                     ctxs, (3, 5))
    B, H, D = q.shape
    KH, bs = kp.shape[2], kp.shape[1]
    scale = D ** -0.5
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    pools = [(kp, vp)] + [(kp.clone(), vp.clone())
                          for _ in range(POOL_COPIES - 1)]
    # the library yardstick: SDPA over K/V gathered to contiguous [B,H,L,D]
    k_all = ref.gather_pages(kp, bt).repeat_interleave(H // KH, 2)
    v_all = ref.gather_pages(vp, bt).repeat_interleave(H // KH, 2)
    k_all, v_all = (t.permute(0, 2, 1, 3).contiguous() for t in (k_all, v_all))
    gathered = [(k_all, v_all)] + [(k_all.clone(), v_all.clone())
                                   for _ in range(GATHERED_COPIES - 1)]
    L = k_all.shape[2]
    lslot = torch.arange(L, device=dev)
    page_ok = bt.long()[:, lslot // bs] >= 0
    cases, max_err = [], 0.0
    for window in (None, 8, 4096):
        for softcap in (None, 50.0):
            for ns in (1, 4):
                kw = dict(scale=scale, window=window, softcap=softcap,
                          num_splits=ns)
                out = paged_attention(q, kp, vp, bt, ctx, **kw)
                torch.cuda.synchronize()
                want = ref.paged_attention_plain(q, kp, vp, bt, ctx, **kw)
                err = (out.float() - want.float()).abs().max().item()
                torch.testing.assert_close(out.float(), want.float(),
                                           **KERNEL_TOL)
                max_err = max(max_err, err)
                ms = gpu_ms(torch, lambda: paged_attention(
                    q, kp, vp, bt, ctx, **kw), 30, flush)
                g_ms = graph_ms([
                    (lambda k=k, v=v: paged_attention(q, k, v, bt, ctx, **kw))
                    for k, v in pools])
                plain_ms = gpu_ms(torch, lambda: ref.paged_attention_plain(
                    q, kp, vp, bt, ctx, **kw), 5, flush)
                lib_ms = lib_g_ms = None
                if softcap is None:       # SDPA has no logit softcap
                    valid = (lslot[None] < ctx[:, None].long()) & page_ok
                    if window:
                        valid &= (ctx[:, None].long() - 1 - lslot[None]) \
                            < window
                    mask = valid[:, None, None, :]
                    q4 = q[:, :, None, :]
                    lib_ms = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
                        q4, k_all, v_all, attn_mask=mask, scale=scale), 30, flush)
                    lib_g_ms = graph_ms([
                        (lambda k=k, v=v: F.scaled_dot_product_attention(
                            q4, k, v, attn_mask=mask, scale=scale))
                        for k, v in gathered])
                bound, bound_by = _bound_ms(bt_np, ctxs, window, H, KH, D, bs)
                case = {"window": window, "softcap": softcap,
                        "num_splits": ns, "chunk_tokens": CHUNK_TOKENS,
                        "max_abs_err": err,
                        "mismatch": (out != want).float().mean().item(),
                        "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "library_graph_ms": lib_g_ms,
                        "bound_ms": bound, "bound_by": bound_by}
                cases.append(case)
                emit({"phase": "kernel", "name": "paged_attention", **case})
    # the chunk, by measurement: each size the kernel takes at the main case
    kw = dict(scale=scale, window=None, softcap=None)
    want = ref.paged_attention_plain(q, kp, vp, bt, ctx, **kw)
    sweep = {}
    for chunk in CHUNKS:
        kc = dict(kw, chunk_tokens=chunk)
        out = paged_attention(q, kp, vp, bt, ctx, **kc)
        torch.testing.assert_close(out.float(), want.float(), **KERNEL_TOL)
        sweep[chunk] = {
            "ms": gpu_ms(torch, lambda: paged_attention(q, kp, vp, bt, ctx,
                                                        **kc), 30, flush),
            "graph_ms": graph_ms([
                (lambda k=k, v=v: paged_attention(q, k, v, bt, ctx, **kc))
                for k, v in pools])}
    emit({"phase": "kernel", "name": "paged_attention",
          "chunk_sweep": sweep, "default": CHUNK_TOKENS})
    del pools, gathered
    max_err = max(max_err, _paged_boundary(torch, np, ref, paged_attention,
                                           dev, seed, scale, CHUNK_TOKENS))
    return cases, max_err


def _paged_boundary(torch, np, ref, paged_attention, dev, seed, scale,
                    chunk):
    """The kernel on contexts at and beside its chunk boundaries against
    the plain version, and the controls in ``PAGED_MUST_CATCH`` on them;
    returns the largest absolute error."""
    q, kp, vp, bt, ctx, _, _ = _kernel_inputs(torch, np, dev, seed + 1,
                                              BOUNDARY_CTXS, (3, 2))
    checks, controls, max_err = [], {}, 0.0
    for q_mul, window, softcap in [(1.0, w, c) for w in (None, 8, 40, 4096)
                                   for c in (None, 50.0)] + [(30.0, None,
                                                              50.0)]:
        qc = (q.float() * q_mul).to(q.dtype)
        for ns in (1, 4):
            kw = dict(scale=scale, window=window, softcap=softcap,
                      num_splits=ns)
            out = paged_attention(qc, kp, vp, bt, ctx, **kw)
            torch.cuda.synchronize()
            want = ref.paged_attention_plain(qc, kp, vp, bt, ctx, **kw)
            torch.testing.assert_close(out.float(), want.float(),
                                       **KERNEL_TOL)
            err = (out.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            checks.append({"window": window, "softcap": softcap,
                           "q_mul": q_mul, "num_splits": ns,
                           "max_abs_err": err,
                           "tol_ratio": _tol_ratio(out, want),
                           "mismatch": (out != want).float().mean().item()})
            if ns != 1:
                continue
            for name, at in PAGED_MUST_CATCH.items():
                if (at["window"], at["softcap"], at["q_mul"]) == (
                        window, softcap, q_mul):
                    got = _paged_fault(torch, ref, name, qc, kp, vp, bt, ctx,
                                       kw, chunk)
                    r = _tol_ratio(got, want)
                    controls[name] = {"tol_ratio": r, "caught": r > 1,
                                      "mismatch": (got != want).float()
                                      .mean().item()}
    emit({"phase": "kernel", "name": "paged_attention",
          "boundary_ctxs": BOUNDARY_CTXS, "checks": checks,
          "controls": controls})
    missed = [n for n in PAGED_MUST_CATCH
              if not controls.get(n, {}).get("caught")]
    if missed:
        raise AssertionError(f"the paged gate misses {missed}: {controls}")
    return max_err


def _flash_bound_ms(B, Sq, Skv, H, KH, D, causal, window, elem=2,
                    ops_per_s=BF16_OPS_PER_S, backward=False):
    """Least time for the work these inputs need: Q, K, V read once and
    the output written once, against the operations of the (query, key)
    pairs the mask keeps (2 * D for the score, 2 * D for P @ V) at the
    inputs' type's peak.  With ``backward``: q, k, v, o and dO read once
    and dq, dk, dv written once, against 5 products of 2 * D a kept pair
    and query head (S, dP, dV, dQ, dK)."""
    import numpy as np
    qp = np.arange(Sq)
    hi = np.minimum(qp, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(Sq, int)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    per_side = 4 if backward else 2
    nbytes = elem * D * per_side * (B * Sq * H + B * Skv * KH)
    ops = 2 * D * (5 if backward else 2) * H * B * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def stream_ms(torch, fn, n=20, reps=5):
    """Device time of ``fn``: ``n`` launches back to back between one CUDA
    event pair, over ``n``; the median of ``reps`` such runs.  The host's
    cost of a launch hides behind the device's work wherever it is the
    smaller of the two."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


# the flash gate's fault controls, each the plain version with one fault,
# and the case that runs it (in bf16 on the tensor-core kernel and in f32
# on the CUDA-core one): the window one key wider, the softcap dropped
# where raw scores pass +-50, and the diagonal key excluded (keys < q_pos)
FLASH_MUST_CATCH = {"window_65": dict(B=1, S=900, H=8, window=64,
                                      softcap=None, q_mul=1.0),
                    "softcap_dropped": dict(B=1, S=900, H=8, window=None,
                                            softcap=50.0, q_mul=30.0),
                    "diagonal_excluded": dict(B=1, S=900, H=8, window=None,
                                              softcap=None, q_mul=1.0)}
# the CUDA-core kernel's split faults, each the plain version run item by
# item (``work_split``, ``item_partial``) and merged with one fault, on the
# f32 prefill case (B=1, S=900, causal), whose query tiles split into up
# to 4 items: the first item of the last split tile dropped, the merge
# without its exp(m_s - m*) rescale, and each later item starting one key
# early (the key at an item boundary counted twice)
SPLIT_MUST_CATCH = ("partial_dropped", "merge_unscaled", "boundary_key_twice")
# the f32 gate of the CUDA-core kernel, scaled by max|want| as
# ``_check_close`` scales it: the kernel and the plain version differ in
# summation order only
FLASH_F32_TOL = 1e-5


def _flash_fault(torch, ref, name, q, k, v, kw, want):
    """The plain version with fault ``name`` on the case's inputs."""
    if name == "window_65":
        return ref.flash_attention_plain(q, k, v, **{**kw, "window": 65})
    if name == "softcap_dropped":
        return ref.flash_attention_plain(q, k, v, **{**kw, "softcap": None})
    # row i at position i - 1 over keys 0 .. i-1: a strict causal mask;
    # row 0, which it leaves with no key, keeps the sound output
    strict = ref.flash_attention_plain(q[:, 1:], k[:, :-1], v[:, :-1], **kw)
    return torch.cat([want[:, :1], strict], dim=1)


def _split_fault(torch, name, q, k, v, kw):
    """The plain version item by item, merged, with split fault ``name``."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, _ = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    sp = fa.work_split(B, Sq, Skv, H, KH, causal=kw["causal"],
                       window=kw["window"])
    split = [i for i in range(sp.nq) if len(sp.items(i)) > 1]
    pkw = {key: kw[key] for key in ("causal", "window", "softcap", "scale")}
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(sp.nq):
        q_lo, q_hi = i * sp.bq, min((i + 1) * sp.bq, Sq)
        keys = [(jb * sp.lk, je * sp.lk) for jb, je in sp.items(i) if je > jb]
        if name == "partial_dropped" and i == split[-1]:
            keys = keys[1:]
        if name == "boundary_key_twice":
            keys = [(lo - (s > 0), hi) for s, (lo, hi) in enumerate(keys)]
        parts = [fa.item_partial(q, k, v, q_lo, q_hi, lo, hi, **pkw)
                 for lo, hi in keys]
        if name == "merge_unscaled":
            out[:, q_lo:q_hi] = sum(p[2] for p in parts) / torch.clamp(
                sum(p[1] for p in parts), min=1e-30)[..., None]
        else:
            out[:, q_lo:q_hi] = fa.merge_partials(parts)
    return out.to(q.dtype)


def _tol_ratio(got, want):
    """max |got - want| / the gate's limit for ``want``'s dtype: in bf16
    atol + rtol |want| under ``KERNEL_TOL``, in f32 ``FLASH_F32_TOL``
    (|want| + max|want|); the gate passes at <= 1."""
    f32 = want.dtype == want.float().dtype
    got, want = got.float(), want.float()
    if f32:
        lim = FLASH_F32_TOL * (want.abs() + want.abs().max())
    else:
        lim = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * want.abs()
    return ((got - want).abs() / lim).max().item()


def phase_flash_kernel(torch, dev, seed):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (SIMT, flash_attention,
                                                      kernel_for,
                                                      kernel_tiles,
                                                      work_split)

    bf16, f32 = torch.bfloat16, torch.float32
    base = dict(B=1, S=900, H=8, KH=4, D=256, window=None, softcap=None,
                causal=True, acc="f32", dtype=bf16, q_mul=1.0, block_k=128)
    cases = [{**base, "B": B, "S": S, "window": w, "softcap": c}
             for B, S in ((1, 1), (1, 52), (1, 768), (1, 900), (8, 512))
             for w in (None, 64, 4096) for c in (None, 50.0)]
    cases += [{**base, "causal": False},
              {**base, "softcap": 50.0, "q_mul": 30.0}]
    # the CUDA-core kernel in f32: window x softcap at the prefill, the
    # batch, non-causal, the binding softcap and a GQA group of 7
    cases += [{**base, "dtype": f32, "window": w, "softcap": c}
              for w in (None, 64, 4096) for c in (None, 50.0)]
    cases += [{**base, "dtype": f32, "B": 8, "S": 512},
              {**base, "dtype": f32, "causal": False},
              {**base, "dtype": f32, "softcap": 50.0, "q_mul": 30.0},
              {**base, "dtype": f32, "H": 56, "KH": 8, "D": 128}]
    # ... and with the bf16 accumulator, which rounds every block_k keys
    cases += [{**base, "window": 4096, "softcap": 50.0, "acc": "bf16",
               "block_k": bk} for bk in (16, 128, 256)]
    g = torch.Generator(device=dev).manual_seed(seed)
    out_cases, max_err = [], {}
    controls = {"bfloat16": {}, "float32": {}}
    for c in cases:
        B, S, dt, q_mul = c["B"], c["S"], c["dtype"], c["q_mul"]
        H, KH, D = c["H"], c["KH"], c["D"]
        scale = D ** -0.5
        q = (torch.randn((B, S, H, D), generator=g, device=dev)
             * q_mul).to(dt)
        k = torch.randn((B, S, KH, D), generator=g, device=dev).to(dt)
        v = torch.randn((B, S, KH, D), generator=g, device=dev).to(dt)
        kw = dict(causal=c["causal"], window=c["window"],
                  softcap=c["softcap"], scale=scale, acc_dtype=c["acc"],
                  block_k=c["block_k"])
        kernel = kernel_for(dt, c["acc"], D)
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_plain(q, k, v, **kw)
        err = (out.float() - want.float()).abs().max().item()
        if dt == f32:
            tol = FLASH_F32_TOL
            torch.testing.assert_close(
                out, want, rtol=tol, atol=tol * want.abs().max().item())
        else:
            torch.testing.assert_close(out.float(), want.float(),
                                       **KERNEL_TOL)
        max_err[kernel] = max(max_err.get(kernel, 0.0), err)
        dname = str(dt).split(".")[-1]
        faults = {}
        if c["causal"] and c["acc"] == "f32":
            faults = {name: lambda name=name: _flash_fault(
                torch, ref, name, q, k, v, kw, want)
                for name, at in FLASH_MUST_CATCH.items()
                if all(c[key] == val for key, val in at.items())}
            if (dt == f32 and c["H"] == 8 and (B, S, q_mul) == (1, 900, 1.0)
                    and c["window"] is None and c["softcap"] is None):
                faults.update({name: lambda name=name: _split_fault(
                    torch, name, q, k, v, kw) for name in SPLIT_MUST_CATCH})
        for name, fn in faults.items():
            got = fn()
            controls[dname][name] = {
                "tol_ratio": _tol_ratio(got, want),
                "mismatch": (got != want).float().mean().item()}
            controls[dname][name]["caught"] = \
                controls[dname][name]["tol_ratio"] > 1
        ms = gpu_ms(torch, lambda: flash_attention(q, k, v, **kw), 20)
        s_ms = stream_ms(torch, lambda: flash_attention(q, k, v, **kw))
        plain_ms = gpu_ms(torch, lambda: ref.flash_attention_plain(
            q, k, v, **kw), 3)
        lib_ms = lib_s_ms = None
        if c["window"] is None and c["softcap"] is None:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=c["causal"], scale=scale,
                    enable_gqa=True)
            lib_ms, lib_s_ms = gpu_ms(torch, sdpa, 20), stream_ms(torch, sdpa)
        elem = 2 if dt == bf16 else 4
        bound, bound_by = _flash_bound_ms(
            B, S, S, H, KH, D, c["causal"], c["window"], elem,
            BF16_OPS_PER_S if dt == bf16 else F32_OPS_PER_S)
        case = {"kernel": kernel, "dtype": dname, "B": B, "Sq": S, "Skv": S,
                "H": H, "KH": KH, "D": D, "causal": c["causal"],
                "window": c["window"], "softcap": c["softcap"],
                "q_mul": q_mul, "acc_dtype": c["acc"],
                "block_k": c["block_k"],
                "tiles": kernel_tiles(H, KH, D, S, c["block_k"], c["acc"],
                                      dt),
                "max_abs_err": err,
                "mismatch": (out != want).float().mean().item(),
                "ms": ms, "stream_ms": s_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_stream_ms": lib_s_ms,
                "bound_ms": bound, "bound_by": bound_by}
        if kernel == SIMT:
            sp = work_split(B, S, S, H, KH, causal=c["causal"],
                            window=c["window"], acc_dtype=c["acc"],
                            block_k=c["block_k"])
            case["split"] = {"T": sp.T, "smax": sp.smax}
        out_cases.append(case)
        emit({"phase": "flash_kernel", "name": "flash_attention", **case})
    emit({"phase": "flash_kernel", "controls": controls})
    missed = [f"{d}:{n}" for d, names in (
        ("bfloat16", FLASH_MUST_CATCH),
        ("float32", tuple(FLASH_MUST_CATCH) + SPLIT_MUST_CATCH))
        for n in names if not controls[d].get(n, {}).get("caught")]
    if missed:
        raise AssertionError(f"the flash gate misses {missed}: {controls}")
    return out_cases, max_err


def _wrappers():
    from repro_torch.kernels.alu_chain import alu_chain
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mxu_probe import mxu_probe
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.pointer_chase import pointer_chase
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.kernels.wkv6 import wkv6
    return {f.__name__: f for f in (paged_attention, flash_attention,
                                    alu_chain, pointer_chase, mxu_probe,
                                    wkv6, ssm_scan)}


def reset_launches():
    """Zero every kernel's launch count, just before a path is driven."""
    wrappers = _wrappers()
    for f in wrappers.values():
        f.launches = 0
    wrappers["flash_attention"].mma_launches = 0
    wrappers["flash_attention"].bwd_launches = 0
    wrappers["flash_attention"].bwd_mma_launches = 0
    wrappers["wkv6"].bwd_launches = 0
    wrappers["ssm_scan"].bwd_launches = 0


def launch_counts():
    """Each wrapper's launches; ``flash_attention`` counts both flash
    forward kernels, ``flash_attention_mma`` the tensor-core one alone,
    ``flash_attention_bwd`` both backwards' launches,
    ``flash_attention_bwd_mma`` the tensor-core backward's; ``wkv6_bwd``
    and ``ssm_scan_bwd`` the recurrences' backwards'."""
    wrappers = _wrappers()
    counts = {name: f.launches for name, f in wrappers.items()}
    counts["flash_attention_mma"] = wrappers["flash_attention"].mma_launches
    counts["flash_attention_bwd"] = wrappers["flash_attention"].bwd_launches
    counts["flash_attention_bwd_mma"] = \
        wrappers["flash_attention"].bwd_mma_launches
    counts["wkv6_bwd"] = wrappers["wkv6"].bwd_launches
    counts["ssm_scan_bwd"] = wrappers["ssm_scan"].bwd_launches
    return counts


def serve_setup(np, dev, seed):
    """Full-width gemma2-2b with seeded random weights (matrices stored once
    in bf16) and the serving trace: 8 prompts of 16-900 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model

    cfg = get_config("gemma2-2b")
    model = build_model(cfg, device=dev)
    params = model.init(seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 901, size=8)]
    return cfg, model, params, prompts


def phase_serve(torch, np, dev, seed):
    from repro_torch.serve.engine import PagedServingEngine

    cfg, model, params, prompts = serve_setup(np, dev, seed)
    kw = dict(max_batch=8, max_len=1024, block_size=16, chunk_size=64)

    warm = PagedServingEngine(model, params, **kw)
    warm.submit(prompts[0][:40], max_new_tokens=4)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = PagedServingEngine(model, params, **kw)
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    step_ms, run_s, counts = drive(torch, eng)
    launches = counts["paged_attention"]
    st = eng.stats
    eng.allocator.check()
    if st.completed != 8:
        raise AssertionError(f"completed {st.completed} of 8 requests")
    if eng.allocator.n_free != eng.n_blocks:
        raise AssertionError("blocks leaked")
    if st.host_syncs > st.steps + 1:
        raise AssertionError(f"{st.host_syncs} syncs over {st.steps} steps")
    if launches == 0 or launches != cfg.n_layers * st.decode_dispatches:
        raise AssertionError(f"{launches} kernel launches != {cfg.n_layers}"
                             f" x {st.decode_dispatches} decode dispatches")
    toks = [eng.done[r].tokens for r in rids]
    if any(len(t) != 32 or min(t) < 0 or max(t) >= cfg.vocab_size
           for t in toks):
        raise AssertionError("a request came back short or out of vocab")
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "requests": len(prompts), "prompt_tokens": [len(p) for p in prompts],
          "completed": st.completed, "decoded_tokens": st.decoded_tokens,
          "steps": st.steps, "decode_dispatches": st.decode_dispatches,
          "prefill_chunks": st.prefill_chunks, "host_syncs": st.host_syncs,
          "table_uploads": st.table_uploads, "compactions": st.compactions,
          "kernel_launches": counts, "run_s": run_s,
          "decode_tok_per_s": st.decoded_tokens / run_s,
          "median_step_ms": statistics.median(step_ms),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "kv_pool_gib": eng.kv_cache_bytes() / 2 ** 30})
    del eng
    torch.cuda.empty_cache()
    return model, params, prompts, launches, toks


def drive(torch, eng, arrive=None):
    """Step ``eng`` to the end under sync debugging ("error") on the card,
    with every launch count zeroed just before; returns each step's host
    ms, the run's wall seconds and the launch counts read just after.
    ``arrive(i)``, when given, submits what arrives before iteration ``i``
    and returns whether more is still to come."""
    step_ms = []
    cuda = eng.device.type == "cuda"
    reset_launches()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    t_run = time.perf_counter()
    try:
        for i in itertools.count():
            more = arrive(i) if arrive is not None else False
            t0 = time.perf_counter()
            active = eng.step()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if active == 0 and not eng.queue and not more:
                break
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    return step_ms, run_s, launch_counts()


def phase_serve_slot(torch, model, params, prompts):
    """The paged phase's model and prompts through the slot engine."""
    from repro_torch.serve.engine import ServingEngine

    cfg = model.cfg
    kw = dict(max_batch=8, max_len=1024)
    warm = ServingEngine(model, params, **kw)
    warm.submit(prompts[0][:40], max_new_tokens=4)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = ServingEngine(model, params, **kw)
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    step_ms, run_s, counts = drive(torch, eng)
    launches = counts["flash_attention_mma"]
    st = eng.stats
    if st.completed != len(prompts):
        raise AssertionError(f"completed {st.completed} of {len(prompts)}")
    if st.host_syncs > st.steps + 1:
        raise AssertionError(f"{st.host_syncs} syncs over {st.steps} steps")
    if (launches == 0 or launches != cfg.n_layers * st.prefills
            or counts["flash_attention"] != launches):
        raise AssertionError(f"{counts['flash_attention']} flash launches, "
                             f"{launches} tensor-core, != {cfg.n_layers} x "
                             f"{st.prefills} prefills")
    toks = [eng.done[r].tokens for r in rids]
    if any(len(t) != 32 or min(t) < 0 or max(t) >= cfg.vocab_size
           for t in toks):
        raise AssertionError("a request came back short or out of vocab")
    emit({"phase": "serve_slot", "arch": cfg.name, "layers": cfg.n_layers,
          "requests": len(prompts), "completed": st.completed,
          "decoded_tokens": st.decoded_tokens, "steps": st.steps,
          "prefills": st.prefills, "host_syncs": st.host_syncs,
          "kernel_launches": counts, "run_s": run_s,
          "decode_tok_per_s": st.decoded_tokens / run_s,
          "median_step_ms": statistics.median(step_ms),
          "first_step_ms": step_ms[0],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "slot_cache_gib": eng.kv_cache_bytes() / 2 ** 30})
    del eng
    torch.cuda.empty_cache()
    return launches, toks


def phase_parity(torch, np, model, params, seed):
    """One full-width batched decode step through the kernel, and through
    the plain version called explicitly, on the same pool."""
    from repro_torch.kernels.ref import paged_attention_plain

    cfg, dev = model.cfg, model.device
    B, bs, NB = 8, 16, 64
    cache = model.init_paged_cache(B * NB, bs)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    bt = torch.arange(B * NB, dtype=torch.int32, device=dev).view(B, NB)
    pos = torch.tensor([0, 16, 299, 1000, 500, 63, 777, 128],
                       dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev)
    twin = {k: v.clone() for k, v in cache.items()}
    lk, _ = model.decode(params, cache, toks, pos, bt)
    lp, _ = model.decode(params, twin, toks, pos, bt,
                         paged_fn=paged_attention_plain)
    diff = (lk - lp).abs().max().item()
    mean_diff = (lk - lp).abs().mean().item()
    flips = int((lk.argmax(-1) != lp.argmax(-1)).sum().item())
    if not torch.isfinite(lk).all() or diff > LOGIT_ATOL:
        raise AssertionError(f"kernel vs plain logits differ by {diff}")
    emit({"phase": "parity", "logit_max_abs_diff": diff,
          "logit_mean_abs_diff": mean_diff,
          "logit_atol": LOGIT_ATOL, "logit_std": lk.float().std().item(),
          "greedy_tokens_differing": flips, "rows": B})


def phase_parity_slot(torch, np, model, params, seed):
    """One full-width prefill of a 900-token prompt through the flash
    kernel, and through the plain version called explicitly; beside the
    gate, the logits of two faults in every layer against the sound plain
    prefill (readings: what the gate would catch)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import flash_attention_plain

    rng = np.random.default_rng(seed + 2)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         size=(1, 900)).astype(np.int32))
    batch = {"tokens": toks.to(model.device)}
    lk, ck = model.prefill(params, batch, max_len=1024)
    lp, _ = model.prefill(params, batch, max_len=1024,
                          flash_fn=flash_attention_plain)
    diff = (lk - lp).abs().max().item()
    mean_diff = (lk - lp).abs().mean().item()
    flipped = bool((lk.argmax(-1) != lp.argmax(-1)).any().item())
    if not torch.isfinite(lk).all() or diff > LOGIT_ATOL:
        raise AssertionError(f"flash kernel vs plain logits differ by {diff}")
    if tuple(ck["k"].shape) != (model.cfg.n_layers, 1, 1024,
                                model.cfg.n_kv_heads, model.cfg.head_dim):
        raise AssertionError(f"prefill cache shape {tuple(ck['k'].shape)}")
    del ck

    def faulty(name):
        def fn(q, k, v, **kw):
            # row 0's sound output, which the strict mask leaves keyless
            row0 = flash_attention_plain(q[:, :1], k[:, :1], v[:, :1], **kw)
            return _flash_fault(torch, ref, name, q, k, v, kw, row0)
        return fn

    controls = {}
    for name in ("softcap_dropped", "diagonal_excluded"):
        lf, _ = model.prefill(params, batch, max_len=1024,
                              flash_fn=faulty(name))
        fdiff = (lf - lp).abs().max().item()
        controls[name] = {"logit_max_abs_diff": fdiff,
                          "caught": fdiff > LOGIT_ATOL}
    emit({"phase": "parity_slot", "prompt_tokens": 900,
          "logit_max_abs_diff": diff, "logit_mean_abs_diff": mean_diff,
          "logit_atol": LOGIT_ATOL, "logit_std": lk.float().std().item(),
          "greedy_token_flipped": flipped, "controls": controls})


def phase_reference(torch, np, seed):
    """Reduced f32 gemma2 served on the card (kernels) and on the CPU
    (plain attention), through both engines: the tokens must be
    identical."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine

    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 40, size=8)]
    engines = {
        "paged": lambda m, p: PagedServingEngine(
            m, p, max_batch=4, max_len=64, block_size=8, n_blocks=12,
            chunk_size=8),
        "slot": lambda m, p: ServingEngine(m, p, max_batch=4, max_len=64)}
    cpu_params = build_model(cfg, device="cpu").init(seed)
    same = {}
    reset_launches()
    for name, make in engines.items():
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, device=dev)
            eng = make(model, params_to(cpu_params, dev))
            rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.run_until_done()
            out[dev] = [eng.done[r].tokens for r in rids]
        same[name] = out["cuda"] == out["cpu"]
    counts = launch_counts()
    if not all(same.values()):
        raise AssertionError(f"card and CPU tokens differ on the reduced "
                             f"f32 model: {same}")
    if counts["flash_attention"] == 0 or counts["flash_attention_mma"]:
        raise AssertionError(f"f32 prefills must take the CUDA-core flash "
                             f"kernel alone: {counts}")
    emit({"phase": "reference", "arch": cfg.name, "layers": cfg.n_layers,
          "requests": len(prompts), "tokens_identical": same,
          "kernel_launches": counts})
    return counts["flash_attention"]


def _bound(nbytes, ops, ops_per_s, exps=0):
    """The least ms the card could take, and what sets it: the bytes over
    the memory rate, the operations over their type's peak, or ``exps``
    exponentials over the special-function units' rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / ops_per_s,
             "exponentials": exps / EX2_PER_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


# the mxu_probe cases (m, k, n, chain, block): the JAX kernel tests' sweep,
# the mxu_shapes grid's shapes, and chains that keep A resident (bf16
# K=256, bn=64) or stream it through the k-slab ring (bf16 K=256 at
# bn=128, every f32 K=256 chain); block None: the dependent harness's
# panel for a chain, the default (128, 128) at chain 1
MXU_CASES = [(128, 128, 128, 1, None), (128, 128, 128, 4, None),
             (256, 256, 128, 1, None), (256, 256, 256, 1, None),
             (256, 256, 256, 8, None), (512, 128, 512, 1, None),
             (256, 256, 256, 8, (256, 64)), (256, 256, 256, 3, (256, 64))]
# the calibration's independent launches at their widest (the longest L of
# run_mxu_cell, 8, and of mxu_peak_tflops, 4): a [m, k] against L * reps
# products' b side by side, [k, L * reps * n], at the default block, with
# reps one full wave of the card's blocks (core/microbench/mxu.py)
MXU_PEAK_CELL = ((512, 512, 512), 4)


def mxu_wide_cells(dt):
    """(shape (m, n, k), L) of each independent launch the calibration
    makes in ``dt`` at its widest: the mxu_shapes grid, and in f32 the
    roofline's mxu_peak_tflops."""
    from repro_torch.core.campaign import registry
    cells = [(tuple(s), 8) for s in registry.get("mxu_shapes").grid["shape"]]
    return cells + ([MXU_PEAK_CELL] if str(dt) == "torch.float32" else [])


# the mxu gate's fault controls, each the plain version with one fault, at
# the case the redesign risks: step s reads the panel of step s - 2 (the
# double buffer's race), the k-loop ends one 16-wide slab early, and
# chain 1 reads the A rows of the next row block (block (128, 128))
MXU_MUST_CATCH = {"stale_panel": (256, 256, 256, 8),
                  "last_kslab_dropped": (256, 256, 256, 1),
                  "neighbour_rows": (256, 256, 256, 1)}


def mxu_inputs(np, m, k, n, seed):
    """The probe's seeded inputs, a [m,k] and b [k,n], normal x 0.1 (f32
    numpy)."""
    rng = np.random.default_rng(seed + m + 3 * k + 7 * n)
    return ((rng.normal(size=(m, k)) * 0.1).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.1).astype(np.float32))


def _rel_err(got, want):
    """max |got - want| over max |want|: the mxu gate's measure."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def mxu_fault(torch, ref, name, a, b, chain):
    """The plain version with fault ``name`` (``MXU_MUST_CATCH``)."""
    if name == "stale_panel":
        panels = [b]                    # the input, then each step's output
        for s in range(chain):
            panels.append(ref.mxu_probe_plain(
                a, panels[-1] if s == 0 else panels[-2]))
        return panels[-1]
    if name == "last_kslab_dropped":
        return ref.mxu_probe_plain(a[:, :-16].contiguous(),
                                   b[:-16].contiguous(), chain=chain)
    return ref.mxu_probe_plain(torch.roll(a, -128, dims=0), b, chain=chain)


def mxu_controls(torch, np, ref, dt, dev, seed):
    """Each ``MXU_MUST_CATCH`` fault against the sound plain version on
    its case's inputs in ``dt``: its error over ``REL_TOL`` (the gate
    catches it above 1) and the share of outputs not bit-equal."""
    from repro_torch.kernels.mxu_probe import REL_TOL
    out = {}
    for name, (m, k, n, chain) in MXU_MUST_CATCH.items():
        an, bn = mxu_inputs(np, m, k, n, seed)
        a = torch.from_numpy(an).to(dt).to(dev)
        b = torch.from_numpy(bn).to(dt).to(dev)
        want = ref.mxu_probe_plain(a, b, chain=chain)
        got = mxu_fault(torch, ref, name, a, b, chain)
        ratio = _rel_err(got, want) / REL_TOL
        out[name] = {"tol_ratio": ratio,
                     "mismatch": (got != want).float().mean().item(),
                     "caught": ratio > 1}
    return out


def mxu_sass():
    """The SASS opcode mix of each built mxu_probe kernel instance, or why
    there is none."""
    from repro_torch.kernels import _build
    try:
        return _build.sass_mix("mxu_probe", top=24)
    except (RuntimeError, OSError) as e:
        return {"unavailable": str(e)[:200]}


# the alu_chain gates and their fault controls.  Each control must be
# caught by the gate named beside it:
# * host_side_cbuf (one_kernel, launch_cost): the wrapper's old staging of
#   c, {c, c, 0} built on the card by a fill and a stack (and, for a
#   number, a host-to-device copy) before the launch;
# * const_c (folded): c a compile-time constant in a chain without its
#   guards (no `asm volatile` on y, no side words), where the compiler
#   folds idempotent chains (max, and) to one op;
# * dropped_tail (folded): an independent tail that does not read y, so
#   every term is dead;
# * serial_tail (serial): the independent tail through one accumulator,
#   which serialises the chain on the tail's latency.
ALU_MUST_CATCH = {"host_side_cbuf": ("one_kernel", "launch_cost"),
                  "const_c": ("folded",), "dropped_tail": ("folded",),
                  "serial_tail": ("serial",)}
ALU_FAULTS = {
    "const_c": [
        ("  const T c0 = Ops<T>::of_bits(cb0), c1 = Ops<T>::of_bits(cb1);",
         "  const T c0 = Ops<T>::of_bits(sizeof(T) == 2 ? 0x3F80u\n"
         "      : Ops<T>::kInt ? 1u : 0x3F802000u), c1 = c0;"),
        ("    keep(y);\n    side[j % kSide] = side_op<T>(side[j % kSide], "
         "Ops<T>::bits(y), m);\n", "")],
    "dropped_tail": [("    acc[i % kAcc] = Ops<T>::template tail<OP>("
                      "acc[i % kAcc], y, z);", "    (void)y;")],
    "serial_tail": [("constexpr int kAcc = 8;", "constexpr int kAcc = 1;")],
}
# the cells the serial gate holds: the independent reading at most
# ALU_SERIAL_FACTOR x the timed body's SASS instructions per op
ALU_SERIAL_CELLS = tuple((op, dt, False) for op, dt in (
    ("add", "float32"), ("mul", "float32"), ("fma", "float32"),
    ("add", "int32"), ("mul", "int32")))
ALU_SERIAL_FACTOR = 1.25
# the cells each built control runs
ALU_FAULT_CELLS = {
    "const_c": (("max", "float32", True), ("and", "int32", True),
                ("max", "int32", True)),
    "dropped_tail": (("add", "float32", False), ("add", "int32", False)),
    "serial_tail": ALU_SERIAL_CELLS,
}
# the launch-cost gate: one length-1 call at most this many times one
# PyTorch elementwise launch on 1,024 elements, timed the same way
ALU_LAUNCH_FACTOR = 1.5
# the ops each control build holds (the kernel's instance lists cut short)
ALU_CONTROL_OPS = {"FLOAT_OPS": "X(ADD) X(MUL) X(FMA) X(MAX)",
                   "INT_OPS": "X(ADD) X(MUL) X(AND) X(MAX)"}


def alu_source(subs, ops=None):
    """``csrc/alu_chain.cu`` with ``subs`` (text, replacement) applied, each
    checked to apply once, and its instance lists cut to ``ops``."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "alu_chain.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"alu_chain.cu: anchor not found once: {old!r}")
        src = src.replace(old, new)
    for macro, body in (ops or {}).items():
        src, n = re.subn(rf"#define {macro}\(X\)(?:[^\n]*\\\n)*[^\n]*\n",
                         f"#define {macro}(X) {body}\n", src)
        if n != 1:
            raise RuntimeError(f"alu_chain.cu: no #define {macro}")
    return src


def alu_control_sources():
    """name -> source of every built control, to build beside the kernels."""
    return {f"alu_chain_{name}": alu_source(subs, ALU_CONTROL_OPS)
            for name, subs in ALU_FAULTS.items()}


def alu_bind(lib_path):
    """A built alu_chain library's launch function, bound as the wrapper
    binds its own."""
    import ctypes
    fn = ctypes.CDLL(str(lib_path)).alu_chain_launch
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [I, I, I, P, P, U, U, U, P, I, P, P]
    fn.restype = I
    return fn


def alu_readings(torch, dev, cells, fn=None):
    """(op, dtype, dependent) -> the harness's cycles per op (the in-kernel
    cycles' slope over lengths 4, 16, 64, 256), through the built library
    ``fn`` (the kernel's own where None)."""
    from repro_torch.core.microbench import harness
    from repro_torch.kernels import alu_chain as talu
    saved, talu._fn = talu._fn, fn or talu._fn
    try:
        return {(op, dt, dep): harness.run_chain(
                    harness.OPS[op], op, getattr(torch, dt),
                    dependent=dep, device=dev).cycles_per_op
                for op, dt, dep in cells}
    finally:
        talu._fn = saved


def alu_folded(readings):
    """Cells under one cycle per op: one warp issues at most one
    instruction a cycle, so such a chain lost ops."""
    return sorted(f"{op}.{dt}.{'dep' if dep else 'ind'}"
                  for (op, dt, dep), cyc in readings.items() if cyc < 1.0)


def alu_serial(readings, body):
    """Independent cells that read more than ``ALU_SERIAL_FACTOR`` x their
    timed body's SASS instructions per op (``alu_chain.timed_body``): ops
    that wait on each other."""
    out = []
    for (op, dt, dep), cyc in readings.items():
        per_op = body[(op, dt, dep)]["per_op"]
        if dep:
            continue
        if per_op is None:
            raise AssertionError(f"{op}.{dt}: no 255-op body in the SASS")
        if cyc > ALU_SERIAL_FACTOR * per_op:
            out.append(f"{op}.{dt}")
    return sorted(out)


def alu_device_work(torch, call):
    """The device kernels and copies of one ``call()``, by torch.profiler.
    A session that records no device event at all is taken again, up to
    three times: the first session of a process once came back empty on
    the card, and a call that truly launches nothing reads empty every
    time."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    kernels, copies = [], []
    for name in events:
        (copies if name.startswith(("Memcpy", "Memset"))
         else kernels).append(name)
    return kernels, copies


def alu_host_side_cbuf(torch, x, c, **kw):
    """The host_side_cbuf fault: the call with the wrapper's old staging
    of c ({c, c, 0} stacked on the card) ahead of the launch."""
    from repro_torch.kernels.alu_chain import alu_chain
    cv = torch.as_tensor(c, dtype=x.dtype).reshape(()).to(x.device)
    cbuf = torch.stack([cv, cv, torch.zeros_like(cv)])
    return alu_chain(x, cbuf[0], **kw)


def paired_ms(torch, fns, reps=100):
    """The median ms of one call of each of ``fns`` between a CUDA event
    pair, as ``gpu_ms`` times it, the calls taken in turns so that the
    host's drift falls on each alike."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def alu_call_gates(torch, x, c_forms, wrappers):
    """The one_kernel and launch_cost gates of each wrapper (the kernel's,
    then each control's) on each form of c: its device kernels and copies
    for one call, and the event-timed ms of a length-1 call against one
    ``torch.add`` on 1,024 elements timed the same way, in turns."""
    t = torch.ones(1024, device=x.device)
    out = {}
    for name, call in wrappers.items():
        res = {}
        for form, c in c_forms.items():
            kernels, copies = alu_device_work(
                torch, lambda: call(x, c, op="add", length=256))
            ms = paired_ms(torch, {
                "call": lambda: call(x, c, op="add", length=1),
                "torch_add": lambda: torch.add(t, 1.0)})
            res[form] = {"kernels": kernels, "copies": copies, "ms":
                         ms["call"], "torch_add_ms": ms["torch_add"],
                         "ratio": ms["call"] / ms["torch_add"]}
        out[name] = {"forms": res, "failed": sorted(
            ({"one_kernel"} if any(len(r["kernels"]) != 1 or r["copies"]
                                   for r in res.values()) else set())
            | ({"launch_cost"} if any(r["ratio"] > ALU_LAUNCH_FACTOR
                                      for r in res.values()) else set()))}
    return out


def probe_alu(torch, np, dev, rng):
    """alu_chain on the card: every (op, dtype, mode) against the plain
    version at lengths 12 and 256, the gates and their controls
    (``ALU_MUST_CATCH``), and the kernels line's cases with their SASS."""
    from repro_torch.core.microbench import harness
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import alu_chain as talu

    c = 1.0009765625
    worst, n_alu = 0.0, 0
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        if dt == torch.int32:
            x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (8, 128))
                                 .astype(np.int32)).to(dev)
        else:
            x = torch.from_numpy((rng.normal(size=(8, 128)) + 2.0)
                                 .astype(np.float32)).to(dt).to(dev)
        cv = torch.tensor(c).to(dt).to(dev)
        for op in ref.ALU_OPS:
            if not ref.alu_legal(op, dt):
                continue
            for dep in (True, False):
                for length in (12, 256):
                    out = ops.alu_chain(x, cv, op=op, length=length,
                                        dependent=dep)
                    torch.cuda.synchronize()
                    want = ref.alu_chain_plain(x, cv, op=op, length=length,
                                               dependent=dep)
                    torch.testing.assert_close(
                        out.double(), want.double(), equal_nan=True,
                        **talu.tolerance(op, dt, length))
                    worst = max(worst, (out.double() - want.double())
                                .abs().nan_to_num().max().item())
                    n_alu += 1
    # the SASS of each instance's 256-op body
    body = talu.timed_body(_build.sass(_build.build("alu_chain")))
    controls = {name: _build.build(name, src)
                for name, src in alu_control_sources().items()}
    # one call, one kernel, at a launch's cost
    x = torch.linspace(0.5, 1.5, 1024, device=dev).reshape(8, 128)
    cv = torch.tensor(c, device=dev)
    calls = alu_call_gates(
        torch, x, {"number": c, "cuda_tensor": cv,
                   "cpu_tensor": torch.tensor(c)},
        {"kernel": talu.alu_chain,
         "host_side_cbuf": lambda *a, **kw: alu_host_side_cbuf(torch, *a,
                                                               **kw)})
    if calls["kernel"]["failed"]:
        raise AssertionError(f"alu_chain call gates failed "
                             f"{calls['kernel']['failed']}: {calls}")
    # no folded chain, no serial independent chain
    cells = ALU_SERIAL_CELLS + ALU_FAULT_CELLS["const_c"]
    readings = alu_readings(torch, dev, cells)
    folded, serial = alu_folded(readings), alu_serial(readings, body)
    if folded or serial:
        raise AssertionError(f"alu_chain readings folded {folded}, serial "
                             f"{serial}: {readings}")
    caught = {"host_side_cbuf": calls["host_side_cbuf"]["failed"]}
    control_readings = {}
    for name, cells in ALU_FAULT_CELLS.items():
        lib = controls[f"alu_chain_{name}"]
        r = alu_readings(torch, dev, cells, alu_bind(lib))
        cbody = talu.timed_body(_build.sass(lib))
        control_readings[name] = {f"{op}.{dt}.{int(dep)}": v
                                  for (op, dt, dep), v in r.items()}
        caught[name] = ((["folded"] if alu_folded(r) else [])
                        + (["serial"] if "serial" in ALU_MUST_CATCH[name]
                           and alu_serial(r, cbody) else []))
    missed = [n for n, gates in ALU_MUST_CATCH.items()
              if not set(gates) <= set(caught[n])]
    if missed:
        raise AssertionError(f"the alu_chain gates miss {missed}: {caught}, "
                             f"{control_readings}")
    # the kernels line's case (dependent fma) and an independent add, at
    # the sweep's longest length; the bound is the chain's own latency
    cases = {}
    for key, (op, dep) in (("dependent", ("fma", True)),
                           ("independent", ("add", False))):
        kw = dict(op=op, length=256, dependent=dep)
        r = harness.run_chain(harness.OPS[op], op, torch.float32,
                              dependent=dep, device=dev)
        rows = torch.zeros((20, 2), dtype=torch.int64, device=dev)
        for row in rows.unbind(0):
            ops.alu_chain(x, cv, timing=row, **kw)
        torch.cuda.synchronize()
        chain_ns = statistics.median(rows[:, 1].tolist())
        cases[key] = {
            "case": f"{op} f32 {'dependent' if dep else 'independent'}, "
                    "length 256, (8,128)",
            "ms": gpu_ms(torch, lambda: ops.alu_chain(x, cv, **kw), 30),
            "stream_ms": stream_ms(torch, lambda: ops.alu_chain(x, cv, **kw)),
            "plain_ms": gpu_ms(torch, lambda: ref.alu_chain_plain(x, cv, **kw),
                               5),
            "chain_ms": chain_ns * 1e-6,
            "cycles_per_op": r.cycles_per_op, "clock_mhz": r.clock_hz / 1e6,
            "sass_per_op": body[(op, "float32", dep)]["per_op"],
            "bound_ms": 1e3 * 256 * r.cycles_per_op / r.clock_hz,
            "bound_by": "latency" if dep else "issue",
            "library_ms": None, "library_stream_ms": None}
    calls = {k: {"failed": v["failed"], "forms": {
        f: {"ms": r["ms"], "torch_add_ms": r["torch_add_ms"],
            "ratio": r["ratio"], "kernels": len(r["kernels"]),
            "copies": len(r["copies"])} for f, r in v["forms"].items()}}
        for k, v in calls.items()}
    alu = dict(cases["dependent"], independent=cases["independent"],
               cases=n_alu, lengths=[12, 256], max_abs_err=worst,
               calls=calls,
               readings={f"{op}.{dt}.{'dep' if dep else 'ind'}": {
                   "cycles_per_op": v,
                   "sass_per_op": body[(op, dt, dep)]["per_op"]}
                   for (op, dt, dep), v in readings.items()},
               controls={"caught": caught, "readings": control_readings})
    OUT.mkdir(exist_ok=True)
    (OUT / "alu_chain_sass.json").write_text(json.dumps(
        {f"{op}.{dt}.{'dep' if dep else 'ind'}": b
         for (op, dt, dep), b in sorted(body.items())}, indent=1))
    return alu, worst


def phase_probes(torch, np, dev, seed):
    """Each probe kernel against its plain version on the card; one timed
    case per kernel for the kernels line."""
    from repro_torch.core.microbench.memory import _random_cycle
    from repro_torch.core.microbench.mxu import card_reps, dependent_block
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mxu_probe import REL_TOL

    rng = np.random.default_rng(seed)
    worst = {"alu_chain": 0.0, "pointer_chase": 0.0, "mxu_probe": 0.0}
    alu, worst["alu_chain"] = probe_alu(torch, np, dev, rng)
    emit({"phase": "probes", "name": "alu_chain", **alu})

    chase = None
    n_chase = 0
    for n in (64, 4096, 1 << 20):
        nxt = torch.from_numpy(_random_cycle(n, seed + n)).to(dev)
        hops = min(4 * n, 4096)
        want = int(ref.pointer_chase_plain(nxt, 1, hops))
        for space, cop in (("shared", "ca"), ("global", "ca"),
                           ("global", "cg"), ("global", "cv")):
            if space == "shared" and n > 50000:
                continue                    # 4 MiB does not fit 227 KB
            got = int(ops.pointer_chase(nxt, 1, hops=hops, space=space,
                                        cache_op=cop))
            if got != want:
                raise AssertionError(f"pointer_chase {space}/{cop} n={n}: "
                                     f"{got} != {want}")
            n_chase += 1
        if n == 1 << 20:
            kw = dict(hops=4096, space="global", cache_op="ca")
            chase = {"case": "global .ca, 2^20 entries (4 MiB), 4096 hops",
                     "ms": gpu_ms(torch, lambda: ops.pointer_chase(
                         nxt, 1, **kw), 20),
                     "stream_ms": stream_ms(torch, lambda: ops.pointer_chase(
                         nxt, 1, **kw)),
                     "plain_ms": gpu_ms(torch, lambda: ref.pointer_chase_plain(
                         nxt, 1, 4096), 3),
                     "library_ms": None, "library_stream_ms": None}
            chase["bound_ms"], chase["bound_by"] = _bound(4096 * 4 + 4, 0,
                                                          F32_OPS_PER_S)
    # the paper's Fig. 2: cycles per hop in each space and under each
    # cache operator, on a warmed 16 KiB cycle (L1-, L2- and smem-sized)
    from repro_torch.core.microbench.harness import steady_slope, time_kernel
    nxt = torch.from_numpy(_random_cycle(4096, seed)).to(dev)
    fig2 = {}
    for space, cop in (("shared", "ca"), ("global", "ca"), ("global", "cg"),
                       ("global", "cv")):
        hops = (256, 1024, 4096)
        cyc = [float(np.median(time_kernel(lambda t, h=h: ops.pointer_chase(
            nxt, 0, hops=h, space=space, cache_op=cop, timing=t), 10,
            device=dev)[1])) for h in hops]
        fig2[space if space == "shared" else f"global.{cop}"] = \
            steady_slope(hops, cyc)
    emit({"phase": "probes", "name": "pointer_chase", "cases": n_chase,
          "max_abs_err": 0.0, "cycles_per_hop_16KiB": fig2, **chase})
    worst["pointer_chase"] = 0.0

    worst_rel, mismatch, controls, wide = 0.0, {}, {}, {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        diff = total = 0
        for m, k, n, chain, block in MXU_CASES:
            an, bn = mxu_inputs(np, m, k, n, seed)
            a = torch.from_numpy(an).to(dt).to(dev)
            b = torch.from_numpy(bn).to(dt).to(dev)
            if block is None and chain > 1:
                block = dependent_block(m, n, k, dt, chain)
            out = ops.mxu_probe(a, b, chain=chain, block=block)
            torch.cuda.synchronize()
            want = ref.mxu_probe_plain(a, b, chain=chain)
            rel = _rel_err(out, want)
            if not rel <= REL_TOL:
                raise AssertionError(f"mxu_probe {dt} {(m, k, n, chain)} "
                                     f"block {block}: error {rel} of max > "
                                     f"{REL_TOL}")
            worst["mxu_probe"] = max(worst["mxu_probe"], (
                out.float() - want.float()).abs().max().item())
            worst_rel = max(worst_rel, rel)
            diff += (out != want).sum().item()
            total += out.numel()
        mismatch[name] = diff / total
        gen = torch.Generator(device=dev).manual_seed(seed)
        for (m, n, k), L in mxu_wide_cells(dt):
            block = ops.resolve_mxu_block(m, n)
            reps = card_reps(m, n, k, dt, block, dev)
            a = (torch.randn((m, k), device=dev, generator=gen) * 0.1).to(dt)
            b = (torch.randn((k, L * reps * n), device=dev, generator=gen)
                 * 0.1).to(dt)
            out = ops.mxu_probe(a, b, chain=1, block=block)
            torch.cuda.synchronize()
            want = ref.mxu_probe_plain(a, b)
            rel = _rel_err(out, want)
            if not rel <= REL_TOL:
                raise AssertionError(f"mxu_probe {dt} independent {(m, n, k)} "
                                     f"at L={L}, reps {reps}: b {tuple(b.shape)}"
                                     f", error {rel} of max > {REL_TOL}")
            worst["mxu_probe"] = max(worst["mxu_probe"], (
                out.float() - want.float()).abs().max().item())
            worst_rel = max(worst_rel, rel)
            wide[f"{name} {m}x{n}x{k}"] = {
                "L": L, "reps": reps, "b": list(b.shape), "err_of_max": rel,
                "mismatch": (out != want).float().mean().item()}
            del a, b, out, want
        controls[name] = mxu_controls(torch, np, ref, dt, dev, seed)
    missed = [f"{d}:{c}" for d, cs in controls.items()
              for c, r in cs.items() if not r["caught"]]
    if missed:
        raise AssertionError(f"the mxu_probe gate misses {missed}: "
                             f"{controls}")
    a = torch.randn((256, 256), device=dev).bfloat16()
    b = torch.randn((256, 256), device=dev).bfloat16()
    mxu = {"case": "bf16 256x256x256, chain 1, block (128,128)",
           "ms": gpu_ms(torch, lambda: ops.mxu_probe(a, b, chain=1), 30),
           "stream_ms": stream_ms(torch, lambda: ops.mxu_probe(a, b,
                                                               chain=1)),
           "plain_ms": gpu_ms(torch, lambda: ref.mxu_probe_plain(a, b), 30),
           "library_ms": gpu_ms(torch, lambda: torch.matmul(a, b), 30),
           "library_stream_ms": stream_ms(torch,
                                          lambda: torch.matmul(a, b))}
    mxu["bound_ms"], mxu["bound_by"] = _bound(3 * 256 * 256 * 2,
                                              2 * 256 ** 3, BF16_OPS_PER_S)
    emit({"phase": "probes", "name": "mxu_probe",
          "cases": 2 * len(MXU_CASES) + len(wide),
          "max_abs_err": worst["mxu_probe"],
          "max_err_of_max": worst_rel, "rel_tol": REL_TOL,
          "mismatch": mismatch, "independent": wide, "controls": controls,
          "sass": mxu_sass(),
          **mxu})
    return {"alu_chain": alu, "pointer_chase": chase, "mxu_probe": mxu}, worst


# the cells the reference fails too: a [512,512] product cannot feed
# A [512,128] @ . in a dependent chain
REFERENCE_ERRORS = {f"dependent=true,dtype={d},shape=512x512x128"
                    for d in ("bfloat16", "float32", "int8")}


def mxu_rate_faults(docs):
    """Tensor-core readings no card can give: an ok ``mxu_shapes`` cell or
    ``roofline.mxu_peak_tflops`` not above 0 or above its type's dense peak
    (989 TFLOP/s bf16 and int8-as-bf16, 495 tf32), or a per-op time at
    the harness's floor (``PER_OP_FLOOR_S``, 1e-6 us)."""
    from repro_torch.core.microbench.mxu import (DENSE_PEAK_TFLOPS,
                                                 PER_OP_FLOOR_S)
    floor_us = PER_OP_FLOOR_S * 1e6
    off = []
    for key, rec in docs["mxu_shapes"]["cells"].items():
        if rec.get("status") != "ok":
            continue
        m = rec["metrics"]
        peak = DENSE_PEAK_TFLOPS[rec["params"]["dtype"]]
        if not 0 < m["tflops"] <= peak or m["per_op_us"] <= floor_us * 1.001:
            off.append(f"mxu_shapes:{key} ({m['tflops']} TFLOP/s, "
                       f"{m['per_op_us']} us)")
    for rec in docs["roofline_calibration"]["cells"].values():
        if rec["params"]["term"] == "mxu_peak_tflops" and not (
                0 < rec["metrics"]["value"] <= DENSE_PEAK_TFLOPS["float32"]):
            off.append(f"roofline.mxu_peak_tflops "
                       f"({rec['metrics']['value']} TFLOP/s)")
    return off


def phase_calibration(torch, dev, card):
    """The port's campaign: the four calibration experiments' full grids
    through the probe kernels, and the table they make."""
    import shutil

    from repro_torch.core.campaign.results import load_results_dir
    from repro_torch.core.microbench import harness, tables

    results = OUT / "campaign"
    shutil.rmtree(results, ignore_errors=True)
    t = torch.ones(1024, device=dev)
    add_us = [harness.time_fn(torch.add, t, 1.0, iters=100, device=dev)
              * 1e6]
    reset_launches()
    t0 = time.perf_counter()
    table = tables.calibrate(quick=False, results_dir=results, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    add_us.append(harness.time_fn(torch.add, t, 1.0, iters=100, device=dev)
                  * 1e6)
    docs = load_results_dir(results, tables.CALIBRATION_EXPERIMENTS)
    errors = sorted(f"{name}:{key}" for name, doc in docs.items()
                    for key, rec in doc["cells"].items()
                    if rec.get("status") != "ok")
    expected = sorted(f"mxu_shapes:{k}" for k in REFERENCE_ERRORS)
    if errors != expected:
        bad = [e for e in errors if e not in expected]
        raise AssertionError(f"calibration cells in error: {bad or errors}; "
                             f"expected exactly {expected}")
    alu = {(r["params"]["op"], r["params"]["dtype"], r["params"]["dependent"]):
           r["metrics"] for r in docs["alu_chain"]["cells"].values()}
    folded = alu_folded({k: m["per_op_cycles"] for k, m in alu.items()})
    if folded:
        raise AssertionError(f"ALU cells under 1 cycle per op (a folded "
                             f"chain): {folded}")
    chase = {r["params"]["size_kib"]: r["metrics"]
             for r in docs["memory_chase"]["cells"].values()
             if r["params"]["access"] == "chase"}
    if not chase[65536]["per_hop_ns"] > chase[16]["per_hop_ns"]:
        raise AssertionError("the 64 MiB chase is not slower per hop than "
                             "the 16 KiB chase")
    for name in ("alu_chain", "pointer_chase", "mxu_probe"):
        if counts[name] == 0:
            raise AssertionError(f"the calibration never launched {name}")
    off = mxu_rate_faults(docs)
    if off:
        raise AssertionError(f"tensor-core cells no card can give: {off}")
    cycles = {f"{op}.{dt}": {"dependent": alu[(op, dt, True)]["per_op_cycles"],
                             "independent": alu[(op, dt, False)][
                                 "per_op_cycles"]}
              for op, dt in (("add", "float32"), ("mul", "float32"),
                             ("fma", "float32"), ("add", "int32"),
                             ("mul", "int32"), ("rsqrt", "float32"),
                             ("exp", "float32"), ("sin", "float32"),
                             ("tanh", "float32"), ("add", "bfloat16"),
                             ("fma", "bfloat16"))}
    hops = {f"{kib}KiB": {"per_hop_ns": m["per_hop_ns"],
                          "per_hop_cycles": m["per_hop_cycles"]}
            for kib, m in sorted(chase.items())}
    mxu = {key: {k: rec["metrics"].get(k) for k in
                 ("tflops", "per_op_us", "per_op_cycles", "block", "reps")}
           for key, rec in sorted(docs["mxu_shapes"]["cells"].items())
           if rec["status"] == "ok"}
    table["source"] = (f"measured on one {card} by `python3 chip_smoke.py` "
                       "(phase calibration: the full grids of alu_chain, "
                       "memory_chase, mxu_shapes and roofline_calibration "
                       "through the port's probe kernels)")
    # what one PyTorch elementwise launch costs, timed as the harness times
    # a probe call, just before and just after the grids
    table["launch_reference"] = {
        "torch_add_us": statistics.median(add_us), "runs_us": add_us,
        "detail": "one torch.add on 1,024 f32 elements between CUDA events, "
                  "median of 100, before and after the grids"}
    overhead_us = sorted(r["overhead_ns"] / 1e3 for r in table["ops"].values())
    (OUT / "hopper_h100.json").write_text(json.dumps(table, indent=1))
    emit({"phase": "calibration", "run_s": run_s, "launches": counts,
          "cells": {n: len(d["cells"]) for n, d in docs.items()},
          "seconds": {n: sum(r["elapsed_s"] for r in d["cells"].values())
                      for n, d in docs.items()},
          "errors": errors, "clock_mhz": table["clock_mhz"],
          "launch_reference": table["launch_reference"],
          "overhead_us": {"min": overhead_us[0], "max": overhead_us[-1],
                          "median": statistics.median(overhead_us)},
          "alu_cycles": cycles, "chase": hops, "mxu": mxu,
          "roofline": {k: v["value"] for k, v in table["roofline"].items()}})
    return counts


# the cost model phase: each table's round trip within COST_MAX_ERR_PCT, and
# admission gated on both engines; the faults the gates must catch: an
# engine that ignores its budget, every prefill and chunk priced at 0 (both
# caught by the deferral gate of a tight budget) and a model whose hardware
# resolves to another spec than the H100's (caught by the table gate)
COST_MAX_ERR_PCT = 10.0
COST_MUST_CATCH = ("budget_ignored", "prefill_free", "hw_wrong")


def cost_table_gate(model):
    """One table's model: its round trip (each recorded row priced back
    through the layers) within ``COST_MAX_ERR_PCT``, and its hardware the
    H100 spec.  Returns (summary, failures)."""
    from repro_torch.core.costmodel import (prediction_error_rows,
                                            prediction_error_summary)
    from repro_torch.core.perfmodel.hardware import H100_SXM

    s = prediction_error_summary(prediction_error_rows(model))
    bad = []
    if not s["rows"] or s["max_err_pct"] > COST_MAX_ERR_PCT:
        bad.append(f"round trip: {s['rows']} rows, max error "
                   f"{s['max_err_pct']}%")
    if model.hw != H100_SXM:
        bad.append(f"hardware resolves to {model.hw.name}")
    return {**s, "hw": model.hw.name}, bad


def cost_predictions(model, cfg):
    """The priced steps of ``cfg``: the decode step at B=8 over 1,024
    positions (donated, sampled on the card), a 64-token chunk and a
    900-token prefill."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.costmodel.analytic import analytic_census

    cells = {"decode_b8_1024": (ShapeCell("decode", "decode", 1024, 8),
                                dict(donated=True, device_sampling=True)),
             "chunk_64": (ShapeCell("chunk", "prefill", 64, 1), {}),
             "prefill_900": (ShapeCell("prefill", "prefill", 900, 1), {})}
    return {name: model.predict(analytic_census(cfg, cell, n_devices=1,
                                                n_model=1, **kw)).table_row()
            for name, (cell, kw) in cells.items()}


def cost_budget(eng, prompts):
    """A budget the gate must bind at: the decode step and 1.5 chunks
    (paged), or 1.5 prefills of the median prompt (slot)."""
    decode_s = eng._predict_decode().step_s
    if hasattr(eng, "_predict_chunk"):
        return decode_s + 1.5 * eng._predict_chunk().step_s
    median = sorted(len(p) for p in prompts)[len(prompts) // 2]
    return decode_s + 1.5 * eng._predict_prefill(median).step_s


def cost_fault(name, eng):
    """Inject a fault of ``COST_MUST_CATCH`` into an engine: its budget
    ignored (admission ungated), or every prefill and chunk priced at 0."""
    import dataclasses

    if name == "budget_ignored":
        eng._step_budget = lambda: None
    elif name == "prefill_free":
        free = dataclasses.replace(eng._predict_decode(), step_s=0.0)
        eng._predict_chunk = lambda: free
        eng._predict_prefill = lambda n: free
    else:
        raise ValueError(name)


def cost_hw_wrong(cm):
    """The ``hw_wrong`` fault: ``cm``'s table naming the paper's A100, so
    its model resolves to the A100 spec."""
    import dataclasses

    from repro_torch.core.costmodel import CostModel
    return CostModel(dataclasses.replace(cm.cal, hardware="nvidia-a100-40g"))


def cost_serve(make, prompts, max_new, run, budget, fault=None):
    """Serve ``prompts`` through ``make(budget)`` with ``fault`` injected;
    ``run`` steps the engine to the end and returns what it counts.
    Returns the engine, its tokens and ``run``'s result."""
    eng = make(budget)
    if fault is not None:
        cost_fault(fault, eng)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    counted = run(eng)
    return eng, [eng.done[r].tokens for r in rids], counted


def cost_run_gates(eng, n_req, tight):
    """A gated run's gates: every request completes, one predicted and one
    measured time a counted step, at most one sync a step beyond the
    first, deferrals under a tight budget and none under 1e9 s."""
    st = eng.stats
    bad = []
    if st.completed != n_req:
        bad.append(f"completed {st.completed} of {n_req}")
    if not len(st.predicted_step_s) == len(st.measured_step_s) == st.steps:
        bad.append(f"{len(st.predicted_step_s)} predicted, "
                   f"{len(st.measured_step_s)} measured for {st.steps} steps")
    if st.host_syncs > st.steps + 1:
        bad.append(f"{st.host_syncs} syncs over {st.steps} steps")
    if tight and st.deferred_prefills == 0:
        bad.append("a tight budget deferred nothing")
    if not tight and st.deferred_prefills:
        bad.append(f"a 1e9 s budget deferred {st.deferred_prefills}")
    return bad


def cost_reference(torch, np, seed, cm):
    """Reduced f32 gemma2 under tight budgets on the card and on the CPU,
    through both engines: tokens, admission order and deferrals must be
    identical (pricing is host arithmetic over the same table), and the
    budget must defer."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine

    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 40, size=8)]
    engines = {"paged": (PagedServingEngine, dict(
        max_batch=4, max_len=64, block_size=8, n_blocks=12, chunk_size=8)),
        "slot": (ServingEngine, dict(max_batch=4, max_len=64))}
    cpu_params = build_model(cfg, device="cpu").init(seed)
    out = {}
    for kind, (cls, kw) in engines.items():
        seen = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, device=dev)
            params = params_to(cpu_params, dev)

            def make(b):
                return cls(model, params, cost_model=cm, step_budget_s=b,
                           **kw)
            eng, toks, _ = cost_serve(make, prompts, 8,
                                      lambda e: e.run_until_done(),
                                      cost_budget(make(None), prompts))
            seen[dev] = (toks, eng.stats.admission_order,
                         eng.stats.deferred_prefills)
        out[kind] = {"identical": seen["cuda"] == seen["cpu"],
                     "deferred_prefills": seen["cuda"][2]}
    return out


def _cost_reading(eng, budget, launches):
    st = eng.stats
    pred = statistics.median(st.predicted_step_s)
    meas = statistics.median(st.measured_step_s)
    return {"budget_s": budget, "steps": st.steps,
            "deferred_prefills": st.deferred_prefills,
            "host_syncs": st.host_syncs, "completed": st.completed,
            "decoded_tokens": st.decoded_tokens, "launches": launches,
            "median_predicted_step_ms": 1e3 * pred,
            "median_measured_step_ms": 1e3 * meas,
            "measured_over_predicted": meas / pred}


def phase_costmodel(torch, np, dev, seed, card):
    """The cost model priced from the H100 tables, and admission gated by
    it in both engines at full width, on the card and against the CPU."""
    from repro_torch.core.costmodel import CostModel
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine

    models = {"fresh": CostModel.from_named(OUT / "hopper_h100.json"),
              "committed": CostModel.from_named("hopper_h100")}
    tables, failures = {}, []
    for name, m in models.items():
        tables[name], bad = cost_table_gate(m)
        failures += [f"{name} table: {b}" for b in bad]
    cm = models["fresh"]
    controls = {"hw_wrong": {"table": bool(cost_table_gate(
        cost_hw_wrong(cm))[1])}}

    cfg, model, params, prompts = serve_setup(np, dev, seed)
    predictions = {name: cost_predictions(m, cfg)
                   for name, m in models.items()}
    engines = {
        "paged": (PagedServingEngine, dict(max_batch=8, max_len=1024,
                                           block_size=16, chunk_size=64),
                  "paged_attention", "decode_dispatches"),
        "slot": (ServingEngine, dict(max_batch=8, max_len=1024),
                 "flash_attention_mma", "prefills")}
    runs = {}
    for kind, (cls, kw, kernel, per) in engines.items():
        def make(b):
            return cls(model, params, cost_model=cm, step_budget_s=b, **kw)

        def run(eng):
            return drive(torch, eng)[2][kernel]
        tight = cost_budget(make(None), prompts)
        for label, budget in (("loose", 1e9), ("tight", tight)):
            eng, _, n = cost_serve(make, prompts, 32, run, budget)
            bad = cost_run_gates(eng, len(prompts), label == "tight")
            want = cfg.n_layers * getattr(eng.stats, per)
            if n != want:
                bad.append(f"{n} {kernel} launches != {want}")
            failures += [f"{kind} {label}: {x}" for x in bad]
            runs[f"{kind}_{label}"] = _cost_reading(eng, budget, n)
            del eng
        for fault in ("budget_ignored", "prefill_free"):
            eng, _, _ = cost_serve(make, prompts, 32, run, tight, fault)
            controls.setdefault(fault, {})[kind] = bool(
                cost_run_gates(eng, len(prompts), True))
            del eng
    del model, params
    torch.cuda.empty_cache()
    reference = cost_reference(torch, np, seed, cm)
    failures += [f"reference {k}: {r}" for k, r in reference.items()
                 if not (r["identical"] and r["deferred_prefills"])]
    missed = [f"{name} ({where})" for name in COST_MUST_CATCH
              for where, caught in controls[name].items() if not caught]
    emit({"phase": "costmodel", "nvidia_smi": card, "tables": tables,
          "predictions": predictions, "runs": runs, "controls": controls,
          "reference": reference})
    if failures or missed:
        raise AssertionError(f"cost model gates failed: {failures}; "
                             f"controls missed: {missed}")


# -- phase hotpath: the legacy blocking decode path at full width -----------
# Fault controls the hotpath gates must catch: the legacy step writing the
# store in place (the peak gate: no second store) and uploading the tokens
# of the step before (the token gate).
HOTPATH_MUST_CATCH = ("legacy_in_place", "stale_token")
HOTPATH_PEAK_SLACK = 0.05     # the second store may read 5% short of a store


def hotpath_probe(torch, model):
    """A copy of ``model`` whose ``decode`` records, for each decode step
    (one token a row), the device memory allocated when it returns: the
    weights, the store (and on the legacy path its copy, which replaces it
    only after the call) and the step's outputs.  The run's peak
    (``max_memory_allocated``) is set elsewhere (a prefill's logits, a
    compaction's copy), so this is the reading that shows the second
    store.  Returns the model and the list the readings go to."""
    import dataclasses

    from repro_torch.models.zoo import fused_decode_step

    marks = []

    def decode(params, cache, tokens, pos, block_tables=None, **kw):
        out = model.decode(params, cache, tokens, pos, block_tables, **kw)
        if tokens.shape[1] == 1:
            marks.append(torch.cuda.memory_allocated())
        return out
    return dataclasses.replace(model, decode=decode,
                               decode_step=fused_decode_step(decode)), marks


def hotpath_fault(name, eng):
    """Inject a fault of ``HOTPATH_MUST_CATCH`` into a legacy engine: its
    step decoding into the live store (no copy), or each step's ``[B, 1]``
    token upload replaced by the one of the step before."""
    import numpy as np

    if name == "legacy_in_place":
        eng._copy_store = lambda cache: cache
    elif name == "stale_token":
        upload, sent, batch = eng._dev, [], eng.max_batch

        def stale(x):
            x = np.asarray(x)
            if x.shape == (batch, 1):
                sent.append(np.array(x, copy=True))
                x = sent[-2] if len(sent) > 1 else x
            return upload(x)
        eng._dev = stale
    else:
        raise ValueError(name)


def hotpath_serve(make, prompts, max_new, run, fault=None):
    """Serve ``prompts`` through ``make()`` with ``fault`` injected; ``run``
    steps the engine to the end and returns what it reads.  Returns the
    engine, its tokens and ``run``'s result."""
    eng = make()
    if fault is not None:
        hotpath_fault(fault, eng)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    got = run(eng)
    return eng, [eng.done[r].tokens for r in rids], got


def hotpath_gates(legacy, fused, store_bytes=None):
    """The legacy run's gates against the fused run of the same trace, each
    a dict of ``tokens``, ``steps``, ``host_syncs`` and, on the card,
    ``step_bytes`` (``hotpath_probe``'s most): identical tokens; the legacy
    path reads the device more than once a step, the fused one at most
    once a step beyond the first; the legacy step's memory at least the
    fused step's plus one store (``store_bytes``) less
    ``HOTPATH_PEAK_SLACK``."""
    bad = []
    if legacy["tokens"] != fused["tokens"]:
        first = next(i for i, (a, b) in enumerate(zip(legacy["tokens"],
                                                        fused["tokens"]))
                     if a != b)
        bad.append(f"tokens differ from request {first}: "
                   f"{legacy['tokens'][first]} != {fused['tokens'][first]}")
    if not legacy["host_syncs"] > legacy["steps"]:
        bad.append(f"legacy: {legacy['host_syncs']} syncs over "
                   f"{legacy['steps']} steps")
    if fused["host_syncs"] > fused["steps"] + 1:
        bad.append(f"fused: {fused['host_syncs']} syncs over "
                   f"{fused['steps']} steps")
    if store_bytes is not None:
        want = fused["step_bytes"] + (1 - HOTPATH_PEAK_SLACK) * store_bytes
        if legacy["step_bytes"] < want:
            bad.append(f"legacy step {legacy['step_bytes']} B < fused step "
                       f"{fused['step_bytes']} B + one store {store_bytes} "
                       f"B less {HOTPATH_PEAK_SLACK:.0%}")
    return bad


def _hotpath_reading(torch, eng, toks, got):
    step_ms, run_s, counts, peak, marks = got
    st = eng.stats
    return {"tokens": toks, "distinct_tokens": len({t for r in toks for t in r}),
            "steps": st.steps, "host_syncs": st.host_syncs,
            "prefills": st.prefills, "prefill_chunks": st.prefill_chunks,
            "decode_dispatches": st.decode_dispatches,
            "decoded_tokens": st.decoded_tokens, "completed": st.completed,
            "launches": counts, "run_s": run_s,
            "decode_tok_per_s": st.decoded_tokens / run_s,
            "median_step_ms": statistics.median(step_ms),
            "syncs_per_step": st.host_syncs / st.steps,
            "step_bytes": max(marks), "step_gib": max(marks) / 2 ** 30,
            "peak_bytes": peak, "peak_mem_gib": peak / 2 ** 30}


def hotpath_reduced(torch, np, seed, card_dev="cuda"):
    """Reduced f32 gemma2 (2 layers, vocab 128) on the card and on the CPU
    through both engines on the CPU tests' acceptance trace shape (32
    prompts of 1-30 tokens, 4 new tokens): the card's legacy tokens must
    equal its fused tokens and the CPU's legacy tokens, and the
    ``stale_token`` control must break that parity.  Full-width gemma2's
    random weights give nearly one greedy token for every request, where
    a stale token changes nothing; this model's tokens vary."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine

    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 31, size=32)]
    cpu_params = build_model(cfg, device="cpu").init(seed)
    models = {"card": build_model(cfg, device=card_dev),
              "cpu": build_model(cfg, device="cpu")}
    params = {"card": params_to(cpu_params, card_dev),
              "cpu": cpu_params}
    engines = {"paged": (PagedServingEngine, dict(
        max_batch=4, max_len=48, block_size=8, n_blocks=10, chunk_size=8)),
        "slot": (ServingEngine, dict(max_batch=4, max_len=48))}

    def serve(kind, d, fused, fault=None):
        cls, kw = engines[kind]
        eng, toks, _ = hotpath_serve(
            lambda: cls(models[d], params[d], fused=fused, **kw), prompts, 4,
            lambda e: e.run_until_done(), fault)
        return {"tokens": toks, "steps": eng.stats.steps,
                "host_syncs": eng.stats.host_syncs}
    out, failures, caught = {}, [], {}
    for kind in engines:
        legacy, fused = serve(kind, "card", False), serve(kind, "card", True)
        cpu = serve(kind, "cpu", False)
        bad = hotpath_gates(legacy, fused) + [
            f"card {b}" for b in hotpath_gates(legacy, cpu)
            if b.startswith("tokens")]
        failures += [f"reduced {kind}: {b}" for b in bad]
        stale = serve(kind, "card", False, "stale_token")
        caught[kind] = [b for b in hotpath_gates(stale, cpu)
                        if b.startswith("tokens")][:1]
        out[kind] = {"steps": legacy["steps"],
                     "host_syncs": legacy["host_syncs"],
                     "distinct_tokens": len({t for r in legacy["tokens"]
                                             for t in r}),
                     "identical_to_fused": legacy["tokens"] == fused["tokens"],
                     "identical_to_cpu": legacy["tokens"] == cpu["tokens"]}
    return out, failures, caught


def phase_hotpath(torch, np, dev, seed, card, fused_tokens):
    """Phase serve's model and trace through both engines with
    ``fused=False``, beside a fused run of each in this phase; tokens
    against phases serve and serve_slot (``fused_tokens``); then the
    reduced f32 parity of ``hotpath_reduced``.  ``legacy_in_place`` is
    judged at full width, ``stale_token`` on the reduced model (at full
    width it is a reading)."""
    from repro_torch.serve.engine import PagedServingEngine, ServingEngine

    import gc

    cfg, model, params, prompts = serve_setup(np, dev, seed)
    model, marks = hotpath_probe(torch, model)
    engines = {
        "paged": (PagedServingEngine, dict(max_batch=8, max_len=1024,
                                           block_size=16, chunk_size=64),
                  "paged_attention", "decode_dispatches"),
        "slot": (ServingEngine, dict(max_batch=8, max_len=1024),
                 "flash_attention_mma", "prefills")}

    def run(eng):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks.clear()
        step_ms, run_s, counts = drive(torch, eng)
        return (step_ms, run_s, counts, torch.cuda.max_memory_allocated(),
                list(marks))

    runs, controls, failures = {}, {}, []
    for kind, (cls, kw, kernel, per) in engines.items():
        readings = {}
        for label, fused in (("fused", True), ("legacy", False)):
            def make():
                return cls(model, params, fused=fused, **kw)
            eng, toks, got = hotpath_serve(make, prompts, 32, run)
            r = readings[label] = _hotpath_reading(torch, eng, toks, got)
            store = eng.kv_cache_bytes()
            want = cfg.n_layers * r[per]
            if r["launches"][kernel] != want:
                failures.append(f"{kind} {label}: {r['launches'][kernel]} "
                                f"{kernel} launches != {want}")
            if r["completed"] != len(prompts):
                failures.append(f"{kind} {label}: completed "
                                f"{r['completed']} of {len(prompts)}")
            del eng
            torch.cuda.empty_cache()
        if readings["fused"]["tokens"] != fused_tokens[kind]:
            failures.append(f"{kind}: the fused rerun's tokens differ from "
                            "its serving phase's")
        failures += [f"{kind}: {b}" for b in hotpath_gates(
            readings["legacy"], {**readings["fused"],
                                 "tokens": fused_tokens[kind]}, store)]
        for fault in HOTPATH_MUST_CATCH:
            def make():
                return cls(model, params, fused=False, **kw)
            eng, toks, got = hotpath_serve(make, prompts, 32, run, fault)
            r = _hotpath_reading(torch, eng, toks, got)
            del eng
            torch.cuda.empty_cache()
            bad = hotpath_gates(r, {**readings["fused"],
                                    "tokens": fused_tokens[kind]}, store)
            where = kind if fault == "legacy_in_place" else f"{kind}_full"
            controls.setdefault(fault, {})[where] = {
                "caught": bool(bad), "by": [b[:300] for b in bad[:2]]}
        runs[kind] = {label: {k: v for k, v in r.items() if k != "tokens"}
                      for label, r in readings.items()}
        runs[kind]["store_gib"] = store / 2 ** 30
        runs[kind]["legacy_over_fused_tok_per_s"] = (
            readings["legacy"]["decode_tok_per_s"]
            / readings["fused"]["decode_tok_per_s"])
    del model, params
    gc.collect()                 # a stale_token engine is in a ref cycle
    torch.cuda.empty_cache()
    reduced_runs, bad, stale = hotpath_reduced(torch, np, seed)
    failures += bad
    for kind, by in stale.items():
        controls["stale_token"][kind] = {"caught": bool(by), "by": by}
    missed = [f"{name} ({kind})" for name in HOTPATH_MUST_CATCH
              for kind, c in controls[name].items()
              if not c["caught"] and not kind.endswith("_full")]
    emit({"phase": "hotpath", "nvidia_smi": card, "arch": cfg.name,
          "runs": runs, "reduced": reduced_runs, "controls": controls})
    if failures or missed:
        raise AssertionError(f"hotpath gates failed: {failures}; "
                             f"controls missed: {missed}")


# -- phase campaign: paged_serve, decode_hotpath and isa_mapping ------------
CAMPAIGN_EXPERIMENTS = ("paged_serve", "decode_hotpath", "isa_mapping")
# the ISA cases of one op an element, each of which must leave SASS beyond
# the copy baseline; those whose PTX op has a one-instruction counterpart,
# which that SASS must hold
ISA_SINGLE_OP = ("add.f32", "mul.f32", "fma.f32", "div.f32", "rsqrt.f32",
                 "exp.f32", "tanh.f32")
ISA_EXPECT = {"add.f32": "FADD", "mul.f32": "FMUL", "fma.f32": "FFMA",
              "rsqrt.f32": "MUFU.RSQ", "exp.f32": "MUFU.EX2",
              "matmul.f32": "FFMA"}
ISA_TOL = 1e-5                # of max|want|
ISA_ULP = {"exp.f32": 2, "tanh.f32": 2}     # expf, tanhf: 2 ulp (CUDA docs)
# Fault controls: a case whose result is never stored (the expansion gate),
# rsqrt.f32 computing sqrt (the value check; the MUFU.RSQ gate does not see
# it where sqrtf compiles around MUFU.RSQ) and a PTX parser that counts
# directives and labels as instructions (the scaffold gate).
ISA_MUST_CATCH = ("dead_store", "wrong_op", "scaffold_counted")
ISA_VARIANTS = {
    "dead_store": ("y[i] = x[i] + 1.0f;  // case add.f32",
                   "(void)(x[i] + 1.0f);  // case add.f32"),
    "wrong_op": ("rsqrtf(fabsf(x[i]) + 1e-3f)", "sqrtf(fabsf(x[i]) + 1e-3f)")}
ISA_FAULT_CASE = {"dead_store": "add.f32", "wrong_op": "rsqrt.f32"}


def isa_variant(name):
    """The case source with ``ISA_VARIANTS[name]`` substituted."""
    from repro_torch.core.isa import sass_census

    old, new = ISA_VARIANTS[name]
    text = sass_census.SOURCE.read_text()
    if text.count(old) != 1:
        raise AssertionError(f"{name}: {old!r} not found once in the source")
    return text.replace(old, new)


def isa_gates(cells):
    """Table V's gates over ``isa_mapping`` metrics (case -> metrics): both
    counts above 0; no counted opcode a directive or a label; each
    single-op case with SASS beyond the baseline, the one-instruction
    counterparts of ``ISA_EXPECT`` in it, ``scan8`` at least 8 FMUL there,
    ``gather`` an LDG."""
    bad = []
    for case, m in cells.items():
        if m["n_source_ops"] <= 0 or m["n_optimized_ops"] <= 0:
            bad.append(f"{case}: {m['n_source_ops']} PTX, "
                       f"{m['n_optimized_ops']} SASS instructions")
        scaffold = [op for hist in (m["ptx_ops"], m["sass_ops"])
                    for op in hist if op.startswith(".") or op.endswith(":")]
        if scaffold:
            bad.append(f"{case}: directives or labels counted {scaffold[:3]}")
        if case in ISA_SINGLE_OP and not m["sass_expansion"]:
            bad.append(f"{case}: no SASS beyond the copy baseline")
        if case in ISA_EXPECT and ISA_EXPECT[case] not in m["sass_expansion"]:
            bad.append(f"{case}: no {ISA_EXPECT[case]} beyond the baseline")
        if case == "scan8" and m["sass_expansion"].get("FMUL", 0) < 8:
            bad.append(f"scan8: {m['sass_expansion'].get('FMUL', 0)} FMUL")
        if case == "gather" and not any(op.startswith("LDG")
                                        for op in m["sass_ops"]):
            bad.append("gather: no LDG")
    return bad


def isa_plain(torch, case, x):
    """The plain PyTorch function of each case (the reference's jnp one)."""
    if case == "scan8":
        c = x
        for _ in range(8):
            c = c * 1.01
        return c
    return {"add.f32": lambda: x + 1.0, "mul.f32": lambda: x * 1.5,
            "fma.f32": lambda: x * 1.5 + 2.0, "div.f32": lambda: x / 1.5,
            "rsqrt.f32": lambda: torch.rsqrt(x.abs() + 1e-3),
            "exp.f32": lambda: torch.exp(x * 1e-3),
            "tanh.f32": lambda: torch.tanh(x),
            "softmax.f32": lambda: torch.softmax(x, dim=-1),
            "matmul.f32": lambda: x @ x.T,
            "reduce.f32": lambda: x.sum(-1),
            "gather": lambda: x[torch.arange(8, device=x.device) % 64]}[case]()


def isa_values(torch, lib_path, dev, seed, cases=None):
    """Launch each case kernel (through its ``launch_isa_*``) on a seeded
    64 x 64 input and hold it against its plain version: within ``ISA_TOL``
    of max|want|, or for ``ISA_ULP``'s cases within their ulp bound of the
    exact value (float64 of the f32 argument)."""
    import ctypes

    from repro_torch.core.isa import sass_census

    lib = ctypes.CDLL(str(lib_path))
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(64, 64, generator=g, device=dev)
    out = {}
    for case in cases or sass_census.CASES:
        want = isa_plain(torch, case, x)
        y = torch.zeros_like(want)
        fn = getattr(lib, f"launch_{sass_census.CASES[case]}")
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        rc = fn(x.data_ptr(), y.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        if rc != 0:
            out[case] = {"ok": False, "launch_error": rc}
            continue
        if case in ISA_ULP:
            arg = x * 1e-3 if case == "exp.f32" else x
            exact = (torch.exp if case == "exp.f32" else torch.tanh)(
                arg.double())
            w = exact.float().abs()
            ulp = (torch.nextafter(w, torch.full_like(w, math.inf)) - w)
            err = ((y.double() - exact).abs() / ulp.double()).max().item()
            out[case] = {"max_ulp": err, "ulp_bound": ISA_ULP[case],
                         "ok": err <= ISA_ULP[case]}
        else:
            err = (y - want).abs().max().item()
            tol = ISA_TOL * want.abs().max().item()
            out[case] = {"max_abs_err": err, "tol": tol, "ok": err <= tol}
    return out


def isa_scaffold_counted(ptx_text, sass_text, case):
    """The ``scaffold_counted`` fault: ``case``'s metrics through a PTX
    parser that takes every statement's first word, directives and labels
    included."""
    from repro_torch.core.isa import sass_census as sc

    sound = sc.ptx_statement_opcode

    def faulty(stmt):
        words = stmt.split()
        return words[0] if words else None
    sc.ptx_statement_opcode = faulty
    sc._table.cache_clear()
    try:
        return sc.case_metrics(case, ptx_text, sass_text)
    finally:
        sc.ptx_statement_opcode = sound
        sc._table.cache_clear()


def isa_controls(torch, dev, seed, texts):
    """Each ``ISA_MUST_CATCH`` fault, built and checked as the cases are:
    returns {name: {"caught", "by"}} and the variants' texts."""
    from repro_torch.core.isa import sass_census
    from repro_torch.kernels import _build

    controls, variant_texts = {}, {}
    for name in ("dead_store", "wrong_op"):
        src = isa_variant(name)
        ptx_text, sass_text = sass_census.build_texts(src, f"isa_{name}")
        variant_texts[name] = (ptx_text, sass_text)
        case = ISA_FAULT_CASE[name]
        bad = isa_gates({case: sass_census.case_metrics(case, ptx_text,
                                                        sass_text)})
        vals = isa_values(torch, _build.build(f"isa_{name}", src), dev,
                          seed, [case])
        bad += [f"value {case}: {v}" for v in vals.values() if not v["ok"]]
        controls[name] = {"caught": bool(bad), "by": bad[:3]}
    bad = isa_gates({"add.f32": isa_scaffold_counted(*texts, "add.f32")})
    controls["scaffold_counted"] = {"caught": bool(bad), "by": bad[:3]}
    return controls, variant_texts


def campaign_gates(docs, quick=False):
    """The campaign phase's gates over the three result documents: no
    failed cell; paged_serve leak-free, under the slot cache's bytes and
    every request completed on both engines; decode_hotpath with identical
    tokens and more syncs a step on the legacy path; Table V's gates."""
    bad = []
    for name, doc in docs.items():
        for key, rec in sorted(doc["cells"].items()):
            if rec.get("status", "ok") != "ok":
                bad.append(f"{name} {key}: {rec.get('error', '')[:300]}")

    def cells(name):
        return [(k, r["metrics"]) for k, r in sorted(docs[name]["cells"]
                                                      .items())
                if r.get("status", "ok") == "ok"]
    n_req = 6 if quick else 16
    for key, m in cells("paged_serve"):
        if m["blocks_leaked"] != 0 or not m["kv_bytes_ratio"] < 1:
            bad.append(f"paged_serve {key}: leaked {m['blocks_leaked']}, "
                       f"kv ratio {m['kv_bytes_ratio']}")
        if not m["completed_slot"] == m["completed_paged"] == n_req:
            bad.append(f"paged_serve {key}: completed {m['completed_slot']}"
                       f" / {m['completed_paged']} of {n_req}")
    for key, m in cells("decode_hotpath"):
        if not m["identical_tokens"]:
            bad.append(f"decode_hotpath {key}: tokens differ")
        if not m["baseline_syncs_per_step"] > m["fused_syncs_per_step"]:
            bad.append(f"decode_hotpath {key}: syncs a step "
                       f"{m['baseline_syncs_per_step']} (legacy) <= "
                       f"{m['fused_syncs_per_step']} (fused)")
    isa = {m_key: m for m_key, m in (
        (docs["isa_mapping"]["cells"][k]["params"]["case"], m)
        for k, m in cells("isa_mapping"))}
    bad += isa_gates(isa)
    return bad


def phase_campaign(torch, dev, seed, card):
    """The three experiments at their full grids through the port's runner
    into ``chiprun_out/campaign/``, rendered by the ``report`` command's
    code; their gates, the case kernels' values and ``ISA_MUST_CATCH``."""
    import io

    from repro_torch.core.campaign import report, runner
    from repro_torch.core.campaign.results import load_results
    from repro_torch.core.isa import sass_census
    from repro_torch.kernels import _build

    out_dir = OUT / "campaign"
    docs, paths, summary = {}, [], {}
    for name in CAMPAIGN_EXPERIMENTS:
        rep = runner.run(name, out_dir=out_dir, force=True, device=dev)
        docs[name] = load_results(rep.path)
        paths.append(rep.path)
        summary[name] = {"cells": rep.total_cells, "failed": rep.failed,
                         "seconds": rep.elapsed_s}
    buf = io.StringIO()
    report.render_result_files(paths, file=buf)
    rows = buf.getvalue().splitlines()[1:]
    failures = campaign_gates(docs)

    source = sass_census.SOURCE.read_text()
    texts = sass_census.build_texts()
    values = isa_values(torch, _build.build("isa_cases", source), dev, seed)
    failures += [f"isa value {c}: {v}" for c, v in values.items()
                 if not v["ok"]]
    controls, variant_texts = isa_controls(torch, dev, seed, texts)
    isa_dir = OUT / "isa"
    isa_dir.mkdir(parents=True, exist_ok=True)
    for name, (ptx_text, sass_text) in {"cases": texts,
                                        **variant_texts}.items():
        (isa_dir / f"{name}.ptx").write_text(ptx_text)
        (isa_dir / f"{name}.sass").write_text(sass_text)
    missed = [n for n in ISA_MUST_CATCH if not controls[n]["caught"]]
    emit({"phase": "campaign", "nvidia_smi": card, "experiments": summary,
          "rows": {name: sum(r.startswith(prefix) for r in rows)
                   for name, prefix in (("paged_serve", "paged_serve/"),
                                        ("decode_hotpath", "decode_hotpath/"),
                                        ("isa_mapping", "table5/"))},
          "table5": [r for r in rows if r.startswith("table5/")],
          "serving_rows": [r for r in rows if not r.startswith("table5/")],
          "isa_values": values, "controls": controls})
    if failures or missed:
        raise AssertionError(f"campaign gates failed: {failures}; "
                             f"controls missed: {missed}")


# -- phase autotune: the autotuner on the card ---------------------------
# the main path's problems, where phases kernel, flash_kernel, probes,
# wkv6_kernel and ssm_kernel hold each kernel: paged at the serve shapes,
# flash at the longest prompt (bf16, the bf16 accumulator opened),
# mxu_probe bf16 512^3, and the two eval shapes
AUTOTUNE_SHAPES = {
    "paged_attention": {"batch": 8, "heads": 8, "kv_heads": 4,
                        "head_dim": 256, "ctx": 1024},
    "flash_attention": {"batch": 1, "seq_q": 900, "seq_kv": 900, "heads": 8,
                        "kv_heads": 4, "head_dim": 256},
    "mxu_probe": {"m": 512, "k": 512, "n": 512},
    "ssm_scan": {"batch": 4, "seq": 4224, "d_inner": 1600, "state_dim": 16},
    "wkv6": {"batch": 4, "seq": 4096, "heads": 32, "head_dim": 64},
}
AUTOTUNE_TOP_K = 3
AUTOTUNE_ITERS = 20               # timed calls a candidate (median)
# the round trip's cached paged config, other than the default (16, 64)
AUTOTUNE_CACHED = {"block_size": 32, "chunk_tokens": 128, "num_splits": 1}
# faults the autotune gates must catch: an entry written under another
# calibration served (the key gate), a timed candidate whose output is
# wrong (its context one token short, at the main path's ctx 1,024; the
# check before timing), a cached chunk the kernel cannot launch replaced
# by the default (the dispatch must raise), and decode_longctx's kernel
# one token short at ctx 4,096 (its cell gate)
AUTOTUNE_MUST_CATCH = ("other_calibration", "corrupt_candidate",
                       "unlaunchable_replaced", "longctx_token_dropped")
AUTOTUNE_UNLAUNCHABLE_CHUNK = 48
# decode_longctx's longest context, where its control drops a token
AUTOTUNE_LONGCTX_CTX = 4096
# the paged kernel at the autotune and decode_longctx shapes against its
# plain version on the same pages: both accumulate in f32 and differ in
# summation order only, measured at 1e-6 of max|want| in f32; in bf16 the
# outputs may also round apart by one bf16 step (at most 2^-7 |want|).
# The inputs (normal x 0.3) give outputs of about 0.3 / sqrt(ctx), so a
# token dropped from 1,024 (4,096) moves them by about 3% (1.5%) of a
# typical output, far past both terms
PAGED_REL_TOL = 1e-4


def paged_close(torch, out, want):
    """The paged kernel's output against its plain version: |out - want|
    <= PAGED_REL_TOL max|want|, plus 2^-7 |want| in bf16.  Returns (ok,
    max |out - want|)."""
    d = (out.float() - want.float()).abs()
    lim = PAGED_REL_TOL * want.float().abs().max()
    if out.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * want.float().abs()
    return bool((d <= lim).all()), d.max().item()


def autotune_plain(torch, kernel, config, args):
    """The plain version of a tuned candidate's call on its inputs."""
    from repro_torch.kernels import ref
    if kernel == "flash_attention":
        return ref.flash_attention_plain(
            *args, causal=True, block_q=int(config["block_q"]),
            block_k=int(config["block_k"]), acc_dtype=config["acc_dtype"])
    if kernel == "paged_attention":
        return ref.paged_attention_plain(*args)
    if kernel == "mxu_probe":
        return ref.mxu_probe_plain(*args, chain=1)
    return {"ssm_scan": ref.ssm_scan_plain, "wkv6": ref.wkv6_plain}[
        kernel](*args)


def autotune_close(torch, kernel, out, want):
    """A candidate's output against its plain version: the paged kernel
    ``paged_close``, and the others at the tolerance their kernel's phase
    holds them to: flash ``_tol_ratio``, mxu_probe ``REL_TOL`` of
    max|want|, the recurrences ``_check_close``.  Returns (ok, max |out -
    want|)."""
    from repro_torch.kernels.mxu_probe import REL_TOL
    err = (out.float() - want.float()).abs().max().item()
    if kernel == "paged_attention":
        ok = paged_close(torch, out, want)[0]
    elif kernel == "flash_attention":
        ok = _tol_ratio(out, want) <= 1
    elif kernel == "mxu_probe":
        ok = _rel_err(out, want) <= REL_TOL
    else:
        try:
            _check_close(torch, out, want)
            ok = True
        except AssertionError:
            ok = False
    return ok, err


def autotune_checker(torch, records):
    """The tuner's check before timing: each shortlisted candidate's first
    output against its plain version; a wrong one raises."""
    def check(kernel, config, out, fn, args):
        want = autotune_plain(torch, kernel, config, args)
        ok, err = autotune_close(torch, kernel, out, want)
        records.append({"kernel": kernel, "config": dict(config),
                        "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"{kernel} candidate {config} disagrees "
                                 f"with its plain version: {err}")
    return check


def autotune_key_gate(tuner, kernel, shapes):
    """What the dispatch gets from ``tuner`` for this problem, and a
    failure for every entry it served that another calibration or device
    wrote."""
    from repro_torch.core.autotune import split_key
    got = tuner.lookup(kernel, shapes)
    own = (tuner.device_kind, tuner.cost_model.cal.name)
    bad = [f"served {k}" for k in tuner.stats.hit_keys
           if tuple(split_key(k)[3:]) != own]
    return got, bad


def autotune_leaky(tuner):
    """Fault ``other_calibration``: a lookup that matches every part of
    the key but the calibration."""
    from repro_torch.core.autotune import split_key

    def lookup(kernel, shapes, dtype=None):
        want = split_key(tuner.key_for(kernel, shapes, dtype))[:4]
        for key, entry in tuner.cache.items(kernel):
            if split_key(key)[:4] == want:
                tuner.stats.record_hit(key)
                return dict(entry["config"])
        return None
    tuner.lookup = lookup
    return tuner


def autotune_corrupt(tuner):
    """Fault ``corrupt_candidate``: the timed paged call reads a context
    one token short of the inputs it is checked on."""
    make = tuner.example_call

    def example_call(kernel, shapes, dtype, config):
        fn, args = make(kernel, shapes, dtype, config)
        if kernel == "paged_attention":
            return (lambda q, kp, vp, bt, ctx:
                    fn(q, kp, vp, bt, ctx - 1)), args
        return fn, args
    tuner.example_call = example_call
    return tuner


def autotune_unlaunchable_gate(call):
    """A dispatch under a cached chunk the kernel cannot launch must raise;
    a failure when ``call`` returns instead."""
    try:
        call()
    except ValueError:
        return []
    return ["an unlaunchable cached chunk was launched as another"]


def autotune_controls(torch, dev, cm, paged_shapes):
    """Each ``AUTOTUNE_MUST_CATCH`` fault against its gate, beside the
    sound path through the same gate (which must pass)."""
    from repro_torch.core import autotune
    from repro_torch.core.autotune import Autotuner, TuningCache
    from repro_torch.core.autotune.search import example_call
    from repro_torch.core.costmodel import CostModel
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import CHUNK_TOKENS, CHUNKS

    out, failures = {}, []
    # an entry written under another calibration, in a shared cache
    cache = TuningCache(None)
    own = Autotuner(cm, cache)
    other = Autotuner(CostModel.from_named("ampere_a100"), cache,
                      device_kind=own.device_kind)
    other.tune("paged_attention", paged_shapes)
    got, bad = autotune_key_gate(own, "paged_attention", paged_shapes)
    failures += bad + ([f"served {got}"] if got is not None else [])
    _, caught = autotune_key_gate(autotune_leaky(Autotuner(cm, cache)),
                                  "paged_attention", paged_shapes)
    out["other_calibration"] = {"caught": bool(caught), "gate": caught}
    # a timed candidate whose output is wrong, beside the sound tune, at
    # the shapes the measured tune times (two candidates at least, so the
    # shortlist is timed)
    records = []
    for fault in (False, True):
        tuner = Autotuner(cm, measure=True, top_k=2, device=dev,
                          measure_iters=2, measure_warmup=1,
                          check=autotune_checker(torch, records))
        try:
            (autotune_corrupt(tuner) if fault else tuner).tune(
                "paged_attention", paged_shapes)
            caught = False
        except AssertionError:
            caught = True
        if not fault and caught:
            failures.append(f"the sound tune at ctx {paged_shapes['ctx']} "
                            f"failed its check: {records}")
    out["corrupt_candidate"] = {"caught": caught, "checked": records}
    # a cached chunk the kernel cannot launch
    tuner = Autotuner(cm, dtype="bf16")
    cfg = dict(tuner.config_for("paged_attention", paged_shapes),
               chunk_tokens=AUTOTUNE_UNLAUNCHABLE_CHUNK)
    tuner.cache.put(tuner.key_for("paged_attention", paged_shapes),
                    {"config": cfg})
    fn, args = example_call("paged_attention", paged_shapes, "bf16", cfg,
                            dev)

    def replaced(q, kp, vp, bt, ctx):
        c = ops.resolve_kernel_config(
            "paged_attention", {"batch": q.shape[0], "heads": q.shape[1],
                                "kv_heads": kp.shape[2],
                                "head_dim": q.shape[2],
                                "ctx": bt.shape[1] * kp.shape[1]},
            q.dtype, tuned=True)
        ct = c["chunk_tokens"] if c["chunk_tokens"] in CHUNKS \
            else CHUNK_TOKENS
        return ops.paged_attention(q, kp, vp, bt, ctx, chunk_tokens=ct)
    with autotune.using(tuner):
        failures += autotune_unlaunchable_gate(
            lambda: ops.paged_attention(*args, tuned=True))
        caught = autotune_unlaunchable_gate(lambda: replaced(*args))
    out["unlaunchable_replaced"] = {"caught": bool(caught), "gate": caught}
    # decode_longctx's kernel one token short at its longest context,
    # beside the sound call, through the cell gate
    from repro_torch.core.campaign.registry import longctx_inputs
    from repro_torch.kernels.ref import paged_attention_ref
    pool = torch.bfloat16 if torch.device(dev).type == "cuda" \
        else torch.float32
    q, kp, vp, bt, lens, _ = longctx_inputs(AUTOTUNE_LONGCTX_CTX, dev, pool)
    want = paged_attention_ref(q, kp, vp, bt, lens)
    gates = {}
    for fault, n in (("sound", lens), ("longctx_token_dropped", lens - 1)):
        got = ops.paged_attention(q, kp, vp, bt, n)
        gates[fault] = longctx_gates({"cells": {f"ctx{AUTOTUNE_LONGCTX_CTX}":
                                                {"metrics": {
            "max_abs_err_vs_ref": float((got.float() - want.float())
                                        .abs().max()),
            "max_abs_ref": float(want.float().abs().max())}}}})
    failures += gates["sound"]
    out["longctx_token_dropped"] = {
        "caught": bool(gates["longctx_token_dropped"]),
        "gate": gates["longctx_token_dropped"]}
    return out, failures


def autotune_round_trip(torch, np, seed, cm, path, card_dev="cuda"):
    """The cache persisted at ``path`` holding ``AUTOTUNE_CACHED`` for the
    reduced f32 gemma2 of phase hotpath, reloaded by a fresh
    ``TuningCache(path)``, then that model's trace (32 prompts of 1-30
    tokens, 4 new tokens) through the paged engine with an autotuner over
    it, on the card and on the CPU, beside an untuned engine: the engine
    must read the cached page size and chunk from the cache, every paged
    decode must launch with that chunk (the untuned one with the default),
    and the tokens must be identical everywhere."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.autotune import Autotuner, TuningCache
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import PagedServingEngine

    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    kw = dict(max_batch=4, max_len=48, chunk_size=8)
    shapes = {"batch": kw["max_batch"], "heads": cfg.n_heads,
              "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
              "ctx": kw["max_len"]}
    writer = Autotuner(cm, TuningCache(path), dtype="f32")
    writer.cache.put(writer.key_for("paged_attention", shapes),
                     {"config": dict(AUTOTUNE_CACHED)})
    reloaded = TuningCache(path)
    failures = []
    if reloaded.entries != writer.cache.entries:
        failures.append("the reloaded cache differs from the written one")
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 31, size=32)]
    cpu_params = build_model(cfg, device="cpu").init(seed)
    out = {}
    launch, chunks = pa.paged_attention, []

    def spy(*a, **k):
        chunks.append(k["chunk_tokens"])
        return launch(*a, **k)
    # the wrapper counts its launches under its module's name, which is
    # the spy's while it stands in
    pa.paged_attention = spy
    try:
        for label, d, tuned in (("card", card_dev, True),
                                ("cpu", "cpu", True),
                                ("untuned", card_dev, False)):
            tuner = Autotuner(cm, reloaded, dtype="f32") if tuned else None
            eng = PagedServingEngine(build_model(cfg, device=d),
                                     params_to(cpu_params, d),
                                     autotuner=tuner, **kw)
            spy.launches = 0
            chunks.clear()
            rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
            eng.run_until_done()
            out[label] = {
                "block_size": eng.block_size,
                "kernel_chunk": eng.kernel_chunk,
                "tokens": [eng.done[r].tokens for r in rids],
                "paged_launches": spy.launches,
                "dispatched_chunks": sorted(set(chunks)),
                "tuner_hits": tuner.stats.hits if tuned else 0}
    finally:
        pa.paged_attention = launch
    for label in ("card", "cpu"):
        r = out[label]
        if (r["block_size"], r["kernel_chunk"]) != (
                AUTOTUNE_CACHED["block_size"],
                AUTOTUNE_CACHED["chunk_tokens"]):
            failures.append(f"{label}: engine read ({r['block_size']}, "
                            f"{r['kernel_chunk']})")
        if not r["tuner_hits"]:
            failures.append(f"{label}: the engine never hit the cache")
        if r["dispatched_chunks"] != [AUTOTUNE_CACHED["chunk_tokens"]]:
            failures.append(f"{label}: decodes launched with chunks "
                            f"{r['dispatched_chunks']}")
    if out["untuned"]["dispatched_chunks"] != [pa.CHUNK_TOKENS]:
        failures.append(f"untuned decodes launched with chunks "
                        f"{out['untuned']['dispatched_chunks']}")
    if out["untuned"]["block_size"] != 16:
        failures.append(f"untuned block size {out['untuned']['block_size']}")
    if torch.device(card_dev).type == "cuda" and not all(
            out[k]["paged_launches"] for k in ("card", "untuned")):
        failures.append("a card engine never launched paged_attention")
    if not out["card"]["tokens"] == out["cpu"]["tokens"] \
            == out["untuned"]["tokens"]:
        failures.append("tokens differ between the tuned card, tuned CPU "
                        "and untuned engines")
    summary = {k: {key: v for key, v in r.items() if key != "tokens"}
               for k, r in out.items()}
    summary["distinct_tokens"] = len({t for r in out["card"]["tokens"]
                                      for t in r})
    return summary, failures


def longctx_gates(doc):
    """decode_longctx: no failed cell, every cell's output (f32: q is
    f32) within ``PAGED_REL_TOL`` of the oracle's max |output|."""
    bad = []
    for key, rec in sorted(doc["cells"].items()):
        if rec.get("status", "ok") != "ok":
            bad.append(f"{key}: {rec.get('error', '')[:300]}")
            continue
        m = rec["metrics"]
        if not m["max_abs_err_vs_ref"] <= PAGED_REL_TOL * m["max_abs_ref"]:
            bad.append(f"{key}: max_abs_err_vs_ref "
                       f"{m['max_abs_err_vs_ref']} of max |ref| "
                       f"{m['max_abs_ref']}")
    return bad


def phase_autotune(torch, np, dev, seed, card):
    """The autotuner on the card: an analytic and a measured tune of the
    five tunables at the main path's shapes against the calibration
    phase's fresh table (each timed candidate held against its plain
    version first), the cache's round trip into the paged engine on card
    and CPU, ``decode_longctx``'s full grid, and ``AUTOTUNE_MUST_CATCH``."""
    import io
    import tempfile

    from repro_torch.core.autotune import Autotuner, TuningCache
    from repro_torch.core.campaign import report, runner
    from repro_torch.core.campaign.results import load_results
    from repro_torch.core.costmodel import CostModel

    cm = CostModel.from_named(OUT / "hopper_h100.json")
    failures = []
    analytic = Autotuner(cm, allow_low_precision=True).tune_all(
        shapes=AUTOTUNE_SHAPES)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cache.json"
        records = []
        tuner = Autotuner(cm, TuningCache(path), measure=True,
                          top_k=AUTOTUNE_TOP_K, device=dev,
                          allow_low_precision=True,
                          measure_iters=AUTOTUNE_ITERS, measure_warmup=3,
                          check=autotune_checker(torch, records))
        reset_launches()
        measured = tuner.tune_all(shapes=AUTOTUNE_SHAPES)
        counts = launch_counts()
        for name, res in sorted(measured.items()):
            timed = [{"config": r["config"], "predicted_s": r["predicted_s"],
                      "measured_s": r["measured_s"]}
                     for r in res.ranked if "measured_s" in r]
            emit({"phase": "autotune", "kernel": name,
                  "shapes": res.shapes, "candidates": len(res.ranked),
                  "best": res.best, "default": res.default,
                  "analytic_best": analytic[name].best,
                  "predicted_best_s": res.predicted_best_s,
                  "predicted_default_s": res.predicted_default_s,
                  "measured_best_s": res.measured_best_s,
                  "measured_default_s": res.measured_default_s,
                  "measured_speedup": res.measured_speedup,
                  "timed": timed, "launches": counts[name],
                  **({} if timed else {
                      "untimed": "one candidate, so the pick is fixed; "
                                 "the kernel's time is its own phase's"})})
            if len(res.ranked) > 1 and not (timed and counts[name]):
                failures.append(f"the measured tune never timed {name}")
        if TuningCache(path).entries != tuner.cache.entries:
            failures.append("the measured cache did not round-trip")
        trip, bad = autotune_round_trip(torch, np, seed, cm, path)
        failures += bad
    doc = load_results(runner.run("decode_longctx", out_dir=OUT / "campaign",
                                  force=True, device=dev).path)
    failures += [f"decode_longctx {b}" for b in longctx_gates(doc)]
    buf = io.StringIO()
    report.render_rows(report.table_for(doc), file=buf)
    controls, bad = autotune_controls(torch, dev, cm,
                                      AUTOTUNE_SHAPES["paged_attention"])
    failures += [f"controls' sound path: {b}" for b in bad]
    missed = [n for n in AUTOTUNE_MUST_CATCH if not controls[n]["caught"]]
    emit({"phase": "autotune", "nvidia_smi": card,
          "checked": records, "round_trip": trip,
          "decode_longctx": [
              {k: m[k] for k in ("ctx", "chunk_tokens", "kernel_us", "tok_s",
                                 "default_tok_s", "speedup", "tuned_chunk",
                                 "predicted_best_chunk", "identical_tokens",
                                 "max_abs_err_vs_ref", "max_abs_ref")}
              for m in (rec["metrics"] for _, rec in sorted(
                  doc["cells"].items())
                  if rec.get("status", "ok") == "ok")],
          "decode_longctx_rows": buf.getvalue().splitlines()[1:],
          "controls": {n: {"caught": c["caught"]}
                       for n, c in controls.items()}})
    if not all(r["ok"] for r in records):
        failures.append("a timed candidate disagreed with its plain version")
    if failures or missed:
        raise AssertionError(f"autotune gates failed: {failures}; "
                             f"controls missed: {missed}")


# -- phase telemetry: the sim harness and the telemetry layer on the card ----
# Fault controls the telemetry gates must catch: a step record that reads a
# device value (the sync gate), a controller that feeds steps with a decode
# and prefill chunks to the drift detector as decode samples (the
# attribution check), and a retirement stamped by the wall clock in place
# of the engine's injected clock (the sim scenarios' exact latencies).
TELEMETRY_MUST_CATCH = ("record_reads_device", "mixed_fed",
                        "wall_clock_retire")
TELEMETRY_GATE = 0.10         # the drift detector's gate (the cost CLI's bar)
TELEMETRY_RUNS = 1            # full-width runs with telemetry on, and off
SLO_TARGET_FACTOR = 0.8       # the SLO's p99 target over the ungated p99
SLO_ARRIVAL_GAP = 2           # (c): one request arrives every 2 iterations
SLO_WINDOW = 8                # (c): the bucket of the sim overload scenario
# the strings a refused device read raises with: sync debugging on the
# card, ``_reads_raise``'s refusal on the CPU
READ_REFUSALS = {"cuda": "synchronizing", "cpu": "read a tensor"}
# tensor read-backs refused while a step record is built on the CPU
_TENSOR_READS = ("item", "tolist", "numpy", "__int__", "__float__",
                 "__index__", "__bool__")


@contextlib.contextmanager
def telemetry_fault(name):
    """Inject a fault of ``TELEMETRY_MUST_CATCH`` into every engine (or
    controller) for the duration of the block."""
    from repro_torch.serve.engine import _DeviceLoop
    from repro_torch.serve.telemetry import TelemetryController

    if name == "record_reads_device":
        cls, attr = _DeviceLoop, "_step_record"
        build = cls._step_record

        def fault(self, *args, **kw):
            int(self._toks[0])                    # the newest token, read
            return build(self, *args, **kw)
    elif name == "mixed_fed":
        cls, attr = TelemetryController, "_feed_drift"

        def fault(self, record):
            if record.decode_ran:                 # mixed steps included
                event = self.detector.observe(
                    "decode", self._decode_bucket, record.predicted_decode_s,
                    record.measured_s)
                if event is not None:
                    self._apply(event, record)
    elif name == "wall_clock_retire":
        cls, attr = _DeviceLoop, "_stamp_retired"
        stamp = cls._stamp_retired

        def fault(self, req):
            clock, self._clock = self._clock, time
            try:
                stamp(self, req)
            finally:
                self._clock = clock
    else:
        raise ValueError(name)
    saved = cls.__dict__[attr]
    setattr(cls, attr, fault)
    try:
        yield
    finally:
        setattr(cls, attr, saved)


@contextlib.contextmanager
def _reads_raise(torch, device):
    """Make a device read raise: sync debugging set to "error" on the card;
    on the CPU, where a read does not sync, the tensor read-backs."""
    if device.type == "cuda":
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        return
    saved = {n: torch.Tensor.__dict__.get(n) for n in _TENSOR_READS}

    def refuse(*args, **kw):
        raise RuntimeError("a step record read a tensor")
    for n in _TENSOR_READS:
        setattr(torch.Tensor, n, refuse)
    try:
        yield
    finally:
        for n, f in saved.items():
            if f is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, f)


@contextlib.contextmanager
def record_sync_gate(torch):
    """The sync gate of the step records: each record built in the block is
    built with device reads raising (``_reads_raise``), so a record that
    reads a device value fails the run."""
    from repro_torch.serve.engine import _DeviceLoop

    build = _DeviceLoop.__dict__["_step_record"]

    def guarded(self, *args, **kw):
        with _reads_raise(torch, self.device):
            return build(self, *args, **kw)
    _DeviceLoop._step_record = guarded
    try:
        yield
    finally:
        _DeviceLoop._step_record = build


def attribution_spy(ctl):
    """Record each sample ``ctl``'s drift detector is fed, as (kind, the
    step record it came from)."""
    fed, current = [], [None]
    on_step, observe = ctl.on_step, ctl.detector.observe

    def spy_step(record):
        current[0] = record
        on_step(record)

    def spy_observe(kind, *args, **kw):
        fed.append((kind, current[0]))
        return observe(kind, *args, **kw)
    ctl.on_step, ctl.detector.observe = spy_step, spy_observe
    return fed


def attribution_gate(fed, records):
    """The attribution check: the detector is fed every pure-decode step as
    a decode sample, in order, and nothing else (the engines bind the
    controller before ``chunk_size`` is set, as the JAX engines do, so it
    has no chunk bucket)."""
    def kind(r):
        return "decode" if r.decode_ran and not r.n_prefill_units else None
    want = [(kind(r), r.step) for r in records if kind(r)]
    got = [(k, r.step) for k, r in fed]
    if got == want:
        return []
    wrong = [f"step {r.step} ({r.n_prefill_units} chunks, decode "
             f"{r.decode_ran}) fed as {k}" for k, r in fed if kind(r) != k]
    return [f"{len(got)} samples fed, {len(want)} attributable"] + wrong[:3]


def placement_spy(eng):
    """{rid: the step that placed it} of a paged engine (a replayed
    request keeps its last placement)."""
    placed, place = {}, eng._place

    def spy(req):
        idx = place(req)
        if idx is not None:
            placed[req.rid] = eng.stats.steps + 1
        return idx
    eng._place = spy
    return placed


def telemetry_controller(target_p99_s=None):
    """The controller of the live runs: a drift detector at the 10% gate,
    recalibration applied, and, given a p99 target, the token bucket of
    the sim overload scenario (its rate pinned after each cut, its burst
    one step's rate, adapted every ``SLO_WINDOW`` steps)."""
    from repro_torch.serve.telemetry import (SLO, DriftDetector,
                                             TelemetryController, TokenBucket)
    bucket = None
    if target_p99_s is not None:
        bucket = TokenBucket(SLO(target_p99_s=target_p99_s,
                                 window=SLO_WINDOW, increase=0.0),
                             burst_factor=1.0)
    return TelemetryController(drift=DriftDetector(TELEMETRY_GATE),
                               slo=bucket, recalibrate=True)


def telemetry_serve(torch, make, prompts, max_new, ctl=None, gap=0):
    """Serve ``prompts`` through ``make(ctl)`` (``drive``) under the record
    sync gate, the controller's detector and the engine's placements
    spied: all before the first step (``gap`` 0), or one arriving every
    ``gap`` iterations, so that a run with an SLO and one without see the
    same arrivals, iteration for iteration."""
    eng = make(ctl)
    fed = attribution_spy(ctl) if ctl is not None else []
    placed = placement_spy(eng)
    rids, arrived = [], {}

    def arrive(i):
        while len(rids) < len(prompts) and len(rids) * gap <= i:
            rid = eng.submit(prompts[len(rids)], max_new_tokens=max_new)
            rids.append(rid)
            arrived[rid] = eng.stats.steps + 1
        return len(rids) < len(prompts)
    with record_sync_gate(torch):
        step_ms, run_s, counts = drive(torch, eng, arrive)
    return {"eng": eng, "ctl": ctl, "fed": fed, "placed": placed,
            "arrived": arrived,
            "tokens": [eng.done[r].tokens for r in rids], "run_s": run_s,
            "counts": counts}


TELEMETRY_COUNTERS = ("steps", "host_syncs", "table_uploads",
                      "decode_dispatches")


def telemetry_run_gates(run, n_req):
    """A run's gates: every request completed; with telemetry, one step
    record for each counted (productive) step, one request record for each
    completed request, every drift sample attributable."""
    eng, ctl = run["eng"], run["ctl"]
    st = eng.stats
    bad = [] if st.completed == n_req else [
        f"completed {st.completed} of {n_req}"]
    if ctl is None:
        return bad
    steps = ctl.sink.steps()
    if [r.step for r in steps] != list(range(1, st.steps + 1)):
        bad.append(f"{len(steps)} step records for {st.steps} steps")
    if sorted(r.rid for r in ctl.sink.requests()) != sorted(eng.done):
        bad.append(f"{len(ctl.sink.requests())} request records for "
                   f"{st.completed} completed")
    return bad + attribution_gate(run["fed"], steps)


def _counters(run):
    return {k: getattr(run["eng"].stats, k) for k in TELEMETRY_COUNTERS}


def telemetry_scenarios(dev):
    """Both sim scenarios with the fake model's tensors on ``dev``."""
    from repro_torch.serve.telemetry.scenarios import (run_drift_scenario,
                                                       run_overload_scenario)
    return {"drift": run_drift_scenario(device=dev),
            "overload": run_overload_scenario(device=dev)}


def scenario_gate(got, want):
    """The sim scenarios' exact check: every field of each result dict
    equal to the reference run's (the fake's arithmetic is integer and
    the clock scripted, so latencies are exact); returns the fields that
    differ."""
    return [f"{name}.{k}" for name in want
            for k in sorted(set(want[name]) | set(got[name]))
            if got[name].get(k) != want[name].get(k)]


def drift_readings(ctl):
    """The controller's recalibrations and the decode prediction's error:
    at the first event (its windowed error) and after it (the median over
    the pure-decode steps priced by the corrected model), with the
    detector's window at the end."""
    from repro_torch.serve.telemetry.metrics import quantile

    events = ctl.recalibrations
    after = None
    if events:
        post = [abs(r.measured_s / r.predicted_decode_s - 1.0)
                for r in ctl.sink.steps()
                if r.decode_ran and r.n_prefill_units == 0
                and r.step > events[0].step and r.predicted_decode_s > 0]
        after = quantile(post, 0.5) if post else None
    return {"events": [{k: e.as_dict()[k] for k in (
                "kind", "bucket", "ratio", "error", "step", "bottleneck",
                "applied", "calibration_before", "calibration_after")}
                       for e in events],
            "error_before": events[0].error if events else None,
            "error_after": after,
            "decode_window_error_at_end": ctl.detector.error(
                "decode", ctl._decode_bucket)}


def telemetry_run_line(run):
    """One telemetry-on run in brief: its events (step, kind, ratio), the
    decode prediction's error after the first, the host step's p50 and
    p99."""
    from repro_torch.serve.telemetry.metrics import quantile

    ctl = run["ctl"]
    measured = [r.measured_s for r in ctl.sink.steps()]
    return {"events": [(e.step, e.kind, e.ratio)
                       for e in ctl.recalibrations],
            "error_after": drift_readings(ctl)["error_after"],
            "step_p50_ms": 1e3 * quantile(measured, 0.5),
            "step_p99_ms": 1e3 * quantile(measured, 0.99)}


def _waits(run):
    """{rid: steps from its arrival to its (last) placement}."""
    return {rid: step - run["arrived"][rid]
            for rid, step in run["placed"].items()}


def slo_readings(run, ungated, target):
    """The SLO run against the ungated run of the same arrivals: p99 over
    every step and, as the sim overload scenario reads it, after the
    bucket's first window, against the target; the deferrals, and what
    was shed: each request that waited longer for its placement than
    without the SLO, newest first, with the steps it lost; and the most
    chunks and the largest planned seconds of a step, which the bucket's
    rate must fall under before it defers anything."""
    from repro_torch.serve.telemetry.metrics import quantile

    ctl, st = run["ctl"], run["eng"].stats
    measured = [r.measured_s for r in ctl.sink.steps()]
    p99 = quantile(measured[SLO_WINDOW:], 0.99)
    waits, base = _waits(run), _waits(ungated)
    shed = sorted(((rid, w - base[rid]) for rid, w in waits.items()
                   if w > base[rid]), reverse=True)
    return {"target_p99_s": target, "p99_s": p99,
            "p99_all_steps_s": quantile(measured, 0.99),
            "ungated_p99_s": quantile(
                [r.measured_s for r in ungated["ctl"].sink.steps()], 0.99),
            "held": p99 <= target,
            "deferred_prefills": st.deferred_prefills, "steps": st.steps,
            "ungated_steps": ungated["eng"].stats.steps,
            "admission_order": list(st.admission_order),
            "most_chunks_a_step": max(r.n_prefill_units
                                      for r in ctl.sink.steps()),
            "largest_planned_s": max(r.predicted_s
                                     for r in ctl.sink.steps()),
            "waited_steps": waits, "ungated_waited_steps": base,
            "shed_newest_first": shed,
            "bucket_windows": ctl.bucket.windows,
            "bucket_violations": ctl.bucket.violations,
            "rate_trace_s": ctl.bucket.rate_trace,
            "recalibrations": len(ctl.recalibrations)}


def slo_gates(run, n_req):
    """The SLO run's gates: every admitted request completes and admission
    stays FIFO: first placements in request order (an evicted request is
    placed again, from the queue's head; whether p99 holds is a
    reading)."""
    order = run["eng"].stats.admission_order
    first = [rid for i, rid in enumerate(order) if rid not in order[:i]]
    bad = telemetry_run_gates(run, n_req)
    if first != sorted(first):
        bad.append(f"admission not FIFO: {first}")
    return bad


def slo_runs(serve, cm, n_req):
    """(c): the requests arriving one every ``SLO_ARRIVAL_GAP`` iterations,
    priced by ``cm``, without an SLO and then under one at
    ``SLO_TARGET_FACTOR`` of that run's p99.  Returns (ungated, gated,
    target, failures)."""
    from repro_torch.serve.telemetry.metrics import quantile

    ungated = serve(telemetry_controller(), cm, SLO_ARRIVAL_GAP)
    target = SLO_TARGET_FACTOR * quantile(
        [r.measured_s for r in ungated["ctl"].sink.steps()], 0.99)
    gated = serve(telemetry_controller(target), cm, SLO_ARRIVAL_GAP)
    failures = [f"ungated: {b}" for b in telemetry_run_gates(ungated, n_req)]
    failures += [f"slo: {b}" for b in slo_gates(gated, n_req)]
    return ungated, gated, target, failures


def record_read_caught(torch, dev, run):
    """Control ``record_reads_device``: ``run()`` under the fault.  Caught
    (the refusal's message) only when the record's device read was
    refused, by sync debugging on the card or ``_reads_raise`` on the
    CPU; any other error is raised, not counted."""
    with telemetry_fault("record_reads_device"):
        try:
            run()
        except RuntimeError as e:
            if READ_REFUSALS[torch.device(dev).type] not in str(e):
                raise
            return [str(e)[:200]]
    return []


def telemetry_reduced(torch, np, seed, dev="cuda"):
    """Reduced f32 gemma2 (phase hotpath's model and trace) through the
    paged engine on ``dev``, priced by the committed H100 table: tokens
    with telemetry on equal to those with it off, and, with the arrivals
    of (c) priced by the model the telemetry run recalibrated, tokens
    under the SLO equal to the ungated run's; then the controls
    ``record_reads_device`` (caught only by the read refusal itself) and
    ``mixed_fed``.  Returns (readings, failures, {control: what caught
    it})."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.costmodel import CostModel
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import PagedServingEngine

    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 31, size=32)]
    model = build_model(cfg, device=dev)
    params = params_to(build_model(cfg, device="cpu").init(seed), dev)

    def serve(ctl, cm=None, gap=0):
        return telemetry_serve(torch, lambda c: PagedServingEngine(
            model, params, max_batch=4, max_len=48, block_size=8,
            n_blocks=10, chunk_size=8, telemetry=c,
            cost_model=cm or CostModel.from_named("hopper_h100")),
            prompts, 4, ctl, gap)

    off, on = serve(None), serve(telemetry_controller())
    failures = [f"telemetry on: {b}" for b in telemetry_run_gates(
        on, len(prompts))]
    if on["tokens"] != off["tokens"]:
        failures.append("tokens differ with telemetry on")
    if _counters(on) != _counters(off):
        failures.append(f"counters {_counters(on)} != {_counters(off)}")
    ungated, slo, target, bad = slo_runs(serve, on["eng"].cost_model,
                                         len(prompts))
    failures += bad
    if slo["tokens"] != ungated["tokens"]:
        failures.append("tokens differ under the SLO")
    caught = {"record_reads_device": record_read_caught(
        torch, dev, lambda: serve(telemetry_controller()))}
    with telemetry_fault("mixed_fed"):
        run = serve(telemetry_controller())
    caught["mixed_fed"] = attribution_gate(run["fed"],
                                           run["ctl"].sink.steps())
    readings = {"steps": on["eng"].stats.steps,
                "distinct_tokens": len({t for r in on["tokens"] for t in r}),
                "identical_on_off": on["tokens"] == off["tokens"],
                "identical_slo": slo["tokens"] == ungated["tokens"],
                "drift": drift_readings(on["ctl"]),
                "slo": slo_readings(slo, ungated, target)}
    return readings, failures, caught


def phase_telemetry(torch, np, dev, seed, card):
    """The telemetry layer on the card: (a) both sim scenarios with the fake
    model's tensors on the card, equal to the CPU's dicts; (b) a live drift
    loop over phase serve's model and trace in the fused paged engine
    priced by the committed H100 table, ``TELEMETRY_RUNS`` runs each with
    telemetry on and off; (c) the same engine, priced by the model (b)
    recalibrated, with the trace's requests arriving one every
    ``SLO_ARRIVAL_GAP`` iterations, without an SLO and then under one at
    ``SLO_TARGET_FACTOR`` of that run's p99 (``slo_runs``); the reduced
    f32 token parity of ``telemetry_reduced``, and
    ``TELEMETRY_MUST_CATCH``."""
    from repro_torch.core.costmodel import CostModel
    from repro_torch.serve.engine import PagedServingEngine
    from repro_torch.serve.telemetry import load_snapshot
    from repro_torch.serve.telemetry.metrics import quantile

    failures, controls = [], {}
    want = telemetry_scenarios("cpu")
    with record_sync_gate(torch):
        got = telemetry_scenarios(dev)
    failures += [f"sim on the card: {k} differs"
                 for k in scenario_gate(got, want)]
    with telemetry_fault("wall_clock_retire"):
        controls["wall_clock_retire"] = scenario_gate(
            telemetry_scenarios(dev), want)

    cfg, model, params, prompts = serve_setup(np, dev, seed)
    kw = dict(max_batch=8, max_len=1024, block_size=16, chunk_size=64)

    def make(cm):
        return lambda ctl: PagedServingEngine(model, params, cost_model=cm,
                                              telemetry=ctl, **kw)
    warm = PagedServingEngine(model, params, **kw)
    warm.submit(prompts[0][:40], max_new_tokens=4)
    warm.run_until_done()
    del warm
    live = {"on": [], "off": []}
    for _ in range(TELEMETRY_RUNS):
        for label in ("off", "on"):
            ctl = telemetry_controller() if label == "on" else None
            live[label].append(telemetry_serve(
                torch, make(CostModel.from_named("hopper_h100")), prompts,
                32, ctl))
    first = live["on"][0]
    for label, runs in live.items():
        for i, run in enumerate(runs):
            failures += [f"{label} run {i}: {b}"
                         for b in telemetry_run_gates(run, len(prompts))]
            if _counters(run) != _counters(first):
                failures.append(f"{label} run {i}: counters {_counters(run)}"
                                f" != {_counters(first)}")
            launches = run["counts"]["paged_attention"]
            want_l = cfg.n_layers * run["eng"].stats.decode_dispatches
            if launches != want_l:
                failures.append(f"{label} run {i}: {launches} paged "
                                f"launches != {want_l}")
    snap = first["ctl"].sink.save(OUT / "telemetry_snapshot.json")
    if load_snapshot(snap) != json.loads(json.dumps(
            first["ctl"].sink.snapshot())):
        failures.append("the snapshot did not round-trip")
    measured = [r.measured_s for r in first["ctl"].sink.steps()]
    line = {"step_records": len(measured),
            "request_records": len(first["ctl"].sink.requests()),
            "counters": _counters(first),
            "drift": drift_readings(first["ctl"]),
            "on_runs": [telemetry_run_line(r) for r in live["on"]],
            "measured_step_p50_ms": 1e3 * quantile(measured, 0.5),
            "measured_step_p99_ms": 1e3 * quantile(measured, 0.99),
            "tok_per_s": {}}
    for label, runs in live.items():
        v = [r["eng"].stats.decoded_tokens / r["run_s"] for r in runs]
        line["tok_per_s"][label] = {"least": min(v), "most": max(v),
                                    "runs": v}
    ungated, slo, target, bad = slo_runs(
        lambda ctl, cm, gap: telemetry_serve(
            torch, make(cm), prompts, 32, ctl, gap),
        first["eng"].cost_model, len(prompts))
    failures += bad
    line["slo"] = slo_readings(slo, ungated, target)
    del live, slo, ungated, first, model, params
    torch.cuda.empty_cache()

    reduced_line, bad, caught = telemetry_reduced(torch, np, seed, dev)
    failures += [f"reduced {b}" for b in bad]
    controls.update(caught)
    missed = [n for n in TELEMETRY_MUST_CATCH if not controls[n]]
    emit({"phase": "telemetry", "nvidia_smi": card, "arch": cfg.name,
          "sim": {name: {k: v for k, v in res.items()
                         if k not in ("events", "summary")}
                  for name, res in got.items()},
          **line, "reduced": reduced_line,
          "controls": {n: {"caught": bool(c), "by": c[:2]}
                       for n, c in controls.items()}})
    if failures or missed:
        raise AssertionError(f"telemetry gates failed: {failures}; "
                             f"controls missed: {missed}")


CLUSTER_MUST_CATCH = ("leaked_origin", "unseen_poison", "dropped_reclaim")
CLUSTER_REPLICAS = 2
CLUSTER_POOL = 0.6            # a replica's pool over the slot rectangle
CLUSTER_LOAD = 2.0            # offered load over one warm replica's step
# (b) and (c): the skewed trace (every 2nd request long, so round-robin
# puts every long one on replica 0); 12 requests (6 long) keep the whole
# script near 600 s: round-robin's replays of a 7th and 8th long request
# on replica 0 took most of the phase's time
CLUSTER_TRACE = dict(n_requests=12, period=2, long_len=768, long_new=32,
                     short_len=16, short_new=8)
# (a): the skewed sim trace and cluster of tests/test_cluster.py
CLUSTER_SIM_TRACE = dict(n_requests=12, vocab=97, period=2, long_len=24,
                         short_len=4, long_new=12, short_new=4,
                         interval_s=1.0, load=2.0)
CLUSTER_SIM_KW = dict(max_batch=4, max_len=64, n_blocks=24, block_size=8,
                      chunk_size=8)
CHAOS_PRICES = (0.5, 0.25, 0.01)    # the drill's decode, chunk, overhead s
CHAOS_KINDS = ("crash", "hang", "corrupt", "crashloop")
CHAOS_AT_STEP = 6             # (c): replica 0's fault, mid-decode


def cluster_pool(max_batch, max_len, block_size):
    """A replica's pool: ``CLUSTER_POOL`` of the slot-equivalent rectangle
    (``traffic_scaling``'s ratio), at least one max_len sequence."""
    per_seq = -(-max_len // block_size)
    return max(per_seq, int(CLUSTER_POOL * max_batch * per_seq))


def cluster_trace(vocab, max_len, interval_s=1.0):
    """``CLUSTER_TRACE`` with the long prompts cut to fit ``max_len``."""
    from repro_torch.serve.cluster import skewed_trace

    kw = dict(CLUSTER_TRACE)
    kw["long_len"] = min(kw["long_len"], max_len - kw["long_new"] - 1)
    return skewed_trace(kw.pop("n_requests"), vocab=vocab,
                        interval_s=interval_s, load=CLUSTER_LOAD, **kw)


@contextlib.contextmanager
def cluster_fault(name):
    """Inject a fault of ``CLUSTER_MUST_CATCH`` for the duration of the
    block: the router keeps ``_origin`` entries it collected; the echo
    poison written into a copy of the staged buffer, not the buffer the
    drain reads; a reclaimed request continued after the tokens it had
    delivered, which are dropped."""
    import numpy as np

    from repro_torch.serve.chaos.faults import FaultyReplica
    from repro_torch.serve.cluster.router import Router

    if name == "leaked_origin":
        cls, attr = Router, "collect"

        def fault(self):
            n = 0
            for i, eng in enumerate(self.replicas):
                for rid in [r for r in eng.done if (i, r) in self._origin]:
                    crid = self._origin[(i, rid)]     # left in _origin
                    self.done[crid] = eng.done.pop(rid)
                    del self._local[crid]
                    self._moves.pop(crid, None)
                    n += 1
            return n
    elif name == "unseen_poison":
        cls, attr = FaultyReplica, "_poison_pending"

        def fault(self):
            if self.engine._pending is None:
                return False
            (buf, event), _ = self.engine._pending
            self.engine._wait_staged(event)
            copy = buf.clone()
            copy[1, :] = -1                          # nobody reads it
            return True
    elif name == "dropped_reclaim":
        cls, attr = Router, "reclaim_replica"
        reclaim = Router.reclaim_replica

        def fault(self, i):
            out = []
            for crid, req in reclaim(self, i):
                if 0 < len(req.tokens) < req.max_new_tokens:
                    req = dataclasses.replace(
                        req, prompt=np.concatenate(
                            [req.prompt, np.asarray(req.tokens, np.int32)]),
                        max_new_tokens=req.max_new_tokens - len(req.tokens),
                        tokens=[])
                out.append((crid, req))
            return out
    else:
        raise ValueError(name)
    saved = cls.__dict__[attr]
    setattr(cls, attr, fault)
    try:
        yield
    finally:
        setattr(cls, attr, saved)


def cluster_sim(dev):
    """(a) The sim tier with the fake model's tensors on ``dev``: the
    skewed sim trace through 2 replicas under each policy, and the
    ``chaos_serving`` quick grid's drills."""
    from repro_torch.serve.chaos import run_chaos_drill
    from repro_torch.serve.cluster import (ServingCluster, serve_trace,
                                           skewed_trace, unit_latency)
    from repro_torch.serve.sim import FakeCostModel, FakeModel, SimClock

    kw = dict(CLUSTER_SIM_TRACE)
    trace = skewed_trace(kw.pop("n_requests"), **kw)
    out = {}
    for policy in ("round_robin", "cost_aware"):
        clock = SimClock()
        cl = ServingCluster.build(
            FakeModel(vocab=kw["vocab"], device=dev), None,
            n_replicas=CLUSTER_REPLICAS, policy=policy, clock=clock,
            cost_model=FakeCostModel(decode_s=CHAOS_PRICES[0],
                                     prefill_s=CHAOS_PRICES[1]),
            **CLUSTER_SIM_KW)
        admitted = serve_trace(cl, trace, clock,
                               step_seconds=unit_latency(*CHAOS_PRICES),
                               min_dt=0.25)
        lats = sorted(cl.done[c].finished_s - admitted[c] for c in cl.done)
        out[policy] = {
            "wall_s": clock.t, "p99_s": lats[int(0.99 * (len(lats) - 1))],
            "completed": len(cl.done), "routed": list(cl.stats.routed),
            "reroutes": cl.stats.reroutes,
            "front_requeues": cl.stats.front_requeues,
            "preemptions": [e.stats.preemptions for e in cl.replicas],
            "tokens": [list(cl.done[c].tokens) for c in sorted(cl.done)]}
    for fault in CHAOS_KINDS:
        out[f"chaos_{fault}"] = run_chaos_drill(
            fault, CLUSTER_REPLICAS, n_requests=8, device=dev)
    return out


def cluster_sim_gates(sim):
    """The sim's own claims: cost-aware beats round-robin on wall time and
    p99 with the same tokens; every drill holds its invariants."""
    bad = []
    rr, ca = sim["round_robin"], sim["cost_aware"]
    if not (ca["wall_s"] < rr["wall_s"] and ca["p99_s"] < rr["p99_s"]):
        bad.append(f"cost_aware {ca['wall_s']}/{ca['p99_s']} s does not "
                   f"beat round_robin {rr['wall_s']}/{rr['p99_s']} s")
    if ca["tokens"] != rr["tokens"]:
        bad.append("sim tokens differ between policies")
    for fault in CHAOS_KINDS:
        m = sim[f"chaos_{fault}"]
        ok = (m["survivors_identical"] and m["all_accounted"]
              and m["tokens_lost"] == 0 and m["blocks_leaked"] == 0
              and m["failures"] >= 1
              and (fault != "crashloop" or m["quarantined"]))
        if not ok:
            bad.append(f"drill {fault}: {m}")
    return bad


def cluster_gates(cl, admitted, vocab, n_layers=0, launches=None):
    """(b)'s gates over a drained cluster: tokens conserved, the router
    drained, no leaked block, one sync a step, tokens in the vocabulary,
    and, given the paged kernel's ``launches``, one a layer of every
    decode dispatch."""
    bad = []
    if len(cl.done) != len(admitted) or any(
            len(q.tokens) != q.max_new_tokens for q in cl.done.values()):
        bad.append(f"{len(cl.done)} of {len(admitted)} admitted completed "
                   f"with all their tokens")
    try:
        cl.router.assert_drained()
    except AssertionError as e:
        bad.append(str(e))
    dispatches = 0
    for i, eng in enumerate(cl.replicas):
        try:
            eng.allocator.check()
        except AssertionError as e:
            bad.append(f"replica {i}: {e}")
        if eng.allocator.n_in_use:
            bad.append(f"replica {i}: {eng.allocator.n_in_use} blocks "
                       f"leaked")
        st = eng.stats
        if st.host_syncs > st.steps + 1:
            bad.append(f"replica {i}: {st.host_syncs} syncs over "
                       f"{st.steps} steps")
        dispatches += st.decode_dispatches
    if launches is not None and (launches == 0
                                 or launches != n_layers * dispatches):
        bad.append(f"{launches} paged launches != {n_layers} x "
                   f"{dispatches} decode dispatches")
    if any(t < 0 or t >= vocab for q in cl.done.values() for t in q.tokens):
        bad.append("a token outside the vocabulary")
    return bad


def cluster_live(torch, model, params, kw, cm):
    """(b) Two replicas of the fused paged engine sharing ``model`` and
    ``params``, each pool ``cluster_pool`` blocks; the arrival gap a warm
    replica's steady step at ``CLUSTER_LOAD``; the skewed trace through
    ``serve_trace`` under a ``SimClock`` advanced by the measured walls,
    once a policy, under sync debugging ("error") on the card.  Returns
    ({policy: reading}, failures)."""
    import numpy as np

    from repro_torch.serve.cluster import ServingCluster, serve_trace
    from repro_torch.serve.cluster.traffic import (decode_topology,
                                                   steady_step_s,
                                                   trace_summary)
    from repro_torch.serve.engine import PagedServingEngine
    from repro_torch.serve.sim import SimClock

    cfg = model.cfg
    kw = dict(kw, n_blocks=cluster_pool(kw["max_batch"], kw["max_len"],
                                        kw["block_size"]))
    cuda = model.device.type == "cuda"
    interval = steady_step_s(
        lambda: PagedServingEngine(model, params, **kw),
        [np.arange(1, 6, dtype=np.int32) + i for i in range(2)])
    trace = cluster_trace(cfg.vocab_size, kw["max_len"], interval)
    top = decode_topology(cfg, kw["max_len"], kw["max_batch"],
                          CLUSTER_REPLICAS, cm)
    out, failures = {}, []
    for policy in ("round_robin", "cost_aware"):
        clock = SimClock()
        cl = ServingCluster.build(model, params,
                                  n_replicas=CLUSTER_REPLICAS,
                                  policy=policy, clock=clock, cost_model=cm,
                                  shed_wait_s=30.0, **kw)
        reset_launches()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        t_run = time.perf_counter()
        try:
            admitted = serve_trace(cl, trace, clock, min_dt=interval / 4,
                                   max_ticks=50_000)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        if cuda:
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        counts = launch_counts()
        # on the CPU the wrapper runs its plain version: nothing to count
        failures += [f"{policy}: {b}" for b in cluster_gates(
            cl, admitted, cfg.vocab_size, cfg.n_layers,
            counts["paged_attention"] if cuda else None)]
        st = cl.stats
        out[policy] = dict(
            trace_summary(cl, admitted, clock, len(trace)),
            virtual_s=clock.t, host_run_s=run_s,
            front_requeues=st.front_requeues, routed=list(st.routed),
            replicas=[{"steps": e.stats.steps,
                       "host_syncs": e.stats.host_syncs,
                       "decode_dispatches": e.stats.decode_dispatches,
                       "prefill_chunks": e.stats.prefill_chunks,
                       "preemptions": e.stats.preemptions,
                       "peak_blocks": e.stats.peak_blocks_in_use}
                      for e in cl.replicas],
            paged_attention_launches=counts["paged_attention"])
        del cl
        if cuda:
            torch.cuda.empty_cache()
    line = {"arch": cfg.name, "layers": cfg.n_layers, "engine": kw,
            "arrival_gap_s": interval / CLUSTER_LOAD,
            "trace": {"requests": len(trace),
                      "prompt_tokens": sorted({len(a[1]) for a in trace}),
                      "new_tokens": sorted({a[2] for a in trace})},
            "topology": top.describe(), "policies": out}
    return line, failures


def cluster_chaos(make, trace, fault):
    """(c) One fault on replica 0 of a 2-replica cluster of real engines
    (``make(clock)``), built from ``ServingCluster``, ``FaultPlan.wrap``
    and ``ChaosSupervisor`` under a ``SimClock`` priced by the drill's
    unit prices, against the fault-free twin of the same trace.  Returns
    (reading, failures)."""
    from repro_torch.serve.chaos import ChaosSupervisor, FaultPlan, FaultSpec
    from repro_torch.serve.chaos.drill import _drive
    from repro_torch.serve.cluster import ServingCluster, unit_latency
    from repro_torch.serve.sim import SimClock

    clock0 = SimClock()
    twin = ServingCluster([make(clock0) for _ in range(CLUSTER_REPLICAS)])
    twin_adm = _drive(twin, trace, clock0, supervisor=None, max_ticks=600)
    want = {k: list(twin.done[c].tokens) for c, k in twin_adm.items()}

    plan = FaultPlan((FaultSpec(fault, 0, CHAOS_AT_STEP),))
    clock = SimClock()
    reps = [plan.wrap(make(clock), i, 0, clock=clock)
            for i in range(CLUSTER_REPLICAS)]
    cl = ServingCluster(reps)
    sup = ChaosSupervisor(
        cl, clock, step_seconds=unit_latency(*CHAOS_PRICES),
        engine_factory=lambda i, gen, ctl: plan.wrap(make(clock), i, gen,
                                                     clock=clock),
        heartbeat_interval_s=1.0, miss_limit=3,
        straggler_abs_limit_s=4.0 * (CHAOS_PRICES[0] + CHAOS_PRICES[2]),
        retry_budget=3, resubmit_backoff_s=0.5)
    router, reclaimed = cl.router, []
    reclaim = router.reclaim_replica

    def spy(i):
        out = reclaim(i)
        reclaimed.extend((crid, len(req.tokens)) for crid, req in out)
        return out
    router.reclaim_replica = spy
    adm = _drive(cl, trace, clock, supervisor=sup, max_ticks=600)
    got = {adm[c]: list(q.tokens) for c, q in router.done.items()
           if c in adm}
    bad = []
    if any(got[k] != want[k] for k in got if k in want):
        bad.append("survivors' tokens differ from the twin's")
    lost = sum(max(0, len(want[k]) - len(t)) for k, t in got.items()
               if k in want)
    if lost:
        bad.append(f"{lost} tokens lost")
    if len(got) + router.stats.abandoned < len(adm):
        bad.append(f"{len(got)} completed + {router.stats.abandoned} "
                   f"abandoned < {len(adm)} admitted")
    try:
        router.assert_drained()
    except AssertionError as e:
        bad.append(str(e))
    for j in router.live_indices():
        alloc = cl.replicas[j].allocator
        try:
            alloc.check()
        except AssertionError as e:
            bad.append(f"replica {j}: {e}")
        if alloc.n_in_use:
            bad.append(f"replica {j}: {alloc.n_in_use} blocks leaked")
    kinds = sorted({f.kind for f in sup.failures})
    if not sup.failures:
        bad.append("no failure detected")
    integrity = reps[0].stats.integrity_failures
    if fault == "corrupt":
        if integrity != 1:
            bad.append(f"{integrity} integrity failures on the poisoned "
                       f"replica, not 1")
        lost_crids = [c for c, _ in reclaimed if c not in router.done]
        if not reclaimed or lost_crids:
            bad.append(f"the poisoned replica's requests not recovered "
                       f"({len(reclaimed)} reclaimed, {lost_crids} lost)")
    return {"admitted": len(adm), "completed": len(got),
            "failures": len(sup.failures), "kinds": kinds,
            "integrity_failures": integrity,
            "reclaimed": len(reclaimed),
            "reclaimed_tokens": sum(n for _, n in reclaimed),
            "recovered": router.stats.recovered,
            "abandoned": router.stats.abandoned,
            "live_replicas": len(router.live_indices()),
            "recovery_s": max([f.recovery_s for f in sup.failures
                               if f.recovery_s is not None] or [0.0]),
            "virtual_s": clock.t}, bad


def cluster_reduced(torch, np, seed, dev="cuda"):
    """(c) Reduced f32 gemma2 (2 layers, vocab 128) on ``dev``: the skewed
    trace with the long prompts cut to max_len 64, under a ``SimClock``
    priced by the drill's unit prices, must give identical tokens under
    round-robin and cost-aware placement, and a 1-replica cluster the
    bare engine's; then ``crash`` and ``corrupt`` on real replicas against
    the fault-free twin (``cluster_chaos``), and ``CLUSTER_MUST_CATCH``.
    Returns (readings, failures, {control: what caught it})."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.costmodel import CostModel
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.cluster import (ServingCluster, serve_trace,
                                           unit_latency)
    from repro_torch.serve.cluster.traffic import tokens_by_index
    from repro_torch.serve.engine import PagedServingEngine
    from repro_torch.serve.sim import SimClock

    cfg = reduced(get_config("gemma2-2b"), n_layers=2, vocab_size=128,
                  compute_dtype="float32")
    model = build_model(cfg, device=dev)
    params = params_to(build_model(cfg, device="cpu").init(seed), dev)
    cm = CostModel.from_named("hopper_h100")
    kw = dict(max_batch=4, max_len=64, block_size=8, chunk_size=8,
              n_blocks=cluster_pool(4, 64, 8))
    trace = cluster_trace(cfg.vocab_size, kw["max_len"])
    gap = 1.0 / CLUSTER_LOAD

    def make(clock):
        return PagedServingEngine(model, params, clock=clock, cost_model=cm,
                                  **kw)

    def serve(policy, n_replicas=CLUSTER_REPLICAS):
        clock = SimClock()
        cl = ServingCluster.build(model, params, n_replicas=n_replicas,
                                  policy=policy, clock=clock, cost_model=cm,
                                  **kw)
        admitted = serve_trace(cl, trace, clock,
                               step_seconds=unit_latency(*CHAOS_PRICES),
                               min_dt=0.25)
        return cl, admitted
    failures, readings, toks = [], {}, {}
    for policy in ("round_robin", "cost_aware"):
        cl, admitted = serve(policy)
        toks[policy] = tokens_by_index(cl, admitted, gap)
        readings[policy] = {"reroutes": cl.stats.reroutes,
                            "preemptions": [e.stats.preemptions
                                            for e in cl.replicas]}
        failures += [f"{policy}: {b}"
                     for b in cluster_gates(cl, admitted, cfg.vocab_size)]
    one, admitted = serve("cost_aware", 1)
    toks["one"] = tokens_by_index(one, admitted, gap)
    bare = make(SimClock())
    rids = [bare.submit(np.asarray(p, np.int32), max_new_tokens=new,
                        eos_id=eos) for _, p, new, eos in trace]
    bare.run_until_done()
    toks["bare"] = {i: list(bare.done[r].tokens) for i, r in enumerate(rids)}
    if len(toks["round_robin"]) != len(trace):
        failures.append("not every request completed")
    if toks["round_robin"] != toks["cost_aware"]:
        failures.append("tokens differ between policies")
    if toks["one"] != toks["bare"]:
        failures.append("1-replica cluster tokens differ from the bare "
                        "engine's")
    readings["distinct_tokens"] = len({t for r in toks["bare"].values()
                                       for t in r})
    for fault in ("crash", "corrupt"):
        readings[fault], bad = cluster_chaos(make, trace, fault)
        failures += [f"{fault}: {b}" for b in bad]
    caught = {}
    with cluster_fault("leaked_origin"):
        cl, admitted = serve("cost_aware")
    caught["leaked_origin"] = [b for b in cluster_gates(
        cl, admitted, cfg.vocab_size) if "leaked after drain" in b]
    with cluster_fault("unseen_poison"):
        _, bad = cluster_chaos(make, trace, "corrupt")
    caught["unseen_poison"] = [b for b in bad if "integrity" in b]
    with cluster_fault("dropped_reclaim"):
        _, bad = cluster_chaos(make, trace, "crash")
    caught["dropped_reclaim"] = [b for b in bad if "twin" in b or "lost" in b]
    return readings, failures, caught


def phase_cluster(torch, np, dev, seed, card):
    """The serving cluster and the chaos tier on the card: (a) the sim tier
    with the fake model's tensors on the card, equal to the CPU's dicts;
    (b) two full-width paged replicas over phase serve's weights serving
    the skewed trace under each policy (``cluster_live``); (c) reduced f32
    token parity and chaos on real replicas (``cluster_reduced``), and
    ``CLUSTER_MUST_CATCH``."""
    from repro_torch.core.costmodel import CostModel

    failures = []
    want = cluster_sim("cpu")
    got = cluster_sim(dev)
    failures += [f"sim on the card: {k} differs"
                 for k in scenario_gate(got, want)]
    failures += [f"sim: {b}" for b in cluster_sim_gates(got)]

    cfg, model, params, _ = serve_setup(np, dev, seed)
    live, bad = cluster_live(
        torch, model, params,
        dict(max_batch=4, max_len=1024, block_size=16, chunk_size=64),
        CostModel.from_named("hopper_h100"))
    failures += bad
    del model, params
    torch.cuda.empty_cache()

    reduced_line, bad, caught = cluster_reduced(torch, np, seed, dev)
    failures += [f"reduced {b}" for b in bad]
    missed = [n for n in CLUSTER_MUST_CATCH if not caught[n]]
    emit({"phase": "cluster", "nvidia_smi": card,
          "sim": {k: {f: v for f, v in res.items() if f != "tokens"}
                  for k, res in got.items()},
          **live, "reduced": reduced_line,
          "controls": {n: {"caught": bool(c), "by": c[:2]}
                       for n, c in caught.items()}})
    if failures or missed:
        raise AssertionError(f"cluster gates failed: {failures}; "
                             f"controls missed: {missed}")

def timed_once(torch, fn):
    """One call of ``fn`` between a CUDA event pair: (result, ms)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


NO_LIBRARY = ("no PyTorch call computes the recurrence in one call "
              "(it is a serial scan, not a product or an attention)")
# recurrence kernel vs plain version, relative to the output's scale: f32
# differs in summation order only; bf16 outputs by up to one bf16 ulp
REC_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# ... and in bf16 at most this share of outputs not bit-equal to the plain
# version's: 0.016% (wkv6) and 0.013% (ssm_scan) at the eval shapes, where
# the f32 decay staged in bf16 reads 49% and 41% and stays inside REC_TOL
REC_MISMATCH_BF16 = 0.01


def _check_close(torch, out, want):
    """|out - want| <= tol * (|want| + max|want|), tol by out's dtype, and
    in bf16 at most ``REC_MISMATCH_BF16`` of the outputs not bit-equal;
    returns the largest absolute error."""
    tol = REC_TOL[str(out.dtype).split(".")[-1]]
    if out.dtype == torch.bfloat16:
        share = _mismatch(torch, out, want)
        if share > REC_MISMATCH_BF16:
            raise AssertionError(f"{share:.2%} of bf16 outputs differ from "
                                 f"the plain version's")
    out, want = out.float(), want.float()
    torch.testing.assert_close(out, want, rtol=tol,
                               atol=tol * want.abs().max().item())
    return (out - want).abs().max().item()


def _mismatch(torch, out, want):
    """The share of outputs not bit-equal to the plain version's."""
    return (out != want).float().mean().item()


def _late(torch, t):
    """``t`` [B, S, ...] read one step late: step s sees step s-1's."""
    return torch.cat([t[:, :1], t[:, :-1]], dim=1)


def _bf16(torch, t):
    return t.to(torch.bfloat16).float()


def _kernel_controls(torch, want, faults):
    """The kernel phase's checks beside faults (bf16 ``want``): each
    fault's output (the plain version with one input changed) against
    ``want``, as the largest |out - want| / (tol (|want| + max|want|)) and
    the share of outputs not bit-equal.  Every fault must be caught."""
    tol = REC_TOL["bfloat16"]
    scale = tol * (want.float().abs() + want.float().abs().max())
    out = {}
    for name, fn in faults.items():
        got = fn()
        ratio = ((got.float() - want.float()).abs() / scale).max().item()
        share = _mismatch(torch, got, want)
        out[name] = {"tol_ratio": ratio, "mismatch": share,
                     "caught": ratio > 1 or share > REC_MISMATCH_BF16}
    missed = [n for n, c in out.items() if not c["caught"]]
    if missed:
        raise AssertionError(f"kernel checks miss {missed}: {out}")
    return out


# the wkv6 kernel's input cases: r, k, v, u scaled by 0.3 and a decay w of
# "short" (w in [0.7, 0.999], the reference sweep's), "long" (w = exp(-exp(x)), x in
# [-9, -5]: w in [0.9933, 0.99988], a state carries over thousands of
# steps, as the model's w_base of -6 gives) and "fast" (x in [-1, 2.5]: w
# in [5e-6, 0.69], where a design that divides by a cumulative decay breaks)
WKV_CASES = {"short": dict(w=(0.7, 0.999), log_log=False),
             "long": dict(w=(-9.0, -5.0), log_log=True),
             "fast": dict(w=(-1.0, 2.5), log_log=True)}
# rows of the state one thread of the kernel keeps (csrc/wkv6.cu kTileR)
WKV_TILE_ROWS = 4
# the recurrence gate's fault controls, each the plain version with one
# fault, and the case where it shows: w read one step late, w rounded to
# bf16, the bonus term left out (a_t = 0), every head reading head 0's u,
# the state zeroed every 256 steps, and one thread's share of the rows
# (the last WKV_TILE_ROWS) left out of y's sum
WKV_MUST_CATCH = {"w_late": "short", "w_bf16": "short", "u_dropped": "fast",
                  "u_head0": "short", "carry_dropped": "long",
                  "rows_dropped": "long"}


def wkv_inputs(torch, g, dev, B, S, H, N, dtype, case):
    """Seeded inputs of ``WKV_CASES[case]``: r, k, v, w (f32), u."""
    c = WKV_CASES[case]
    lo, hi = c["w"]
    r, k, v = (torch.randn((B, S, H, N), generator=g, device=dev)
               .mul(0.3).to(dtype) for _ in range(3))
    w = torch.rand((B, S, H, N), generator=g, device=dev) * (hi - lo) + lo
    if c["log_log"]:
        w = torch.exp(-torch.exp(w))
    u = torch.randn((H, N), generator=g, device=dev).mul(0.3).to(dtype)
    return r, k, v, w, u


def wkv_fault(torch, ref, name, r, k, v, w, u):
    """The plain version with fault ``name`` (``WKV_MUST_CATCH``)."""
    f = ref.wkv6_plain
    if name == "w_late":
        return f(r, k, v, _late(torch, w), u)
    if name == "w_bf16":
        return f(r, k, v, _bf16(torch, w), u)
    if name == "u_dropped":
        return f(r, k, v, w, torch.zeros_like(u))
    if name == "u_head0":
        return f(r, k, v, w, u[:1].expand_as(u).contiguous())
    if name == "carry_dropped":
        return torch.cat([f(*(t[:, s:s + 256] for t in (r, k, v, w)), u)
                          for s in range(0, r.shape[1], 256)], dim=1)
    if name == "rows_dropped":
        # y less the r.S sum of those rows alone (u = 0 keeps the bonus
        # term whole), in f32 and rounded once
        rows = torch.zeros_like(r, dtype=torch.float32)
        rows[..., -WKV_TILE_ROWS:] = r[..., -WKV_TILE_ROWS:]
        k, v, u = k.float(), v.float(), u.float()
        return (f(r.float(), k, v, w, u)
                - f(rows, k, v, w, torch.zeros_like(u))).to(r.dtype)
    raise KeyError(name)


def wkv_bound(B, S, H, N, elem=2):
    """(ms, by) for the recurrence: r, k, v, w, u read and y written once;
    5 N^2 + 5 N f32 operations a (row, step, head): r.S 2 N^2, S <- w S +
    k v^T 3 N^2 (product, FMA), r.(u k) 3 N and a_t v 2 N."""
    n = B * S * H * N
    nbytes = n * (3 * elem + 4 + elem) + H * N * elem
    return _bound(nbytes, (5 * N * N + 5 * N) * B * S * H, F32_OPS_PER_S)


def phase_wkv6_kernel(torch, dev, seed):
    """The wkv6 kernel against its plain version: the sweep's shapes in
    f32, then the eval shape in bf16 in each case of ``WKV_CASES``, each
    beside the ``WKV_MUST_CATCH`` controls that show on it, with times;
    then "long" and "fast" in f32 on one row."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(seed)
    max_err = 0.0
    for H, N in ((2, 32), (4, 64)):
        args = wkv_inputs(torch, g, dev, 2, 24, H, N, torch.float32, "short")
        err = _check_close(torch, ops.wkv6(*args), ref.wkv6_plain(*args))
        max_err = max(max_err, err)
        emit({"phase": "wkv6_kernel", "B": 2, "S": 24, "H": H, "N": N,
              "dtype": "float32", "max_abs_err": err})
    B, S, H, N = 4, 4096, 32, 64
    bound, bound_by = wkv_bound(B, S, H, N)
    cases = {}
    for case in WKV_CASES:
        args = wkv_inputs(torch, g, dev, B, S, H, N, torch.bfloat16, case)
        want, plain_ms = timed_once(torch, lambda: ref.wkv6_plain(*args))
        controls = _kernel_controls(torch, want, {
            name: (lambda name=name: wkv_fault(torch, ref, name, *args))
            for name, at in WKV_MUST_CATCH.items() if at == case})
        out = ops.wkv6(*args)
        torch.cuda.synchronize()
        err = _check_close(torch, out, want)
        max_err = max(max_err, err)
        c = {"case": case, "B": B, "S": S, "H": H, "N": N,
             "dtype": "bfloat16",
             "block_h": ops.divisor_clamp(
                 ops.KERNEL_DEFAULTS["wkv6"]["block_h"], H),
             "max_abs_err": err, "mismatch": _mismatch(torch, out, want),
             "ms": gpu_ms(torch, lambda: ops.wkv6(*args), 10),
             "stream_ms": stream_ms(torch, lambda: ops.wkv6(*args)),
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
             "library_ms": None, "library": NO_LIBRARY,
             "max_abs_out": want.float().abs().max().item(),
             "controls": controls}
        emit({"phase": "wkv6_kernel", **c})
        cases[case] = c
        del args, want, out
    # f32 shows what bf16's rounding hides: a state carried over thousands
    # of steps, and one that decays within a few
    for case in ("long", "fast"):
        args = wkv_inputs(torch, g, dev, 1, S, H, N, torch.float32, case)
        err = _check_close(torch, ops.wkv6(*args), ref.wkv6_plain(*args))
        max_err = max(max_err, err)
        emit({"phase": "wkv6_kernel", "case": case, "B": 1, "S": S, "H": H,
              "N": N, "dtype": "float32", "max_abs_err": err})
        del args
    return cases["short"], max_err


# the selective scan's input cases: "sweep" (the reference tests' scales),
# "eval" (unit-scale x, B, C as the model's; A = -exp(a_log) of
# init_mamba, the same row for every channel; dt in [0.001, 0.1]) and
# "long" (A drawn for each channel; dt in [1e-4, 2e-3], so a state carries
# over thousands of steps)
SSM_CASES = {"sweep": dict(std=0.2, dt=(0.001, 0.1), model_a=False),
             "eval": dict(std=1.0, dt=(0.001, 0.1), model_a=True),
             "long": dict(std=1.0, dt=(1e-4, 2e-3), model_a=False)}
# the scan gate's fault controls, each the plain version with one fault,
# and the case where it shows: dt or B read one step late, dt rounded to
# bf16, every channel reading channel 0's A, the state zeroed every 256
# steps, and the last state's term left out of y
SSM_MUST_CATCH = {"dt_late": "eval", "B_late": "eval", "dt_bf16": "eval",
                  "A_row0": "long", "carry_dropped": "long",
                  "C_last_dropped": "long"}


def ssm_inputs(torch, g, dev, Bt, S, Di, N, dtype, case):
    """Seeded inputs of ``SSM_CASES[case]``: x, dt, B, C, A."""
    c = SSM_CASES[case]
    lo, hi = c["dt"]
    x = torch.randn((Bt, S, Di), generator=g, device=dev).mul(c["std"])
    dt = torch.rand((Bt, S, Di), generator=g, device=dev) * (hi - lo) + lo
    B, C = (torch.randn((Bt, S, N), generator=g, device=dev).mul(c["std"])
            .to(dtype) for _ in range(2))
    if c["model_a"]:                     # -exp(a_log) of init_mamba
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=dev).repeat(Di, 1)
    else:
        A = -torch.randn((Di, N), generator=g, device=dev).abs()
    return x.to(dtype), dt, B, C, A


def ssm_fault(torch, ref, name, x, dt, B, C, A):
    """The plain version with fault ``name`` (``SSM_MUST_CATCH``)."""
    f = ref.ssm_scan_plain
    if name == "dt_late":
        return f(x, _late(torch, dt), B, C, A)
    if name == "B_late":
        return f(x, dt, _late(torch, B), C, A)
    if name == "dt_bf16":
        return f(x, _bf16(torch, dt), B, C, A)
    if name == "A_row0":
        return f(x, dt, B, C, A[:1].expand_as(A).contiguous())
    if name == "carry_dropped":
        return torch.cat([f(*(t[:, s:s + 256] for t in (x, dt, B, C)), A)
                          for s in range(0, x.shape[1], 256)], dim=1)
    if name == "C_last_dropped":
        C = C.clone()
        C[..., -1] = 0
        return f(x, dt, B, C, A)
    raise KeyError(name)


def ssm_bound(Bt, S, Di, N, elem=2):
    """(ms, by) for the scan: x, dt, B, C, A read and y written once; 6 N + 1
    f32 operations a (row, step, channel) besides the N exponentials."""
    n = Bt * S * Di
    nbytes = n * (elem + 4 + elem) + 2 * Bt * S * N * elem + Di * N * 4
    return _bound(nbytes, n * (6 * N + 1), F32_OPS_PER_S, exps=n * N)


def ssm_sass():
    """Each built ssm_scan instance's instruction count, MUFU.EX2 count
    and top opcodes (``_build.sass_mix``), or why there is none."""
    from repro_torch.kernels import _build
    try:
        mix = _build.sass_mix("ssm_scan", top=100)
    except (RuntimeError, OSError) as e:
        return {"unavailable": str(e)[:200]}
    return {fn: {**m, "mufu_ex2": m["top"].get("MUFU.EX2", 0)}
            for fn, m in mix.items()}


def phase_ssm_kernel(torch, dev, seed):
    """The ssm_scan kernel against its plain version: the sweep's shapes
    in f32 and bf16, then two eval-shape cases in bf16 ("eval" and "long"
    of ``SSM_CASES``), each beside the ``SSM_MUST_CATCH`` controls that
    show on it, with times; then "long" in f32 on one row."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(seed)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for Di, N, block in ((256, 8, 128), (512, 16, 256)):
            args = ssm_inputs(torch, g, dev, 2, 32, Di, N, dtype, "sweep")
            out = ops.ssm_scan(*args, block_d=block)
            torch.cuda.synchronize()
            err = _check_close(torch, out, ref.ssm_scan_plain(*args))
            max_err = max(max_err, err)
            emit({"phase": "ssm_kernel", "Bt": 2, "S": 32, "Di": Di, "N": N,
                  "block_d": block, "dtype": str(dtype).split(".")[-1],
                  "max_abs_err": err})
    Bt, S, Di, N = 4, 4224, 1600, 16
    bound, bound_by = ssm_bound(Bt, S, Di, N)
    cases = {}
    for case in ("eval", "long"):
        args = ssm_inputs(torch, g, dev, Bt, S, Di, N, torch.bfloat16, case)
        want, plain_ms = timed_once(torch, lambda: ref.ssm_scan_plain(*args))
        controls = _kernel_controls(torch, want, {
            name: (lambda name=name: ssm_fault(torch, ref, name, *args))
            for name, at in SSM_MUST_CATCH.items() if at == case})
        out = ops.ssm_scan(*args)
        torch.cuda.synchronize()
        err = _check_close(torch, out, want)
        max_err = max(max_err, err)
        c = {"case": case, "Bt": Bt, "S": S, "Di": Di, "N": N,
             "dtype": "bfloat16", "block_d": ops.divisor_clamp(256, Di),
             "max_abs_err": err, "mismatch": _mismatch(torch, out, want),
             "ms": gpu_ms(torch, lambda: ops.ssm_scan(*args), 10),
             "stream_ms": stream_ms(torch, lambda: ops.ssm_scan(*args)),
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
             "library_ms": None, "library": NO_LIBRARY,
             "max_abs_out": want.float().abs().max().item(),
             "controls": controls}
        emit({"phase": "ssm_kernel", **c})
        cases[case] = c
        del args, want, out
    # a bias of the exponential accumulates over the steps a slowly
    # decaying state carries: the long case in f32, one row
    args = ssm_inputs(torch, g, dev, 1, S, Di, N, torch.float32, "long")
    err = _check_close(torch, ops.ssm_scan(*args), ref.ssm_scan_plain(*args))
    max_err = max(max_err, err)
    emit({"phase": "ssm_kernel", "case": "long", "Bt": 1, "S": S, "Di": Di,
          "N": N, "dtype": "float32", "max_abs_err": err})
    del args
    emit({"phase": "ssm_kernel", "sass": ssm_sass()})
    return cases["eval"], max_err


# --- phases wkv6_bwd_kernel and ssm_bwd_kernel --------------------------------

# the recurrences' backward kernels against their plain versions in f64,
# each gradient's max |got - want| over its max|want|: in f32 the sums run
# in another order (FLASH_BWD_TOL's f32 gate); in bf16 dr, dk, dv (dx, dB,
# dC) are rounded once to bf16, 2^-9 of a value
REC_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the train path's shapes: one micro-batch of 2 rows (TRAIN_RECURRENT)
WKV_BWD_TRAIN = dict(B=2, S=4096, H=32, N=64)
SSM_BWD_TRAIN = dict(Bt=2, S=4224, Di=1600, N=16)
# the faults the f32 gate must catch on the f32 B=1 run of the case named:
# G's update decayed by w_{t-1} in place of w_t; dw read from S_t in place
# of S_{t-1}; u's term dropped from dk; the last column group's partial
# dropped from dr; and in the segment split (csrc/wkv6_bwd.cu's passes,
# ref.wkv6_bwd_local / wkv6_bwd_combine / wkv6_bwd_parts): the middle
# segment's start state not carried (zero), every segment's decay product
# left out of the combine (taken as 1), and the middle segment's end
# cotangent not carried (zero)
WKV_BWD_MUST_CATCH = {"g_decay_late": "fast", "dw_from_s_t": "fast",
                      "u_dropped_from_dk": "fast",
                      "dr_block_dropped": "long",
                      "seg_start_dropped": "long",
                      "seg_decay_dropped": "long",
                      "seg_g_end_dropped": "long"}
# ... and for the scan: G_t = dy_t C_t + a_t G_{t+1} (a one step late in
# the reverse walk); the last channel group's partial dropped from dB; the
# last row's partial dropped from dA; the middle chunk-boundary state
# zeroed (csrc/ssm_scan_bwd.cu's split, ref.ssm_scan_bwd_parts)
SSM_BWD_MUST_CATCH = {"a_late_in_reverse": "eval",
                      "dB_group_dropped": "eval", "dA_row_dropped": "eval",
                      "boundary_zeroed": "long"}


def _in_order(parts):
    """The partials added in order, as the fold kernels add them."""
    return sum(parts[1:], parts[0])


def wkv_bwd_g_late(torch, r, k, v, w, u, dy):
    """The wkv6 backward written out again (every state kept) with G's
    update reading w one step late: G_{t-1} = diag(w_{t-1}) G_t + r_t dy_t^T
    (``g_decay_late``)."""
    wl = _late(torch, w)
    s = torch.zeros(r.shape[:1] + r.shape[2:] + r.shape[-1:], dtype=r.dtype,
                    device=r.device)
    states = []
    for t in range(r.shape[1]):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    G = torch.zeros_like(s)
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    for t in reversed(range(r.shape[1])):
        sp = states[t]
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dy[:, t])
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, v[:, t])
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, k[:, t])
        dw[:, t] = (G * sp).sum(-1)
        G = wl[:, t, :, :, None] * G + r[:, t, :, :, None] * dy[:, t, :, None, :]
    vdy = (v * dy).sum(-1, keepdim=True)
    return (dr + u * k * vdy, dk + u * r * vdy,
            dv + (r * u * k).sum(-1, keepdim=True) * dy, dw,
            (r * k * vdy).sum((0, 1)))


def wkv_bwd_fault(torch, ref, name, r, k, v, w, u, dy):
    """The plain wkv6 backward with fault ``name`` (``WKV_BWD_MUST_CATCH``)."""
    from repro_torch.kernels.wkv6 import BWD_CHUNK, BWD_GROUP, BWD_SEG
    if name == "g_decay_late":
        return wkv_bwd_g_late(torch, r, k, v, w, u, dy)
    split = dict(cols=BWD_GROUP, chunk=BWD_CHUNK, seg=BWD_SEG)
    if name == "dr_block_dropped":
        p = ref.wkv6_bwd_parts(r, k, v, w, u, dy, **split)
        p["dr"] = p["dr"][:-1]
        return ref.wkv6_bwd_sum(p, r, w, u)
    if name.startswith("seg_"):
        local = ref.wkv6_bwd_local(r, k, v, w, dy, seg=BWD_SEG)
        if name == "seg_decay_dropped":
            local = [(s, g, torch.ones_like(p)) for s, g, p in local]
        starts, ends = ref.wkv6_bwd_combine(local)
        mid = len(starts) // 2
        if name == "seg_start_dropped":
            starts[mid] = torch.zeros_like(starts[mid])
        elif name == "seg_g_end_dropped":
            ends[mid - 1] = torch.zeros_like(ends[mid - 1])
        elif name != "seg_decay_dropped":
            raise KeyError(name)
        return ref.wkv6_bwd_sum(ref.wkv6_bwd_parts(
            r, k, v, w, u, dy, **split, bounds=(starts, ends)), r, w, u)
    dr, dk, dv, dw, du = ref.wkv6_bwd_plain(r, k, v, w, u, dy)
    bonus = u * r * (v * dy).sum(-1, keepdim=True)
    if name == "u_dropped_from_dk":
        return dr, dk - bonus, dv, dw, du
    if name == "dw_from_s_t":
        # S_t = diag(w_t) S_{t-1} + k_t v_t^T, so sum_j G_t S_t is
        # w_t dw_t + k_t (G_t v_t), G_t v_t being dk_t less the bonus
        return dr, dk, dv, w * dw + k * (dk - bonus), du
    raise KeyError(name)


def ssm_bwd_written_out(torch, x, dt, B, C, A, dy, fault):
    """The scan's backward written out again over the kernel's chunks
    with fault ``a_late_in_reverse`` (G_t = dy_t C_t + a_t G_{t+1}) or
    ``boundary_zeroed`` (the middle chunk's boundary state zeroed)."""
    from repro_torch.kernels.ssm_scan import BWD_CHUNK
    Bt, S, Di = x.shape
    h = torch.zeros((Bt, Di, A.shape[1]), dtype=x.dtype, device=x.device)
    bounds = []
    for t in range(S):
        if t % BWD_CHUNK == 0:
            bounds.append(h)
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :])
    if fault == "boundary_zeroed":
        bounds[len(bounds) // 2] = torch.zeros_like(h)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA = torch.zeros_like(h)
    G, a_next = torch.zeros_like(h), torch.ones_like(h)
    for c in reversed(range(len(bounds))):
        steps = range(c * BWD_CHUNK, min(S, (c + 1) * BWD_CHUNK))
        hs, h = [], bounds[c]
        for t in steps:
            a = torch.exp(dt[:, t, :, None] * A)
            hs.append((h, a))
            h = a * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
            dC[:, t] = torch.einsum("bdn,bd->bn", h, dy[:, t])
        for t in reversed(steps):
            hp, a = hs[t - steps[0]]
            late = a if fault == "a_late_in_reverse" else a_next
            G = dy[:, t, :, None] * C[:, t, None, :] + late * G
            gB = torch.einsum("bdn,bn->bd", G, B[:, t])
            gah = G * a * hp
            dx[:, t] = dt[:, t] * gB
            ddt[:, t] = x[:, t] * gB + (gah * A).sum(-1)
            dA += gah * dt[:, t, :, None]
            dB[:, t] = torch.einsum("bdn,bd->bn", G, dt[:, t] * x[:, t])
            a_next = a
    return dx, ddt, dB, dC, dA.sum(0)


def ssm_bwd_fault(torch, ref, name, x, dt, B, C, A, dy):
    """The plain scan backward with fault ``name`` (``SSM_BWD_MUST_CATCH``)."""
    from repro_torch.kernels.ssm_scan import BWD_CHUNK, BWD_GROUP
    if name in ("a_late_in_reverse", "boundary_zeroed"):
        return ssm_bwd_written_out(torch, x, dt, B, C, A, dy, name)
    p = ref.ssm_scan_bwd_parts(x, dt, B, C, A, dy, group=BWD_GROUP,
                               chunk=BWD_CHUNK)
    dB, dA = p["dB"], p["dA"]
    if name == "dB_group_dropped":
        dB = dB[:-1]
    elif name == "dA_row_dropped":
        dA = dA[:-1] or [torch.zeros_like(dA[0])]
    else:
        raise KeyError(name)
    return (p["dx"], p["ddt"], _in_order(dB), _in_order(p["dC"]),
            _in_order(dA))


def wkv_bwd_bound(B, S, H, N, elem=2):
    """(ms, by) for the wkv6 gradient: r, k, v, dy, w, u read and dr, dk,
    dv, dw, du written once; 14 N^2 + 16 N f32 operations a (row, step,
    head): S_{t-1} (k v^T, w S + k v^T) 3 N^2, G's update 3 N^2, the sums
    S dy, G v, G^T k and G o S 8 N^2; v . dy 2 N, a_t 3 N, the bonus
    terms of dr, dk, dv 8 N, du 3 N."""
    n = B * S * H * N
    nbytes = n * (7 * elem + 8) + H * N * 8
    return _bound(nbytes, (14 * N * N + 16 * N) * B * S * H, F32_OPS_PER_S)


def ssm_bwd_bound(Bt, S, Di, N, elem=2):
    """(ms, by) for the scan's gradient: x, dt, dy, B, C, A read and dx,
    ddt, dB, dC, dA written once; one exponential a (row, step, channel,
    state) and 18 N + 4 f32 operations a (row, step, channel): h_t 3 N,
    G_t 3 N, G . B 2 N, G a h_{t-1} and its A-weighted sum 4 N, dA 2 N,
    dB and dC with their channel sums 4 N; dt x, dx, ddt 4."""
    n = Bt * S * Di
    nbytes = n * (3 * elem + 8) + 4 * Bt * S * N * elem + Di * N * 8
    return _bound(nbytes, n * (18 * N + 4), F32_OPS_PER_S, exps=n * N)


def rec_bwd_run(torch, bwd, plain, counter, args, dy, tol):
    """One backward call against the plain backward in f64: the gradients'
    ratios (``flash_bwd_ratios``), the largest absolute error, a second
    call's bits, the launches counted, and the failed gates."""
    before = counter()
    got = bwd(*args, dy)
    torch.cuda.synchronize()
    launched = counter() - before
    want = plain(*(t.double() for t in args), dy.double())
    ratios = flash_bwd_ratios(got, want)
    err = max((a.double() - b).abs().max().item() for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, bwd(*args, dy)))
    failed = []
    if not max(ratios) <= tol:
        failed.append(f"ratios {ratios} over {tol}")
    if not same:
        failed.append("a second call differs")
    if launched != 1:
        failed.append(f"{launched} launches counted")
    return want, {"ratios": ratios, "max_abs_err": err, "same_bits": same,
                  "dtypes": [str(t.dtype).split(".")[-1] for t in got]}, \
        failed


def rec_bwd_controls(torch, want, faults):
    """Each fault's gradients (f64) against ``want``: its ratios and
    whether the f32 gate catches it."""
    out = {}
    for name, fn in faults.items():
        r = flash_bwd_ratios(fn(), want)
        out[name] = {"ratios": r, "caught": max(r) > REC_BWD_TOL["float32"]}
    return out


def _rec_bwd_phase(torch, dev, seed, phase, runs, inputs, bwd, plain,
                   counter, bound, must_catch, fault):
    """The body of the two backward phases: ``runs`` of (label, shape,
    dtype, case) against ``plain`` in f64, each train-shape bf16 run timed
    beside its bound (the first also the plain backward once, in its own
    f32), the controls of ``must_catch`` on the f32 run of their case.
    Returns the first timed run's line and the largest absolute error."""
    g = torch.Generator(device=dev).manual_seed(seed)
    failed, controls, main, max_err = [], {}, None, 0.0
    for label, shape, dtype, case in runs:
        dname = str(dtype).split(".")[-1]
        args = inputs(torch, g, dev, *shape.values(), dtype, case)
        dy = torch.randn(args[0].shape, generator=g, device=dev).to(dtype)
        want, line, bad = rec_bwd_run(torch, bwd, plain, counter, args, dy,
                                      REC_BWD_TOL[dname])
        failed += [f"{label} {case} {dname}: {b}" for b in bad]
        max_err = max(max_err, line["max_abs_err"])
        line = {"phase": phase, "label": label, "case": case, **shape,
                "dtype": dname, **line}
        if label == "train":
            def call():
                return bwd(*args, dy)
            bms, by = bound(*shape.values())
            line.update(ms=gpu_ms(torch, call, 10),
                        stream_ms=stream_ms(torch, call), bound_ms=bms,
                        bound_by=by, library_ms=None, library=NO_LIBRARY)
            if main is None:
                _, line["plain_ms"] = timed_once(torch,
                                                 lambda: plain(*args, dy))
                main = line
        if dtype == torch.float32 and label == "train_b1":
            want64 = [t.double() for t in args] + [dy.double()]
            controls.update(rec_bwd_controls(torch, want, {
                name: (lambda name=name: fault(name, *want64))
                for name, at in must_catch.items() if at == case}))
        emit(line)
        del args, dy, want
    emit({"phase": phase, "controls": controls})
    failed += [f"control {n} not caught" for n in must_catch
               if not controls.get(n, {}).get("caught")]
    if failed:
        raise AssertionError(f"{phase}: {failed}")
    torch.cuda.empty_cache()
    return main, max_err


def phase_wkv6_bwd_kernel(torch, dev, seed):
    """The wkv6 backward kernel against ``ref.wkv6_bwd_plain`` in f64: phase
    wkv6_kernel's sweep shapes in f32 and bf16, a ragged shape over 16
    segments in f32, the train shape
    (``WKV_BWD_TRAIN``) in bf16 in every case of ``WKV_CASES`` (timed) and
    in f32 at B=1 (with ``WKV_BWD_MUST_CATCH``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
    runs = [("sweep", dict(B=2, S=24, H=H, N=N), dtype, "short")
            for H, N in ((2, 32), (4, 64))
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [("ragged", dict(B=2, S=1000, H=4, N=64), torch.float32, "long")]
    runs += [("train", WKV_BWD_TRAIN, torch.bfloat16, c) for c in WKV_CASES]
    runs += [("train_b1", {**WKV_BWD_TRAIN, "B": 1}, torch.float32, c)
             for c in WKV_CASES]
    return _rec_bwd_phase(torch, dev, seed, "wkv6_bwd_kernel", runs,
                          wkv_inputs, wkv6_bwd, ref.wkv6_bwd_plain,
                          lambda: wkv6.bwd_launches, wkv_bwd_bound,
                          WKV_BWD_MUST_CATCH,
                          lambda *a: wkv_bwd_fault(torch, ref, *a))


def phase_ssm_bwd_kernel(torch, dev, seed):
    """The scan's backward kernel against ``ref.ssm_scan_bwd_plain`` in
    f64: phase ssm_kernel's sweep shapes in f32 and bf16, the train shape
    (``SSM_BWD_TRAIN``) in bf16 in every case of ``SSM_CASES`` (timed) and
    in f32 at Bt=1 (with ``SSM_BWD_MUST_CATCH``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
    runs = [("sweep", dict(Bt=2, S=32, Di=Di, N=N), dtype, "sweep")
            for Di, N in ((256, 8), (512, 16))
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [("train", SSM_BWD_TRAIN, torch.bfloat16, c) for c in SSM_CASES]
    runs += [("train_b1", {**SSM_BWD_TRAIN, "Bt": 1}, torch.float32, c)
             for c in SSM_CASES]
    return _rec_bwd_phase(torch, dev, seed, "ssm_bwd_kernel", runs,
                          ssm_inputs, ssm_scan_bwd, ref.ssm_scan_bwd_plain,
                          lambda: ssm_scan.bwd_launches, ssm_bwd_bound,
                          SSM_BWD_MUST_CATCH,
                          lambda *a: ssm_bwd_fault(torch, ref, *a))


def phase_eval(torch, dev, seed, arch, kernel):
    """Full-width ``arch`` through ``make_eval_step`` on one 4 x 4096
    ``SyntheticLM`` batch (the train_4k cell's per-shard microbatch),
    under sync debugging, with the launch counts zeroed just before; then
    the kernel-vs-plain parity of one 1 x 512 forward."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.train.step import make_eval_step

    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows, seq = cfg.microbatch, 4096
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, rows, seed=seed))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(0).items()}
    step = make_eval_step(model)
    step(params, batch)                      # warm-up: library handles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(params, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = launch_counts()
    # the step's time: EVAL_REPS more steps, each between a CUDA event
    # pair and synchronised (host time included: the events wait for it)
    times = []
    for _ in range(EVAL_REPS):
        _, ms = timed_once(torch, lambda: step(params, batch))
        times.append(ms)
    step_ms = statistics.median(times)
    kernel_ms = _kernel_ms_in_step(torch, step, params, batch, kernel)
    loss = out["loss"].item()
    if not math.isfinite(loss):
        raise AssertionError(f"{arch}: eval loss {loss}")
    if counts[kernel] != cfg.n_layers:
        raise AssertionError(f"{arch}: {counts[kernel]} {kernel} launches in "
                             f"one step != {cfg.n_layers} layers")
    emit({"phase": f"eval_{arch.split('-')[0]}", "arch": arch,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "rows": rows,
          "seq": seq, "positions": seq + cfg.meta_tokens, "loss": loss,
          "ln_vocab": math.log(cfg.vocab_size), "kernel_launches": counts,
          "init_s": init_s, "step_ms": step_ms, "step_ms_min": min(times),
          "step_ms_max": max(times), "step_reps": EVAL_REPS,
          "kernel_ms": kernel_ms,
          "eval_tok_per_s": 1e3 * rows * seq / step_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})

    toks, labels = (batch[k][:1, :512].contiguous()
                    for k in ("tokens", "labels"))
    faults = _faults(torch, arch, params)
    c32 = cfg.replace(compute_dtype="float32")
    p32 = params_to(params, dtype=torch.float32)
    k32 = _forward(torch, c32, p32, toks, labels, {})
    r = _compare(torch, k32, _forward(torch, c32, p32, toks, labels,
                                      _plain_fns()))
    gates = (PARITY_F32_ATOL, PARITY_F32_LOSS_RTOL, None)
    controls = {name: _compare(torch, k32, _forward(torch, c32, p32, toks,
                                                    labels, fns))
                for name, fns in faults.items() if name.endswith("_late")}
    _parity_gates(arch, "float32", r, controls, gates)
    del p32
    # bf16, each forward also against the f32 one on the same weights
    kern = _forward(torch, cfg, params, toks, labels, {})
    r = _compare(torch, kern, _forward(torch, cfg, params, toks, labels,
                                       _plain_fns()), k32)
    gates = (PARITY_BF16_ATOL, LOSS_RTOL, PARITY_BF16_EXCESS)
    controls = {name: _compare(torch, kern, _forward(torch, cfg, params,
                                                     toks, labels, fns), k32)
                for name, fns in faults.items()}
    _parity_gates(arch, "bfloat16", r, controls, gates)
    del kern, k32, model, params, batch
    torch.cuda.empty_cache()
    return counts[kernel]


def _kernel_ms_in_step(torch, step, params, batch, kernel):
    """One more step with a CUDA event pair around each call of
    ``ops.<kernel>`` (the host's share of the call included): the calls,
    their ms summed, and the median call."""
    from repro_torch.kernels import ops

    orig, pairs = getattr(ops, kernel), []

    def timed(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a, **kw)
        e1.record()
        pairs.append((e0, e1))
        return out

    setattr(ops, kernel, timed)
    try:
        step(params, batch)
    finally:
        setattr(ops, kernel, orig)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in pairs]
    return {"calls": len(ms), "sum_ms": sum(ms),
            "median_ms": statistics.median(ms)}


def _plain_fns():
    from repro_torch.kernels import ref
    return {"wkv_fn": ref.wkv6_plain, "ssm_fn": ref.ssm_scan_plain}


def _faults(torch, arch, params):
    """Faulty recurrences for the parity controls, as ``lm_apply``
    keyword arguments: an input read one step late (a staging index off
    by one), the f32 decay rounded to bf16 (staged in the compute dtype)
    and, for rwkv6, ``u`` not rounded to r's dtype (the scan path's)."""
    from repro_torch.kernels import ref

    def late(t):
        return _late(torch, t)

    def bf16(t):
        return _bf16(torch, t)

    if arch.startswith("rwkv6"):
        f = ref.wkv6_plain
        u32 = iter([lp["tmix"]["u_bonus"].float() for lp in params["layers"]])
        return {"k_late": {"wkv_fn": lambda r, k, v, w, u:
                           f(r, late(k), v, w, u)},
                "w_late": {"wkv_fn": lambda r, k, v, w, u:
                           f(r, k, v, late(w), u)},
                "w_bf16": {"wkv_fn": lambda r, k, v, w, u:
                           f(r, k, v, bf16(w), u)},
                "u_f32": {"wkv_fn": lambda r, k, v, w, u:
                          f(r, k, v, w, next(u32))}}
    f = ref.ssm_scan_plain
    return {"B_late": {"ssm_fn": lambda x, dt, B, C, A:
                       f(x, dt, late(B), C, A)},
            "dt_late": {"ssm_fn": lambda x, dt, B, C, A:
                        f(x, late(dt), B, C, A)},
            "dt_bf16": {"ssm_fn": lambda x, dt, B, C, A:
                        f(x, bf16(dt), B, C, A)}}


def _forward(torch, cfg, params, toks, labels, fns):
    """One train-mode forward: (logits over the vocabulary, loss)."""
    from repro_torch.models import transformer as lm_mod
    from repro_torch.models.zoo import cross_entropy

    with torch.no_grad():
        logits, _ = lm_mod.lm_apply(params, cfg, tokens=toks, mode="train",
                                    **fns)
    return logits[..., :cfg.vocab_size], cross_entropy(logits, labels).item()


def _compare(torch, kern, other, truth=None):
    """The kernels' forward against another on the same weights and
    tokens; with ``truth`` (an f32 forward) each also against that."""
    (lk, loss_k), (lp, loss_p) = kern, other
    vs = {}
    if truth is not None:
        for name, lx in (("kernel", lk), ("other", lp)):
            d = (lx.float() - truth[0]).abs()
            vs[f"{name}_vs_f32_max"] = d.max().item()
            vs[f"{name}_vs_f32_mean"] = d.mean().item()
    return {**vs, "finite": bool(torch.isfinite(lk).all().item()),
            "logit_max_abs_diff": (lk - lp).abs().max().item(),
            "logit_mean_abs_diff": (lk - lp).abs().mean().item(),
            "logit_max_abs": lp.abs().max().item(),
            "logit_std": lp.std().item(),
            "loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p)}


def _parity_gates(arch, dtype, r, controls, gates):
    """Emit the parity line; fail if the kernels' forward is past a gate
    or a control in ``MUST_CATCH`` is not.  ``excess`` compares the mean
    distance to the f32 forward with the sound plain version's: the
    kernel's, or the faulty version's for a control."""
    atol, rtol, excess = gates
    base = r.get("other_vs_f32_mean")

    def caught(c, mean_vs_f32):
        c["excess"] = mean_vs_f32 / base if excess else None
        return (not c["finite"] or c["logit_max_abs_diff"] > atol
                or c["loss_rel_diff"] > rtol
                or (excess is not None and c["excess"] > excess))

    bad = caught(r, r.get("kernel_vs_f32_mean"))
    for c in controls.values():
        c["caught"] = caught(c, c.get("other_vs_f32_mean"))
    emit({"phase": "parity_eval", "arch": arch, "dtype": dtype,
          "tokens": 512, **r, "logit_atol": atol, "loss_rtol": rtol,
          "excess_gate": excess, "controls": controls})
    missed = [n for n in MUST_CATCH[arch][dtype] if not controls[n]["caught"]]
    if bad or missed:
        raise AssertionError(f"{arch} {dtype}: kernel vs plain {r}, gates "
                             f"{gates}; controls not caught: {missed}")


def phase_reference_eval(torch, np, seed):
    """Reduced f32 rwkv6 and hymba: the eval loss on the card (kernels)
    and on the CPU (plain versions) must agree to 1e-5 relative."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model
    from repro_torch.train.step import make_eval_step

    out = {}
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        cfg = reduced(get_config(arch), compute_dtype="float32")
        batch = SyntheticLM(DataConfig(cfg.vocab_size, 64, 2,
                                       seed=seed)).batch(0)
        cpu_params = build_model(cfg, device="cpu").init(seed)
        loss = {d: make_eval_step(build_model(cfg, device=d))(
            params_to(cpu_params, d), batch)["loss"].item()
            for d in ("cuda", "cpu")}
        rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        if not rel <= 1e-5:
            raise AssertionError(f"{arch}: card loss {loss['cuda']} vs CPU "
                                 f"{loss['cpu']}")
        out[arch] = {"loss_cuda": loss["cuda"], "loss_cpu": loss["cpu"],
                     "rel_diff": rel}
    emit({"phase": "reference_eval", "tokens": 64, "rows": 2, **out})


# --- phase recurrent_serve ---------------------------------------------------

RECURRENT_ARCHS = ("rwkv6-1.6b", "hymba-1.5b")
# (a): the fused slot engine at full width; 8 prompts of 16-384 tokens
# over 4 rows, so rows are reused and a splice overwrites a row's state
RECURRENT_SERVE = dict(max_batch=4, max_len=1024, n_requests=8, lo=16,
                       hi=384, max_new=8)
# (b): prefill S0 tokens of B rows, then T decode steps
RECURRENT_EQ = dict(B=2, S0=256, T=8)
# (b)'s gate, measured first on the reduced configs on the CPU, seeds
# 0-2, S0 64, T 8 (tests/test_torch_recurrent_serve.py
# ``test_recurrent_equivalence_gate_holds_and_catches_each_control``):
# * logits: the largest |decode - train forward| over the prefill's last
#   position and the T steps, over max(max|train logits|, 1), the
#   reference's scale.  Sound runs: f32 0.00024-0.0016 (the decode reads
#   K/V, token shifts and conv rows stored in bf16, as the reference's
#   does); bf16 0-0.0039; the reference's own bar is 0.05.
# * state: each cache leaf after the T steps against a prefill of all
#   S0+T tokens, the largest |difference| over max|want|.  Sound runs:
#   f32 0.0023-0.0057 (bf16 storage again), bf16 0 on the CPU (the same
#   loops in the same order).
# The controls read 0.10-0.70 on the logits but ``h_not_carried``
# (0.0033-0.0098: the SSM state decays within a step or two and the
# skip path carries most of the output; zeroed before every step, its
# error does not build with T), which only the state gate sees
# (0.23-0.99; every control's state reads 0.22 or more).
RECURRENT_LOGIT_TOL = {"float32": 0.01, "bfloat16": 0.05}
RECURRENT_STATE_TOL = 0.05
# the faults (b)'s gate must catch, each on its arch in both dtypes: a
# state leaf zeroed before every decode step, or hymba decoding at the
# prompt length, as the JAX engine does, instead of meta_tokens + S
RECURRENT_MUST_CATCH = {"wkv_not_carried": "rwkv6-1.6b",
                        "shift_dropped": "rwkv6-1.6b",
                        "conv_dropped": "hymba-1.5b",
                        "h_not_carried": "hymba-1.5b",
                        "meta_offset_dropped": "hymba-1.5b"}
RECURRENT_ZEROED = {"wkv_not_carried": ("wkv",),
                    "shift_dropped": ("tm_shift", "cm_shift"),
                    "conv_dropped": ("conv",), "h_not_carried": ("h",)}
# (c): reduced f32 through the fused and legacy engines, rows reused
RECURRENT_REDUCED = dict(max_batch=2, max_len=48, n_requests=5, lo=3,
                         hi=20, max_new=6)


def recurrent_prompts(np, vocab, seed, n_requests, lo, hi, **_):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(lo, hi + 1, size=n_requests)]


def recurrent_teacher(torch, model, params, toks, S0, T):
    """What (b) holds decode against: the train-mode forward's logits of
    all S0+T tokens (through the recurrence kernels on the card), the
    prefill of the first S0 tokens (its logits and cache), and the cache
    a prefill of all S0+T tokens leaves."""
    from repro_torch.models import transformer as lm_mod

    cfg = model.cfg
    n = S0 + T + cfg.meta_tokens
    with torch.no_grad():
        full, _ = lm_mod.lm_apply(params, cfg, tokens=toks, mode="train")
        lg0, c0 = model.prefill(params, {"tokens": toks[:, :S0]}, max_len=n)
        _, want = model.prefill(params, {"tokens": toks}, max_len=n)
    return full[..., :cfg.vocab_size].float(), lg0, c0, want


def recurrent_check(torch, model, params, toks, teacher, S0, T, fault=None):
    """T decode steps from the prefill's cache (a copy), teacher-forced,
    with ``fault`` (``RECURRENT_MUST_CATCH``) injected: the logits' error
    against the train forward over the reference's scale, and each cache
    leaf's against the full prefill's over its scale."""
    cfg = model.cfg
    full, lg0, c0, want = teacher
    V = cfg.vocab_size
    cache = {k: t.clone() for k, t in c0.items()}
    errs = [(lg0[:, :V].float() - full[:, S0 - 1]).abs().max().item()]
    prefix = 0 if fault == "meta_offset_dropped" else cfg.meta_tokens
    with torch.no_grad():
        for t in range(T):
            for key in RECURRENT_ZEROED.get(fault, ()):
                cache[key].zero_()
            pos = torch.full((toks.shape[0],), prefix + S0 + t,
                             dtype=torch.int32, device=toks.device)
            lg, cache = model.decode(params, cache, toks[:, S0 + t:S0 + t + 1],
                                     pos)
            errs.append((lg[:, :V].float() - full[:, S0 + t]).abs().max()
                        .item())
    scale = max(full.abs().max().item(), 1.0)
    state = {k: ((cache[k].float() - w.float()).abs().max()
                 / w.float().abs().max().clamp(min=1e-30)).item()
             for k, w in want.items()}
    return {"logit_rel": max(errs) / scale, "logit_max_abs": max(errs),
            "scale": scale, "state_rel": state,
            "finite": all(math.isfinite(e) for e in errs)}


def recurrent_gate(r, dtype):
    """What of (b)'s gate a check fails: [] when it holds."""
    bad = []
    if not (r["finite"] and r["logit_rel"] <= RECURRENT_LOGIT_TOL[dtype]):
        bad.append("logits")
    if not max(r["state_rel"].values()) <= RECURRENT_STATE_TOL:
        bad.append("state")
    return bad


def recurrent_equivalence(torch, model, params, toks, S0, T, dtype):
    """(b) on one model: the sound check and each of its arch's
    ``RECURRENT_MUST_CATCH`` controls, with what the gate says of each."""
    teacher = recurrent_teacher(torch, model, params, toks, S0, T)
    sound = recurrent_check(torch, model, params, toks, teacher, S0, T)
    sound["failed"] = recurrent_gate(sound, dtype)
    controls = {}
    for name, arch in RECURRENT_MUST_CATCH.items():
        if arch == model.cfg.name:
            c = recurrent_check(torch, model, params, toks, teacher, S0, T,
                                name)
            c["caught_by"] = recurrent_gate(c, dtype)
            controls[name] = c
    return sound, controls


def recurrent_teacher_tokens(torch, model, params, prompt, max_len, max_new):
    """Greedy tokens of one request through ``Model.prefill`` then
    ``Model.decode`` at ``meta_tokens + S + t``, the engine's oracle."""
    dev = model.device
    with torch.no_grad():
        lg, cache = model.prefill(
            params, {"tokens": torch.from_numpy(prompt[None]).to(dev)},
            max_len=max_len)
        toks = [int(lg[0].argmax())]
        pos = model.cfg.meta_tokens + len(prompt)
        for t in range(max_new - 1):
            lg, cache = model.decode(
                params, cache,
                torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev),
                torch.tensor([pos + t], dtype=torch.int32, device=dev))
            toks.append(int(lg[0].argmax()))
    return toks


def recurrent_engine_tokens(model, params, prompts, max_batch, max_len,
                            max_new, fused=True, **_):
    from repro_torch.serve.engine import ServingEngine

    eng = ServingEngine(model, params, max_batch=max_batch, max_len=max_len,
                        fused=fused)
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_done()
    return [eng.done[r].tokens for r in rids]


def recurrent_reduced(torch, np, seed, dev="cuda"):
    """(c): reduced f32 rwkv6 and hymba (weights drawn on the CPU, then
    moved) through the fused and the legacy slot engines on ``dev`` and
    on the CPU, rows reused; each request's tokens against the port's
    teacher-forced greedy decode on ``dev``.  Returns the tokens and the
    mismatches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model

    kw = RECURRENT_REDUCED
    out, bad = {}, []
    for arch in RECURRENT_ARCHS:
        cfg = reduced(get_config(arch), compute_dtype="float32")
        cpu_params = build_model(cfg, device="cpu").init(seed)
        prompts = recurrent_prompts(np, cfg.vocab_size, seed, **kw)
        runs = {}
        for d in dict.fromkeys((dev, "cpu")):
            model = build_model(cfg, device=d)
            params = params_to(cpu_params, d)
            runs[f"teacher_{d}"] = [recurrent_teacher_tokens(
                torch, model, params, p, kw["max_len"], kw["max_new"])
                for p in prompts]
            for fused in (True, False):
                runs[f"{'fused' if fused else 'legacy'}_{d}"] = \
                    recurrent_engine_tokens(model, params, prompts,
                                            fused=fused, **kw)
        want = runs[f"teacher_{dev}"]
        bad += [f"{arch} {name}" for name, got in runs.items()
                if got != want]
        out[arch] = want
    return out, bad


def recurrent_serve_gates(eng, rids, counts, max_new):
    """(a)'s gates on a drained slot engine: every request complete with
    ``max_new`` tokens in the vocabulary, at most one sync a step, and no
    ``wkv6``/``ssm_scan`` launch (prefill and decode run the scans)."""
    st, vocab = eng.stats, eng.model.cfg.vocab_size
    toks = [eng.done[r].tokens for r in rids if r in eng.done]
    failed = []
    if st.completed != len(rids):
        failed.append(f"completed {st.completed} of {len(rids)}")
    if any(len(t) != max_new or min(t) < 0 or max(t) >= vocab
           for t in toks):
        failed.append("a request came back short or out of vocab")
    if st.host_syncs > st.steps + 1:
        failed.append(f"{st.host_syncs} syncs over {st.steps} steps")
    if counts["wkv6"] or counts["ssm_scan"]:
        failed.append(f"recurrence kernels launched while serving: {counts}")
    return failed


def recurrent_serve_full(torch, np, arch, seed):
    """(a): full-width ``arch`` through the fused slot engine under sync
    debugging: gates and readings."""
    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import ServingEngine

    kw = RECURRENT_SERVE
    cfg = get_config(arch)
    model = build_model(cfg, device="cuda")
    params = model.init(seed)
    prompts = recurrent_prompts(np, cfg.vocab_size, seed, **kw)
    ekw = dict(max_batch=kw["max_batch"], max_len=kw["max_len"])
    warm = ServingEngine(model, params, **ekw)
    warm.submit(prompts[0][:16], max_new_tokens=2)
    warm.run_until_done()
    del warm
    longest = max(prompts, key=len)
    batch = {"tokens": torch.from_numpy(longest[None]).cuda()}
    with torch.no_grad():
        _, prefill_ms = timed_once(torch, lambda: model.prefill(
            params, batch, max_len=kw["max_len"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    eng = ServingEngine(model, params, **ekw)
    rids = [eng.submit(p, max_new_tokens=kw["max_new"]) for p in prompts]
    step_ms, run_s, counts = drive(torch, eng)
    st = eng.stats
    line = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "meta_tokens": cfg.meta_tokens, **ekw,
            "requests": len(prompts),
            "prompt_tokens": [len(p) for p in prompts],
            "max_new": kw["max_new"], "completed": st.completed,
            "decoded_tokens": st.decoded_tokens, "steps": st.steps,
            "prefills": st.prefills, "host_syncs": st.host_syncs,
            "kernel_launches": counts, "run_s": run_s,
            "decode_tok_per_s": st.decoded_tokens / run_s,
            "median_step_ms": statistics.median(step_ms),
            "prefill_ms": prefill_ms, "prefill_tokens": len(longest),
            "prefill_ms_per_token": prefill_ms / len(longest),
            "kv_cache_bytes": eng.kv_cache_bytes(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "resident_before_gib": resident / 2 ** 30,
            "failed": recurrent_serve_gates(eng, rids, counts, kw["max_new"])}
    del eng
    torch.cuda.empty_cache()
    return model, params, line


def phase_recurrent_serve(torch, np, seed):
    """Full-width rwkv6 and hymba served through the fused slot engine
    (a), their decode held against the kernel-backed train forward in f32
    and bf16 beside ``RECURRENT_MUST_CATCH`` (b), and reduced f32 engines'
    tokens against the teacher-forced decode on the card and the CPU
    (c)."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_to
    from repro_torch.models.zoo import build_model

    failed = []
    eq = RECURRENT_EQ
    for arch in RECURRENT_ARCHS:
        model, params, line = recurrent_serve_full(torch, np, arch, seed)
        emit({"phase": "recurrent_serve", "part": "serve", **line})
        failed += [f"{arch} serve: {f}" for f in line["failed"]]
        rng = np.random.default_rng(seed + 3)
        toks = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, size=(eq["B"], eq["S0"] + eq["T"]))
            .astype(np.int32)).cuda()
        for dtype in ("float32", "bfloat16"):
            if dtype == "float32":
                m = build_model(get_config(arch).replace(
                    compute_dtype="float32"), device="cuda")
                p = params_to(params, dtype=torch.float32)
            else:
                m, p = model, params
            reset_launches()
            t0 = time.perf_counter()
            sound, controls = recurrent_equivalence(
                torch, m, p, toks, eq["S0"], eq["T"], dtype)
            counts = launch_counts()
            kernel = "wkv6" if arch.startswith("rwkv6") else "ssm_scan"
            emit({"phase": "recurrent_serve", "part": "equivalence",
                  "arch": arch, "dtype": dtype, **eq,
                  "logit_tol": RECURRENT_LOGIT_TOL[dtype],
                  "state_tol": RECURRENT_STATE_TOL, **sound,
                  "kernel_launches": counts[kernel],
                  "seconds": time.perf_counter() - t0,
                  "controls": controls})
            failed += [f"{arch} {dtype}: the sound decode fails {f}"
                       for f in sound["failed"]]
            failed += [f"{arch} {dtype}: control {n} not caught"
                       for n, c in controls.items() if not c["caught_by"]]
            if counts[kernel] != model.cfg.n_layers:
                failed.append(f"{arch} {dtype}: {counts[kernel]} {kernel} "
                              "launches in the train forward")
            del m, p
            torch.cuda.empty_cache()
        del model, params
        torch.cuda.empty_cache()
    tokens, bad = recurrent_reduced(torch, np, seed)
    emit({"phase": "recurrent_serve", "part": "reduced",
          **RECURRENT_REDUCED, "tokens": tokens, "mismatched": bad})
    failed += [f"reduced tokens differ: {b}" for b in bad]
    if failed:
        raise AssertionError(f"recurrent_serve: {failed}")


# the flash backward's cases: the train path's attention shapes (gemma2-2b's
# layers with and without a window that bites, and softcap off where SDPA
# computes the same function; gemma3-1b's GQA group of 4 over one KV head;
# internlm2-20b's 48 heads of 128), each in bf16 at the batch given and in
# f32 at B=1, and the f32 case the controls run on, where the softcap binds
# (q x 8)
FLASH_BWD_CASES = (
    dict(arch="gemma2-2b", B=4, H=8, KH=4, D=256, window=None, softcap=50.0),
    dict(arch="gemma2-2b", B=4, H=8, KH=4, D=256, window=128, softcap=50.0),
    dict(arch="gemma2-2b", B=4, H=8, KH=4, D=256, window=None, softcap=None),
    dict(arch="gemma3-1b", B=4, H=4, KH=1, D=256, window=None, softcap=None),
    dict(arch="internlm2-20b", B=2, H=48, KH=8, D=128, window=None,
         softcap=None))
FLASH_BWD_S = 512
FLASH_BWD_CONTROL_CASE = dict(arch="gemma2-2b", B=1, H=8, KH=4, D=256,
                              window=128, softcap=50.0, q_mul=8.0)
# the backward's gates, each gradient's max |got - want| over its max|want|
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the plain backward with one fault, which the f32 gate must catch on the
# control case: the softcap's chain-rule factor dropped, each GQA group's
# dK and dV taken from its first query head alone, the window one key
# wider, the D term (dO.O) left out of dS; and the CUDA-core kernels' own:
# the last block's partial of every tile that several blocks share dropped
# from its fold (``ref.flash_attention_bwd_split_plain``), L read from the
# next query row, and the 32 x 32 tiles on the diagonal dropped from dQ
FLASH_BWD_MUST_CATCH = ("softcap_factor_dropped", "gqa_first_head",
                        "window_one_off", "delta_dropped",
                        "split_part_dropped", "lse_next_row",
                        "diagonal_dropped_from_dq")
# the tensor-core backward's own faults, in its rounded plain version,
# which the bf16 gate must catch on the bf16 case with window and softcap:
# L read from the next query row, the 64 x 64 tiles on the diagonal
# dropped from dQ (each query tile's dS against its own key tile), and the
# last query head of every GQA group missing from dK and dV
FLASH_BWD_MMA_MUST_CATCH = ("lse_next_row", "diagonal_dropped_from_dq",
                            "gqa_head_missing")
FLASH_BWD_MMA_CONTROL_CASE = FLASH_BWD_CASES[1]
# the forward's L for the backward against ``flash_lse_plain`` of the f64
# scores: the same +inf rows and each finite row within FLASH_LSE_TOL; the
# faults the L gate must catch on the bf16 control case: L one query row
# off, one head off, and the softcap left out of the scores
FLASH_LSE_TOL = 1e-5
FLASH_LSE_MUST_CATCH = ("row_off_by_one", "head_off_by_one",
                        "softcap_ignored")


def flash_bwd_fault(torch, ref, name, q, k, v, out, dout, lse, kw):
    """The plain backward on these inputs, fed the forward's L ``lse``,
    with fault ``name`` (``FLASH_BWD_MUST_CATCH``)."""
    from repro_torch.kernels.flash_attention import BWD_T, bwd_work
    sound = ref.flash_attention_bwd_plain
    if name == "split_part_dropped":
        work = bwd_work(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                        k.shape[2], q.shape[3], causal=kw["causal"],
                        window=kw["window"])
        # every shared unit's fold one partial short: its last
        work = work._replace(**{
            name: table._replace(folds=table.folds - torch.tensor(
                [0, 0, 0, 0, 1], dtype=table.folds.dtype))
            for name, table in (("dq", work.dq), ("dkdv", work.dkdv))})
        return ref.flash_attention_bwd_split_plain(
            q, k, v, out, dout, lse, work, **kw)
    if name == "lse_next_row":
        lse = torch.cat([lse[..., 1:], lse[..., -1:]], dim=-1)
        return sound(q, k, v, out, dout, lse, **kw)
    if name == "diagonal_dropped_from_dq":
        dq, dk, dv = sound(q, k, v, out, dout, lse, **kw)
        dq = dq.float()
        for i in range(-(-q.shape[1] // BWD_T)):
            sl = slice(i * BWD_T, (i + 1) * BWD_T)
            dq[:, sl] -= sound(q[:, sl], k[:, sl], v[:, sl], out[:, sl],
                               dout[:, sl], lse[..., sl].contiguous(),
                               **kw)[0].float()
        return dq.to(q.dtype), dk, dv
    if name == "window_one_off":
        return ref.flash_attention_bwd_plain(
            q, k, v, out, dout, **{**kw, "window": kw["window"] + 1})
    G = q.shape[2] // k.shape[2]
    if name == "gqa_first_head":
        ke, ve = (t.repeat_interleave(G, dim=2) for t in (k, v))
        dq, dk, dv = ref.flash_attention_bwd_plain(q, ke, ve, out, dout, **kw)
        return dq, dk[:, :, ::G].contiguous(), dv[:, :, ::G].contiguous()
    # the chain rule written out again, one term wrong
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qf = q.float().reshape(B, Sq, -1, G, D)
    of, gf = (t.float().reshape(B, Sq, -1, G, D) for t in (out, dout))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * kw["scale"]
    cap = kw["softcap"]
    t = torch.tanh(s / cap)
    s = cap * t
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    keep = (ki <= qi) & ((qi - ki) < kw["window"])
    p = torch.softmax(torch.where(keep, s, -torch.inf), dim=-1)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", gf, of)
    if name == "delta_dropped":
        delta = torch.zeros_like(delta)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", gf, vf) - delta[..., None])
    if name != "softcap_factor_dropped":
        ds = ds * (1 - t * t)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * kw["scale"]
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * kw["scale"]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, gf)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_bwd_mma_fault(torch, ref, name, q, k, v, out, dout, lse, kw):
    """The tensor-core backward's plain version on these inputs with fault
    ``name`` (``FLASH_BWD_MMA_MUST_CATCH``)."""
    sound = ref.flash_attention_bwd_mma_plain
    if name == "lse_next_row":
        lse = torch.cat([lse[..., 1:], lse[..., -1:]], dim=-1)
        return sound(q, k, v, out, dout, lse, **kw)
    dq, dk, dv = sound(q, k, v, out, dout, lse, **kw)
    if name == "gqa_head_missing":
        # a head whose cotangent is 0 adds nothing to dK or dV (dS = P (0 -
        # 0) there): the group's sums without its last head
        G = q.shape[2] // k.shape[2]
        d_cut = dout.clone()
        d_cut[:, :, G - 1::G] = 0
        _, dk, dv = sound(q, k, v, out, d_cut, lse, **kw)
        return dq, dk, dv
    # diagonal_dropped_from_dq: a query tile against its own key tile
    # alone (positions shift together, so the mask is the same), taken
    # out of dQ
    T = 64
    dq = dq.float()
    for i in range(-(-q.shape[1] // T)):
        sl = slice(i * T, (i + 1) * T)
        dq[:, sl] -= sound(q[:, sl], k[:, sl], v[:, sl], out[:, sl],
                           dout[:, sl], lse[..., sl].contiguous(),
                           **kw)[0].float()
    return dq.to(q.dtype), dk, dv


def flash_bwd_ratios(got, want):
    """Each gradient's max |got - want| over its max|want|."""
    return [((g.float() - w.float()).abs().max()
             / w.float().abs().max().clamp(min=1e-30)).item()
            for g, w in zip(got, want)]


def flash_bwd_inputs(torch, g, dev, c, dtype, S=FLASH_BWD_S):
    """q, k, v, the forward's output and a cotangent for case ``c``."""
    from repro_torch.kernels.flash_attention import flash_attention
    B, H, KH, D = c["B"], c["H"], c["KH"], c["D"]
    q = (torch.randn((B, S, H, D), generator=g, device=dev)
         * c.get("q_mul", 1.0)).to(dtype)
    k, v = (torch.randn((B, S, KH, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=True, window=c["window"], softcap=c["softcap"],
              scale=D ** -0.5)
    with torch.no_grad():
        out = flash_attention(q, k, v, **kw)
    dout = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    return q, k, v, out, dout, kw


def flash_bwd_controls(torch, ref, q, k, v, out, dout, lse, kw, want):
    """``FLASH_BWD_MUST_CATCH`` on one f32 case (``lse`` the plain L): each
    fault's ratios and whether the f32 gate catches it."""
    controls = {}
    for name in FLASH_BWD_MUST_CATCH:
        r = flash_bwd_ratios(flash_bwd_fault(torch, ref, name, q, k, v, out,
                                             dout, lse, kw), want)
        controls[name] = {"ratios": r,
                          "caught": max(r) > FLASH_BWD_TOL["float32"]}
    return controls


def flash_bwd_mma_controls(torch, ref, q, k, v, out, dout, lse, kw, want):
    """``FLASH_BWD_MMA_MUST_CATCH`` on one bf16 case: each fault's ratios
    and whether the bf16 gate catches it."""
    controls = {}
    for name in FLASH_BWD_MMA_MUST_CATCH:
        r = flash_bwd_ratios(flash_bwd_mma_fault(
            torch, ref, name, q, k, v, out, dout, lse, kw), want)
        controls[name] = {"ratios": r,
                          "caught": max(r) > FLASH_BWD_TOL["bfloat16"]}
    return controls


def flash_bwd_lse(torch, q, k, v, out, kw):
    """The forward's row log-sum-exp for the backward
    (``flash_attention_with_lse``, from either forward kernel) and whether
    its O equals ``out``, the forward called without it, bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_with_lse
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, **kw)
    return lse, bool(torch.equal(o, out))


def flash_lse_want(torch, ref, q, k, kw):
    """The forward's L by its plain version, from the f64 scores."""
    return ref.flash_lse_plain(q.double(), k.double(), **kw)


def flash_lse_err(torch, got, want):
    """The forward's L against its plain version: the largest |got - want|
    over the finite rows, inf where the +inf rows differ or ``got`` holds a
    NaN."""
    if (not torch.equal(torch.isinf(got), torch.isinf(want))
            or bool(torch.isnan(got).any())):
        return float("inf")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return (got.double()[fin] - want[fin]).abs().max().item()


def flash_lse_controls(torch, ref, q, k, lse, want, kw):
    """``FLASH_LSE_MUST_CATCH`` on one case: each faulty L's error against
    the plain L and whether the L gate catches it."""
    faults = {
        "row_off_by_one": torch.cat([lse[..., 1:], lse[..., -1:]], dim=-1),
        "head_off_by_one": torch.roll(lse, 1, dims=1),
        "softcap_ignored": flash_lse_want(torch, ref, q, k,
                                          {**kw, "softcap": None})}
    controls = {}
    for name in FLASH_LSE_MUST_CATCH:
        err = flash_lse_err(torch, faults[name], want)
        controls[name] = {"err": err, "caught": not err <= FLASH_LSE_TOL}
    return controls


def guards_raise(torch, dev):
    """The kernel with no backward on a differentiable path refuses
    grad-requiring inputs on ``dev``: its name mapped to whether its
    wrapper raised ``NotImplementedError``."""
    from repro_torch.kernels.paged_attention import paged_attention

    def t(*shape, dtype=torch.float32):
        return torch.rand(shape, device=dev, dtype=dtype).requires_grad_()
    calls = {
        "paged_attention": lambda: paged_attention(
            t(1, 2, 16, dtype=torch.bfloat16),
            t(2, 16, 1, 16, dtype=torch.bfloat16),
            t(2, 16, 1, 16, dtype=torch.bfloat16),
            torch.zeros((1, 2), dtype=torch.int32, device=dev),
            torch.full((1,), 4, dtype=torch.int32, device=dev))}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = False
        except NotImplementedError:
            out[name] = True
    return out


def phase_flash_bwd_kernel(torch, dev, seed):
    """The flash backward kernels against their plain versions at the train
    path's shapes, bf16 (the tensor-core kernels) and f32 (the CUDA-core
    kernels), each fed its forward's L, timed beside the plain version,
    SDPA's backward where it computes the same function and the bound,
    a second call the same bits; the controls of ``FLASH_BWD_MUST_CATCH``
    and ``FLASH_BWD_MMA_MUST_CATCH``; the no-backward guards.  The
    forward's L is held against its plain version on every case
    (``FLASH_LSE_TOL``; ``FLASH_LSE_MUST_CATCH`` on the bf16 and the f32
    control case), and the plain backward reads the plain L, so the
    comparison covers the forward's hand-off.  Returns the cases and each
    backward kernel's largest absolute error."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (BWD, BWD_MMA,
                                                     flash_attention,
                                                     flash_attention_bwd)

    torch.cuda.empty_cache()        # what earlier phases left cached
    g = torch.Generator(device=dev).manual_seed(seed)
    cases = [(c, dt) for c in FLASH_BWD_CASES
             for dt in (torch.bfloat16, torch.float32)]
    cases.append((FLASH_BWD_CONTROL_CASE, torch.float32))
    out_cases, failed, controls, mma_controls = [], [], None, None
    lse_controls = lse_controls_f32 = None
    max_err = {BWD: 0.0, BWD_MMA: 0.0}
    for c, dt in cases:
        dname = str(dt).split(".")[-1]
        c = {**c, "B": c["B"] if dt == torch.bfloat16 else 1}
        q, k, v, out, dout, kw = flash_bwd_inputs(torch, g, dev, c, dt)
        name = (f"{c['arch']} {dname} window={c['window']} "
                f"softcap={c['softcap']}")
        lse, o_same = flash_bwd_lse(torch, q, k, v, out, kw)
        lse_want = flash_lse_want(torch, ref, q, k, kw)
        lse_err = flash_lse_err(torch, lse, lse_want)
        if not lse_err <= FLASH_LSE_TOL:
            failed.append(f"{name}: L off by {lse_err}")
        if dt == torch.bfloat16 and c == FLASH_BWD_MMA_CONTROL_CASE:
            lse_controls = flash_lse_controls(torch, ref, q, k, lse,
                                              lse_want, kw)
        if "q_mul" in c:
            lse_controls_f32 = flash_lse_controls(torch, ref, q, k, lse,
                                                  lse_want, kw)
        lse_plain = lse_want.float()
        del lse_want
        before = flash_attention.bwd_mma_launches
        got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        kernel = BWD_MMA if flash_attention.bwd_mma_launches > before else BWD
        want_kernel = BWD_MMA if dt == torch.bfloat16 else BWD
        if dt == torch.bfloat16:
            def plain():
                return ref.flash_attention_bwd_mma_plain(q, k, v, out, dout,
                                                         lse_plain, **kw)
        else:
            def plain():
                return ref.flash_attention_bwd_plain(q, k, v, out, dout,
                                                     lse_plain, **kw)
        want = plain()
        ratios = flash_bwd_ratios(got, want)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        max_err[kernel] = max(max_err[kernel], err)
        if max(ratios) > FLASH_BWD_TOL[dname]:
            failed.append(f"{name}: {ratios}")
        if kernel != want_kernel:
            failed.append(f"{name}: ran {kernel}, not {want_kernel}")
        if not o_same:
            failed.append(f"{name}: O differs with the lse buffer")
        same_bits = all(torch.equal(a, b) for a, b in zip(
            got, flash_attention_bwd(q, k, v, out, dout, lse, **kw)))
        if not same_bits:
            failed.append(f"{name}: a second call differs")
        if "q_mul" in c:
            controls = flash_bwd_controls(torch, ref, q, k, v, out, dout,
                                          lse_plain, kw, want)
        if dt == torch.bfloat16 and c == FLASH_BWD_MMA_CONTROL_CASE:
            mma_controls = flash_bwd_mma_controls(torch, ref, q, k, v, out,
                                                  dout, lse_plain, kw, want)

        def call():
            return flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        ms, s_ms = gpu_ms(torch, call, 20), stream_ms(torch, call)
        plain_ms = gpu_ms(torch, plain, 3)
        lib_ms = lib_s_ms = None
        if c["window"] is None and c["softcap"] is None:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               scale=kw["scale"],
                                               enable_gqa=True)
            go = dout.transpose(1, 2).contiguous()

            def sdpa_bwd():
                return torch.autograd.grad(o, (qt, kt, vt), go,
                                           retain_graph=True)
            lib_ms, lib_s_ms = gpu_ms(torch, sdpa_bwd, 20), stream_ms(
                torch, sdpa_bwd)
            del o
        elem = 2 if dt == torch.bfloat16 else 4
        bound, bound_by = _flash_bound_ms(
            c["B"], FLASH_BWD_S, FLASH_BWD_S, c["H"], c["KH"], c["D"], True,
            c["window"], elem,
            BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S,
            backward=True)
        case = {"arch": c["arch"], "dtype": dname, "kernel": kernel,
                "B": c["B"], "S": FLASH_BWD_S, "H": c["H"], "KH": c["KH"],
                "D": c["D"], "window": c["window"], "softcap": c["softcap"],
                "q_mul": c.get("q_mul", 1.0), "ratios": ratios,
                "o_same_with_lse": o_same, "lse_max_abs_err": lse_err,
                "same_bits": same_bits,
                "max_abs_err": err, "ms": ms,
                "stream_ms": s_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_stream_ms": lib_s_ms, "bound_ms": bound,
                "bound_by": bound_by}
        out_cases.append(case)
        emit({"phase": "flash_bwd_kernel", "name": "flash_attention_bwd",
              **case})
        del q, k, v, out, dout, got, want, lse, lse_plain
    guards = guards_raise(torch, dev)
    emit({"phase": "flash_bwd_kernel", "controls": controls,
          "mma_controls": mma_controls, "lse_controls": lse_controls,
          "lse_controls_f32": lse_controls_f32, "guards_raise": guards})
    failed += [f"control {n} not caught" for n in FLASH_BWD_MUST_CATCH
               if not controls[n]["caught"]]
    failed += [f"control {n} not caught" for n in FLASH_BWD_MMA_MUST_CATCH
               if not mma_controls[n]["caught"]]
    failed += [f"L control {n} not caught ({dn})"
               for dn, lc in (("bf16", lse_controls),
                              ("f32", lse_controls_f32))
               for n in FLASH_LSE_MUST_CATCH if not lc[n]["caught"]]
    failed += [f"{n} takes grad-requiring inputs" for n, ok in
               guards.items() if not ok]
    if failed:
        raise AssertionError(f"flash_bwd_kernel: {failed}")
    torch.cuda.empty_cache()
    return out_cases, max_err


# phase train: (a) full-width gemma2-2b, 3 AdamW steps of 8 x 512 tokens
# (accum 2 from microbatch 4), no checkpoint (the f32 params, both moments
# and the summed grads are 42 GB); (b) reduced f32 gemma2, 8 steps on the
# card against the CPU from one init, then a restart from step 4; (c)
# full-width rwkv6-1.6b and hymba-1.5b, 3 AdamW steps of 4 x 4096 tokens
# (accum 2: the configs' microbatch of 4 rows cut to 2, one micro-batch
# the shape of WKV_BWD_TRAIN / SSM_BWD_TRAIN); (d) reduced f32 rwkv6 and
# hymba, TRAIN_REDUCED on the card against the CPU from one init
TRAIN_FULL = dict(num_steps=3, global_batch=8, seq_len=512)
TRAIN_REDUCED = dict(num_steps=8, global_batch=8, seq_len=64, lr=1e-2)
TRAIN_RESTART_AT = 4
TRAIN_LOSS_RTOL = 1e-4
TRAIN_RECURRENT = dict(num_steps=3, global_batch=4, seq_len=4096)
TRAIN_RECURRENT_MICRO = 2
# the launches a train step counts, by kernel
TRAIN_COUNTS = ("flash_attention", "flash_attention_bwd",
                "flash_attention_bwd_mma", "wkv6", "wkv6_bwd", "ssm_scan",
                "ssm_scan_bwd")


def train_want_per_step(cfg, accum, mma):
    """Remat's launches a step: a layer's forward kernel twice a
    micro-batch (the forward and its recomputation in the backward), its
    backward kernel once: the flash attention's for the dense family (the
    backward on the tensor cores with ``mma``), the recurrence's for
    rwkv6 (``wkv6``) and hymba (``ssm_scan``); every other count 0."""
    n = cfg.n_layers * accum
    want = dict.fromkeys(TRAIN_COUNTS, 0)
    if cfg.family == "ssm":
        want.update(wkv6=2 * n, wkv6_bwd=n)
    elif cfg.family == "hybrid":
        want.update(ssm_scan=2 * n, ssm_scan_bwd=n)
    else:
        want.update(flash_attention=2 * n, flash_attention_bwd=n,
                    flash_attention_bwd_mma=n if mma else 0)
    return want


def train_launch_gate(per_step, cfg, accum, mma):
    """Each step's launches must be ``train_want_per_step``'s."""
    want = train_want_per_step(cfg, accum, mma)
    return [f"step {i}: {got} launches, want {want}"
            for i, got in enumerate(per_step) if got != want]


def train_counting_hook(per_step):
    """A train() hook appending each step's launches of ``TRAIN_COUNTS``
    (the counts since the previous step's hook; zeroed before the run)."""
    last = dict.fromkeys(TRAIN_COUNTS, 0)

    def hook(step, metrics):
        counts = launch_counts()
        now = {k: counts[k] for k in TRAIN_COUNTS}
        per_step.append({k: now[k] - last[k] for k in now})
        last.update(now)
    return hook


def train_reduced(torch, seed):
    """Reduced f32 gemma2: ``TRAIN_REDUCED`` on the card and on the CPU
    from one (CPU-drawn) init, then on the card again as a run of
    ``TRAIN_RESTART_AT`` steps with a checkpoint and a restarted run to
    the end.  Returns the readings and the failed gates."""
    import tempfile

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import train
    from repro_torch.train.step import accum_steps_for
    from repro_torch.train.tree import tree_map

    cfg = reduced(get_config("gemma2-2b"), compute_dtype="float32")
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg,
                                                            device="cuda")
    init = cpu.init(seed, dtype=torch.float32)

    def fresh(dev):
        """A copy of the init on ``dev`` (train() updates it in place)."""
        return tree_map(lambda t: t.to(dev, copy=True), init)
    kw = dict(TRAIN_REDUCED, seed=seed)
    reset_launches()
    per_step = []
    on_card = train(card, params=fresh("cuda"),
                    hooks=[train_counting_hook(per_step)], **kw)
    on_cpu = train(cpu, params=fresh("cpu"), **kw)
    with tempfile.TemporaryDirectory() as d:
        first = train(card, params=fresh("cuda"), ckpt_dir=d,
                      ckpt_every=TRAIN_RESTART_AT,
                      **{**kw, "num_steps": TRAIN_RESTART_AT})
        rest = train(card, params=fresh("cuda"), ckpt_dir=d,
                     ckpt_every=TRAIN_RESTART_AT, **kw)

    def rel(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))
    line = {"arch": cfg.name, "card_losses": on_card.losses,
            "cpu_losses": on_cpu.losses,
            "card_vs_cpu": rel(on_card.losses, on_cpu.losses),
            "restarted_from": rest.restored_from,
            "restart_losses": first.losses + rest.losses,
            "restart_vs_full": rel(first.losses + rest.losses,
                                   on_card.losses),
            "launches_per_step": per_step[0] if per_step else None,
            "card_launches": sum(s["flash_attention_bwd"] - s[
                "flash_attention_bwd_mma"] for s in per_step)}
    failed = []
    if line["card_vs_cpu"] > TRAIN_LOSS_RTOL:
        failed.append(f"card losses vs CPU {line['card_vs_cpu']}")
    if rest.restored_from != TRAIN_RESTART_AT:
        failed.append(f"restored from {rest.restored_from}")
    if line["restart_vs_full"] > TRAIN_LOSS_RTOL:
        failed.append(f"restart losses vs full {line['restart_vs_full']}")
    failed += train_launch_gate(per_step, cfg, accum_steps_for(
        cfg, kw["global_batch"], 1), mma=False)
    return line, failed


def train_full(torch, seed):
    """Full-width gemma2-2b through ``train()`` (``TRAIN_FULL``), priced by
    the committed H100 table; the readings and the failed gates."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import CostModel
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import train
    from repro_torch.train.step import accum_steps_for

    cfg = get_config("gemma2-2b")
    model = build_model(cfg, device="cuda")
    params = model.init(seed, dtype=torch.float32)
    probe = {"wq": params["layers"][0]["attn"]["wq"][:8].clone(),
             "table": params["embed"]["table"][:8].clone(),
             "ln_f": params["ln_f"]["scale"].clone()}
    accum = accum_steps_for(cfg, TRAIN_FULL["global_batch"], 1)
    metrics, per_step = [], []
    count = train_counting_hook(per_step)

    def hook(step, m):
        count(step, m)
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "measured_step_s": m["measured_step_s"]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train(model, params=params, seed=seed, hooks=[hook],
                cost_model=CostModel.from_named("hopper_h100"), **TRAIN_FULL)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = {k: (params_leaf - probe[k].float()).abs().max().item()
             for k, params_leaf in (
                 ("wq", params["layers"][0]["attn"]["wq"][:8].float()),
                 ("table", params["embed"]["table"][:8].float()),
                 ("ln_f", params["ln_f"]["scale"].float()))}
    steps_ms = [1e3 * t for t in res.step_times_s]
    median_ms = statistics.median(steps_ms[1:])
    tokens = TRAIN_FULL["global_batch"] * TRAIN_FULL["seq_len"]
    line = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, **TRAIN_FULL, "accum": accum,
            "losses": res.losses,
            "grad_norms": [m["grad_norm"] for m in metrics],
            "step_ms": steps_ms, "median_step_ms_2_3": median_ms,
            "tokens_per_s": tokens / (median_ms / 1e3),
            "predicted_step_s": res.predicted_step_s,
            "measured_step_s": [m["measured_step_s"] for m in metrics],
            "peak_gib": peak, "moved": moved,
            "launches_per_step": per_step,
            "want_per_step": train_want_per_step(cfg, accum, mma=True)}
    failed = [f"{k} not finite" for k in ("losses", "grad_norms")
              if not all(math.isfinite(x) for x in line[k])]
    failed += [f"{k} did not move" for k, d in moved.items() if not d > 0]
    failed += train_launch_gate(per_step, cfg, accum, mma=True)
    if len(res.losses) != TRAIN_FULL["num_steps"]:
        failed.append(f"{len(res.losses)} steps run")
    del model, params, res
    torch.cuda.empty_cache()
    return line, failed


def train_recurrent_reduced(torch, seed, arch):
    """Reduced f32 ``arch`` (rwkv6 or hymba): ``TRAIN_REDUCED`` on the
    card (the recurrence's kernels) and on the CPU (their plain versions)
    from one (CPU-drawn) init.  Returns the readings and the failed
    gates."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import train
    from repro_torch.train.step import accum_steps_for
    from repro_torch.train.tree import tree_map

    cfg = reduced(get_config(arch), compute_dtype="float32")
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg,
                                                            device="cuda")
    init = cpu.init(seed, dtype=torch.float32)
    kw = dict(TRAIN_REDUCED, seed=seed)
    reset_launches()
    per_step = []
    on_card = train(card, params=tree_map(lambda t: t.to("cuda", copy=True),
                                          init),
                    hooks=[train_counting_hook(per_step)], **kw)
    on_cpu = train(cpu, params=tree_map(lambda t: t.clone(), init), **kw)
    rel = max(abs(x - y) / max(abs(y), 1e-30)
              for x, y in zip(on_card.losses, on_cpu.losses))
    bwd = "wkv6_bwd" if cfg.family == "ssm" else "ssm_scan_bwd"
    line = {"arch": cfg.name, "card_losses": on_card.losses,
            "cpu_losses": on_cpu.losses, "card_vs_cpu": rel,
            "launches_per_step": per_step[0] if per_step else None,
            "card_bwd_launches": sum(s[bwd] for s in per_step)}
    failed = []
    if not rel <= TRAIN_LOSS_RTOL:
        failed.append(f"{arch}: card losses vs CPU {rel}")
    if not line["card_bwd_launches"] > 0:
        failed.append(f"{arch}: no {bwd} launch on the card")
    failed += train_launch_gate(per_step, cfg, accum_steps_for(
        cfg, kw["global_batch"], 1), mma=False)
    return line, failed


def train_recurrent_full(torch, seed, arch):
    """Full-width ``arch`` (rwkv6-1.6b or hymba-1.5b; seeded random
    weights, f32 params, bf16 compute, AdamW, remat) through ``train()``
    (``TRAIN_RECURRENT``, micro-batches of ``TRAIN_RECURRENT_MICRO``
    rows): the readings and the failed gates (losses and grad norms
    finite, params moved, each step's launches exactly remat's)."""
    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import train
    from repro_torch.train.step import accum_steps_for

    cfg = get_config(arch).replace(microbatch=TRAIN_RECURRENT_MICRO)
    model = build_model(cfg, device="cuda")
    params = model.init(seed, dtype=torch.float32)
    layer0 = params["layers"][0]
    probes = {"embed": lambda: params["embed"]["table"][:8],
              "ln_f": lambda: params["ln_f"]["scale"]}
    if cfg.family == "ssm":
        probes.update(wr=lambda: layer0["tmix"]["wr"][:8],
                      u_bonus=lambda: layer0["tmix"]["u_bonus"])
    else:
        probes.update(w_in=lambda: layer0["mamba"]["w_in"][:8],
                      a_log=lambda: layer0["mamba"]["a_log"])
    before = {k: f().float().clone() for k, f in probes.items()}
    accum = accum_steps_for(cfg, TRAIN_RECURRENT["global_batch"], 1)
    metrics, per_step = [], []
    count = train_counting_hook(per_step)

    def hook(step, m):
        count(step, m)
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])})
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train(model, params=params, seed=seed, hooks=[hook],
                **TRAIN_RECURRENT)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = {k: (f().float() - before[k]).abs().max().item()
             for k, f in probes.items()}
    steps_ms = [1e3 * t for t in res.step_times_s]
    median_ms = statistics.median(steps_ms[1:])
    tokens = TRAIN_RECURRENT["global_batch"] * TRAIN_RECURRENT["seq_len"]
    line = {"arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            **TRAIN_RECURRENT, "microbatch": cfg.microbatch, "accum": accum,
            "positions": TRAIN_RECURRENT["seq_len"] + cfg.meta_tokens,
            "losses": res.losses,
            "grad_norms": [m["grad_norm"] for m in metrics],
            "step_ms": steps_ms, "median_step_ms_2_3": median_ms,
            "tokens_per_s": tokens / (median_ms / 1e3), "peak_gib": peak,
            "moved": moved, "launches_per_step": per_step,
            "want_per_step": train_want_per_step(cfg, accum, mma=False)}
    failed = [f"{arch}: {k} not finite" for k in ("losses", "grad_norms")
              if not all(math.isfinite(x) for x in line[k])]
    failed += [f"{arch}: {k} did not move" for k, d in moved.items()
               if not d > 0]
    failed += [f"{arch}: {f}" for f in
               train_launch_gate(per_step, cfg, accum, mma=False)]
    if len(res.losses) != TRAIN_RECURRENT["num_steps"]:
        failed.append(f"{arch}: {len(res.losses)} steps run")
    del model, params, res
    gc_collect(torch)
    return line, failed


def gc_collect(torch):
    """Free what earlier work left: Python's garbage, then the cache."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(torch, seed):
    """Training on the card: full-width gemma2-2b through the loop (a),
    reduced f32 gemma2 card == CPU and a checkpoint restart (b),
    full-width rwkv6-1.6b and hymba-1.5b through the loop (c), reduced f32
    rwkv6 and hymba card == CPU (d).  Returns the backward launches of the
    main paths: the tensor-core flash backward's in (a), the CUDA-core
    one's in (b)'s card run, ``wkv6_bwd``'s and ``ssm_scan_bwd``'s in
    (c)."""
    gc_collect(torch)
    full, failed = train_full(torch, seed)
    emit({"phase": "train", "part": "full_width", **full})
    red, bad = train_reduced(torch, seed)
    emit({"phase": "train", "part": "reduced", **red})
    failed += [f"reduced: {b}" for b in bad]
    rec = {}
    for arch, bwd in (("rwkv6-1.6b", "wkv6_bwd"),
                      ("hymba-1.5b", "ssm_scan_bwd")):
        line, bad = train_recurrent_full(torch, seed, arch)
        emit({"phase": "train", "part": "recurrent_full_width", **line})
        failed += bad
        rec[bwd] = sum(s[bwd] for s in line["launches_per_step"])
        line, bad = train_recurrent_reduced(torch, seed, arch)
        emit({"phase": "train", "part": "recurrent_reduced", **line})
        failed += bad
    if failed:
        raise AssertionError(f"train: {failed}")
    return (sum(s["flash_attention_bwd_mma"]
                for s in full["launches_per_step"]),
            red["card_launches"], rec["wkv6_bwd"], rec["ssm_scan_bwd"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(SRC):
        print("chip_smoke: repro_torch does not come from this checkout",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    seconds, t0 = {}, [time.perf_counter()]

    def lap(name):
        t = time.perf_counter()
        seconds[name] = t - t0[0]
        t0[0] = t

    card, builds = phase_card(torch)
    lap("card")
    cases, max_err = phase_kernel(torch, np, dev, args.seed)
    lap("kernel")
    fa_cases, fa_err = phase_flash_kernel(torch, dev, args.seed)
    lap("flash_kernel")
    model, params, prompts, launches, paged_toks = phase_serve(
        torch, np, dev, args.seed)
    lap("serve")
    fa_launches, slot_toks = phase_serve_slot(torch, model, params, prompts)
    lap("serve_slot")
    phase_parity(torch, np, model, params, args.seed)
    phase_parity_slot(torch, np, model, params, args.seed)
    del model, params
    torch.cuda.empty_cache()
    lap("parity")
    fa_f32_launches = phase_reference(torch, np, args.seed)
    lap("reference")
    # the recurrence kernels' phases run here, while the probe kernels
    # (alu_chain, the longest nvcc by far) finish building
    wkv_case, wkv_err = phase_wkv6_kernel(torch, dev, args.seed)
    lap("wkv6_kernel")
    ssm_case, ssm_err = phase_ssm_kernel(torch, dev, args.seed)
    lap("ssm_kernel")
    wkv_bwd_case, wkv_bwd_err = phase_wkv6_bwd_kernel(torch, dev, args.seed)
    lap("wkv6_bwd_kernel")
    ssm_bwd_case, ssm_bwd_err = phase_ssm_bwd_kernel(torch, dev, args.seed)
    lap("ssm_bwd_kernel")
    card_builds(torch, card, builds)
    lap("build_wait")
    probes, probe_err = phase_probes(torch, np, dev, args.seed)
    lap("probes")
    cal_counts = phase_calibration(torch, dev, card)
    lap("calibration")
    phase_costmodel(torch, np, dev, args.seed, card)
    lap("costmodel")
    phase_hotpath(torch, np, dev, args.seed, card,
                  {"paged": paged_toks, "slot": slot_toks})
    lap("hotpath")
    phase_campaign(torch, dev, args.seed, card)
    lap("campaign")
    phase_autotune(torch, np, dev, args.seed, card)
    lap("autotune")
    phase_telemetry(torch, np, dev, args.seed, card)
    lap("telemetry")
    phase_cluster(torch, np, dev, args.seed, card)
    lap("cluster")
    wkv_launches = phase_eval(torch, dev, args.seed, "rwkv6-1.6b", "wkv6")
    lap("eval_rwkv6")
    ssm_launches = phase_eval(torch, dev, args.seed, "hymba-1.5b",
                              "ssm_scan")
    lap("eval_hymba")
    phase_reference_eval(torch, np, args.seed)
    lap("reference_eval")
    phase_recurrent_serve(torch, np, args.seed)
    lap("recurrent_serve")
    bwd_cases, bwd_err = phase_flash_bwd_kernel(torch, dev, args.seed)
    lap("flash_bwd_kernel")
    (bwd_mma_launches, bwd_launches, wkv_bwd_launches,
     ssm_bwd_launches) = phase_train(torch, args.seed)
    lap("train")
    emit({"phase": "timing", "seconds": seconds,
          "total_s": sum(seconds.values())})

    # the kernel line: the serving shapes with neither window nor softcap
    # and one split, the one case where SDPA computes the same function
    main_case = next(c for c in cases if c["window"] is None
                     and c["softcap"] is None and c["num_splits"] == 1)
    # the flash kernels at the main path's longest prompt (B=1, Sq=900),
    # causal without window or softcap, where SDPA computes the same: the
    # tensor-core kernel in bf16 (the main path's), the CUDA-core one in
    # f32 (the reference phase's path)
    fa_case, fa_f32_case = (
        next(c for c in fa_cases if c["dtype"] == dtype and c["B"] == 1
             and c["Sq"] == 900 and c["H"] == 8 and c["causal"]
             and c["window"] is None
             and c["softcap"] is None and c["q_mul"] == 1.0
             and c["acc_dtype"] == "f32")
        for dtype in ("bfloat16", "float32"))
    # the flash backward at the train path's shape (gemma2-2b, 512 tokens)
    # with softcap and window off, where SDPA's backward computes the same
    # function: the tensor-core kernels in bf16 (B=4, the main path's), the
    # CUDA-core ones in f32 (B=1, the reduced f32 training's path)
    bwd_mma_case, bwd_case = (
        next(c for c in bwd_cases if c["arch"] == "gemma2-2b"
             and c["dtype"] == dtype and c["window"] is None
             and c["softcap"] is None)
        for dtype in ("bfloat16", "float32"))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    fa_keys = keys + ("stream_ms", "library_stream_ms")
    emit({"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:203",
         "launches": launches, "max_abs_err": max_err,
         **{k: main_case[k] for k in keys + ("graph_ms",
                                              "library_graph_ms")}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
         "replaces": "src/repro/kernels/flash_attention.py:80",
         "launches": fa_launches,
         "max_abs_err": fa_err["flash_attention_mma"],
         **{k: fa_case[k] for k in fa_keys}},
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:80",
         "launches": fa_f32_launches,
         "max_abs_err": fa_err["flash_attention"],
         **{k: fa_f32_case[k] for k in fa_keys}},
        {"name": "flash_attention_bwd_mma", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_mma.cu",
         "replaces": "src/repro/kernels/flash_attention.py:80",
         "launches": bwd_mma_launches,
         "max_abs_err": bwd_err["flash_attention_bwd_mma"],
         **{k: bwd_mma_case[k] for k in fa_keys}},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:80",
         "launches": bwd_launches,
         "max_abs_err": bwd_err["flash_attention_bwd"],
         **{k: bwd_case[k] for k in fa_keys}}] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": cal_counts[name],
         "max_abs_err": probe_err[name],
         **{k: probes[name][k] for k in fa_keys + (
             ("chain_ms",) if name == "alu_chain" else ())}}
        for name, replaces in (
            ("alu_chain", "src/repro/kernels/microbench_alu.py:51"),
            ("pointer_chase", "src/repro/kernels/microbench_chase.py:28"),
            ("mxu_probe", "src/repro/kernels/mxu_probe.py:26"))] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": launches, "max_abs_err": err,
         **{k: case[k] for k in case_keys}}
        for name, replaces, launches, err, case, case_keys in (
            ("wkv6", "src/repro/kernels/wkv6.py:46", wkv_launches, wkv_err,
             wkv_case, keys + ("stream_ms",)),
            ("ssm_scan", "src/repro/kernels/ssm_scan.py:39", ssm_launches,
             ssm_err, ssm_case, keys + ("stream_ms",)),
            ("wkv6_bwd", "src/repro/kernels/wkv6.py:46", wkv_bwd_launches,
             wkv_bwd_err, wkv_bwd_case, keys + ("stream_ms",)),
            ("ssm_scan_bwd", "src/repro/kernels/ssm_scan.py:39",
             ssm_bwd_launches, ssm_bwd_err, ssm_bwd_case,
             keys + ("stream_ms",)))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
