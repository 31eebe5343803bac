"""The training loop, a port of ``repro.train.loop``: data -> step ->
metrics and heartbeat -> checkpoint.

Composes the port's layers: the synthetic pipeline (restart-deterministic,
one batch prefetched), ``make_train_step`` (gradient accumulation, AdamW or
Adafactor), the async ``CheckpointManager``, heartbeat-based fault
detection (``FaultTolerantRunner``).  One card, no mesh: ``mesh=`` other
than None raises, as the paged engine's does, since sharding is the port's
next half (ROADMAP queue 1).  Used by ``repro_torch.launch.train``.

Pricing: the reference prices the compiled step's HLO text
(``predict_compiled``), which PyTorch has no counterpart of; with
``cost_model`` the loop prices the port's own analytic census of the train
cell (``core.costmodel.analytic.analytic_census`` on one device) once, up
front, and every step's metrics carry ``predicted_step_s`` beside
``measured_step_s``.  A measured step is host wall time around the step,
which ends in ``torch.cuda.synchronize()`` on the card (the loss is read
back on every device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeCell
from repro_torch.core.costmodel.analytic import analytic_census
from repro_torch.data.synthetic import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed.fault_tolerance import (FaultTolerantRunner,
                                                     HeartbeatRegistry)
from repro_torch.train import optim as optim_mod
from repro_torch.train.step import accum_steps_for, make_train_step


@dataclasses.dataclass
class TrainResult:
    steps_run: int
    final_loss: float
    losses: List[float]
    restored_from: Optional[int]
    events: List
    predicted_step_s: Optional[float] = None   # cost-model verdict
    step_times_s: List[float] = dataclasses.field(default_factory=list)
    # autotuner verdict: kernel -> launch config resolved for this run's
    # shapes (tuned cache entry when present, else the kernel default)
    tuned_configs: Optional[Dict[str, Dict]] = None


def train(model, mesh=None, *, num_steps: int = 50, global_batch: int = 8,
          seq_len: int = 64, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, lr: float = 3e-3, seed: int = 0,
          hooks: Optional[List[Callable]] = None, cost_model=None,
          log_prediction: bool = False, autotuner=None,
          params=None) -> TrainResult:
    """Run ``num_steps`` steps from step 0, or from the latest checkpoint
    in ``ckpt_dir``.  ``cost_model`` (a ``repro_torch.core.costmodel.
    CostModel``) prices the step once; ``log_prediction`` prints each
    step's predicted and measured seconds.  ``autotuner`` (a
    ``repro_torch.core.autotune.Autotuner``) is the process-global tuning
    handle for the run (the attention resolves its launch config through
    it), restored on exit; ``TrainResult.tuned_configs`` holds the configs
    resolved for this run's kernel shapes.  ``params`` are the initial
    parameters (default ``model.init(seed)`` in ``cfg.param_dtype``), updated
    in place; a checkpoint to restore replaces them."""
    if mesh is not None:
        raise NotImplementedError(
            "train(mesh=...) needs the sharding half of the port (ROADMAP "
            "queue 1); the loop runs on one device")
    from repro_torch.core import autotune as autotune_mod
    prev_tuner = (autotune_mod.install(autotuner) if autotuner is not None
                  else None)
    try:
        return _train(model, num_steps=num_steps, global_batch=global_batch,
                      seq_len=seq_len, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, lr=lr, seed=seed, hooks=hooks,
                      cost_model=cost_model, log_prediction=log_prediction,
                      autotuner=autotuner, params=params)
    finally:
        if autotuner is not None:
            autotune_mod.install(prev_tuner)


def _train_kernel_shapes(cfg, seq_len: int, rows: int) -> Dict[str, Dict]:
    """The tunable-kernel problem shapes one train microstep presents: the
    dense family's flash attention, rwkv6's recurrence, hymba's scan (its
    attention, over the meta tokens, takes no kernel)."""
    if cfg.family == "ssm":
        return {"wkv6": {"batch": rows, "seq": seq_len,
                         "heads": cfg.d_model // cfg.rwkv.head_dim,
                         "head_dim": cfg.rwkv.head_dim}}
    if cfg.family == "hybrid":
        return {"ssm_scan": {"batch": rows, "seq": seq_len + cfg.meta_tokens,
                             "d_inner": cfg.d_model,
                             "state_dim": cfg.ssm.state_dim}}
    return {"flash_attention": {
        "batch": rows, "seq_q": seq_len, "seq_kv": seq_len,
        "heads": cfg.padded_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim}}


def _train(model, *, num_steps, global_batch, seq_len, ckpt_dir,
           ckpt_every, lr, seed, hooks, cost_model, log_prediction,
           autotuner, params) -> TrainResult:
    cfg = model.cfg
    optimizer = optim_mod.make_optimizer(cfg.optimizer, lr_peak=lr)
    accum = accum_steps_for(cfg, global_batch, 1)
    step_fn = make_train_step(model, optimizer, accum)

    # ----- autotuner: the launch configs resolved for this run's shapes --
    tuned_configs = None
    if autotuner is not None:
        # one accumulation microstep carries global_batch // accum rows;
        # keyed on the compute dtype, as the attention's tuned dispatch is
        rows = max(global_batch // accum, 1)
        tuned_configs = {
            kernel: autotuner.config_for(kernel, shapes,
                                         dtype=cfg.compute_dtype)
            for kernel, shapes in
            _train_kernel_shapes(cfg, seq_len, rows).items()}
        if log_prediction:
            for kernel, kcfg in tuned_configs.items():
                print(f"autotune: {kernel} -> {kcfg}")

    # ----- state (fresh or restored) -------------------------------------
    if params is None:
        params = model.init(seed, dtype=getattr(torch, cfg.param_dtype))
    opt_state = optimizer.init(params)
    start_step, restored_from = 0, None
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None:
        got = mgr.restore_latest(like={"p": params, "o": opt_state})
        if got is not None:
            start_step, state = got
            params, opt_state = state["p"], state["o"]
            restored_from = start_step

    # ----- data (deterministic resume at start_step) ----------------------
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len, global_batch,
                                  seed=seed))

    def to_dev(b):
        return {k: torch.from_numpy(v).to(model.device) for k, v in b.items()}
    it = Prefetcher(data.iterate(start_step), transform=to_dev)

    runner = FaultTolerantRunner(HeartbeatRegistry(["host0"]))
    predicted_step_s = None
    if cost_model is not None:
        census = analytic_census(cfg, ShapeCell("loop", "train", seq_len,
                                                global_batch),
                                 n_devices=1, n_model=1, accum=accum)
        predicted_step_s = cost_model.predict(census).step_s

    on_card = model.device.type == "cuda"
    losses: List[float] = []
    step_times: List[float] = []
    for step in range(start_step, num_steps):
        batch = next(it)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if on_card:
            torch.cuda.synchronize(model.device)
        dt = time.perf_counter() - t0
        loss = float(metrics["loss"])
        losses.append(loss)
        step_times.append(dt)
        runner.on_step("host0", step, dt)
        if predicted_step_s is not None:
            metrics = {**metrics, "predicted_step_s": predicted_step_s,
                       "measured_step_s": dt}
            if log_prediction:
                print(f"step {step}: predicted={predicted_step_s:.3e}s "
                      f"measured={dt:.3e}s "
                      f"ratio={dt / max(predicted_step_s, 1e-12):.2f}x")
        for h in hooks or []:
            h(step, metrics)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"p": params, "o": opt_state})
    if mgr is not None:
        mgr.save(num_steps, {"p": params, "o": opt_state}, block=True)
        mgr.wait()
    return TrainResult(num_steps - start_step,
                       losses[-1] if losses else float("nan"), losses,
                       restored_from, runner.events,
                       predicted_step_s=predicted_step_s,
                       step_times_s=step_times, tuned_configs=tuned_configs)
