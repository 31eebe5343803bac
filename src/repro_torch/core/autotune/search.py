"""The two-stage search: analytic ranking, optional measured refinement.

Stage 1 prices every surviving candidate with ``CostModel.predict`` over
the tunable's analytic census - deterministic, device-free, milliseconds -
and ranks ascending by predicted time (ties broken by the canonical JSON
of the config, so the ranking is total and reproducible).  Stage 2, when
measurement is on, times the shortlist (the top ``top_k`` and the default)
through the port's kernel entry points (``repro_torch.kernels.ops``) on
``device``, with the measurement harness's ``device_time`` (on the card
``measure_iters`` calls captured in one CUDA graph and replayed between
CUDA events: device time, since a kernel of microseconds sits under tens
of microseconds of launch cost that is the same for every candidate; on
the CPU ``perf_counter``), the calls cycling over copies of the inputs
larger than the L2 (``cold_copies``), as serving reads each layer's pool
from HBM, and lets the median time pick the winner.  A shortlist of one
config (``ssm_scan`` and ``wkv6`` take no launch choice on the card) is
not timed: its pick is fixed, and its result stays analytic.  A
``check`` callback, when given, sees each shortlisted candidate's output
once before it is timed, so a fast but wrong candidate can be refused.

Winners persist through :class:`TuningCache` keyed by ``(kernel,
shape-bucket, dtype, device_kind, calibration_id)``; ``lookup`` is the
read side the kernel dispatch (``repro_torch.kernels.ops``) consults.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

from repro_torch.core.autotune.cache import TuningCache, entry_key
from repro_torch.core.autotune.space import (SMEM_MAX, Tunable, get_tunable,
                                             shape_bucket, tunable_names)
from repro_torch.core.costmodel.calibration import canon_dtype

# ranked-table rows kept inside a cache entry (full rankings can be long)
_ENTRY_ROWS = 8


@dataclass
class TuneResult:
    """One kernel's tuning outcome: the full ranked table plus the pick."""
    kernel: str
    shapes: Dict[str, int]
    dtype: str
    key: str
    ranked: List[Dict[str, Any]]          # {config, predicted_s, ...} rows
    best: Dict[str, Any]                  # winning config
    default: Dict[str, Any]               # effective default config
    predicted_best_s: float
    predicted_default_s: float
    measured_best_s: Optional[float] = None
    measured_default_s: Optional[float] = None
    source: str = "analytic"              # analytic | measured

    @property
    def predicted_speedup(self) -> float:
        """Default-over-best predicted time (>= 1 when tuning helps)."""
        return self.predicted_default_s / max(self.predicted_best_s, 1e-30)

    @property
    def measured_speedup(self) -> Optional[float]:
        if self.measured_best_s is None or self.measured_default_s is None:
            return None
        return self.measured_default_s / max(self.measured_best_s, 1e-30)

    def summary(self) -> str:
        cfg = json.dumps(self.best, sort_keys=True)
        s = (f"{self.kernel}: best={cfg} "
             f"predicted={self.predicted_best_s:.3e}s "
             f"(default {self.predicted_default_s:.3e}s, "
             f"x{self.predicted_speedup:.2f})")
        if self.measured_best_s is not None:
            s += f" measured={self.measured_best_s:.3e}s"
            if self.measured_speedup is not None:
                s += f" (x{self.measured_speedup:.2f} measured)"
        return s


_HIT_KEYS_KEPT = 64


@dataclass
class AutotuneStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    tunes: int = 0
    # most recent hit keys only (bounded: a serving process does one
    # lookup per tuned kernel call and must not accumulate forever)
    hit_keys: List[str] = field(default_factory=list)

    def record_hit(self, key: str) -> None:
        self.hits += 1
        self.hit_keys.append(key)
        if len(self.hit_keys) > _HIT_KEYS_KEPT:
            del self.hit_keys[:-_HIT_KEYS_KEPT]

    def as_dict(self) -> Dict[str, int]:
        return {"lookups": self.lookups, "hits": self.hits,
                "misses": self.misses, "tunes": self.tunes}


class Autotuner:
    """Cost-model-guided kernel autotuner with a persistent cache.

    ``cost_model`` defaults to the measured H100 table (``hopper_h100``);
    ``cache=None`` means a private in-memory cache.  ``measure=True``
    turns on stage 2 on ``device`` (``None``: the card, raising without
    CUDA; ``"cpu"`` times the plain versions).  ``check(kernel, config,
    out, fn, args)`` runs on each shortlisted candidate's first output
    before it is timed."""

    def __init__(self, cost_model=None, cache: Optional[TuningCache] = None,
                 *, dtype: str = "bf16", measure: bool = False,
                 top_k: int = 3, device_kind: Optional[str] = None,
                 measure_iters: int = 5, measure_warmup: int = 2,
                 allow_low_precision: bool = False, device=None,
                 check: Optional[Callable[..., None]] = None):
        if cost_model is None:
            from repro_torch.core.costmodel import CostModel
            cost_model = CostModel.from_named("hopper_h100")
        self.cost_model = cost_model
        self.cache = cache if cache is not None else TuningCache(None)
        self.dtype = canon_dtype(dtype)
        self.measure = measure
        self.top_k = top_k
        # opt-in: search reduced-precision axes (bf16 flash accumulator)
        self.allow_low_precision = allow_low_precision
        self.measure_iters = measure_iters
        self.measure_warmup = measure_warmup
        self.check = check
        self.device = None
        if measure:
            from repro_torch import resolve_device
            self.device = resolve_device(device)
        self.device_kind = device_kind or self._default_device_kind()
        self.stats = AutotuneStats()

    def _default_device_kind(self) -> str:
        """Analytic tunings are keyed by the modeled hardware (deterministic
        with no device); measured tunings by the device they were timed
        on: ``cuda-<the card's name>`` or ``cpu-cpu``."""
        if self.measure:
            import torch
            dev = self.device
            name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else dev.type)
            return f"{dev.type}-{name}".replace("|", "/")
        return f"analytic-{self.cost_model.hw.name}"

    # ----- keys --------------------------------------------------------------

    def key_for(self, kernel: str, shapes: Mapping[str, int],
                dtype: Optional[str] = None) -> str:
        tn = get_tunable(kernel)
        return entry_key(kernel, shape_bucket(tn.normalize_shapes(shapes)),
                         canon_dtype(dtype or self.dtype),
                         self.device_kind, self.cost_model.cal.name or "?")

    # ----- read side (the kernel dispatch path) ------------------------------

    def lookup(self, kernel: str, shapes: Mapping[str, int],
               dtype: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Cache-hit config for a concrete problem, else None.  Never
        tunes implicitly: dispatch stays one dict probe.  A kernel with no
        tunable entry resolves to None; a malformed shape dict for a KNOWN
        tunable still raises (a typo'd axis must not become a permanent
        silent miss)."""
        from repro_torch.core.autotune.space import TUNABLES
        if kernel not in TUNABLES:
            return None
        key = self.key_for(kernel, shapes, dtype)
        self.stats.lookups += 1
        entry = self.cache.get(key)
        if entry is None:
            self.stats.misses += 1
            return None
        self.stats.record_hit(key)
        return dict(entry["config"])

    def config_for(self, kernel: str, shapes: Mapping[str, int],
                   dtype: Optional[str] = None) -> Dict[str, Any]:
        """Tuned config when cached, else the kernel's effective default."""
        got = self.lookup(kernel, shapes, dtype)
        if got is not None:
            return got
        return get_tunable(kernel).effective_default(shapes)

    # ----- the search --------------------------------------------------------

    def tune(self, kernel: str, shapes: Optional[Mapping[str, int]] = None,
             dtype: Optional[str] = None) -> TuneResult:
        """Search one kernel's launch space and persist the winner.

        Whether the shortlist gets measured is fixed at construction
        (``measure=``), NOT per call: the cache's device_kind key component
        is derived from it, and a per-call override would store
        wall-time-measured winners under the analytic key (or vice versa)
        - exactly the cross-device leakage the key exists to prevent."""
        tn = get_tunable(kernel)
        shapes_n = tn.normalize_shapes(shapes)
        dt = canon_dtype(dtype or self.dtype)

        ranked = self._rank(tn, shapes_n, dt)
        default = tn.effective_default(shapes_n)
        default_row = next(r for r in ranked if r["config"] == default)

        best_row = ranked[0]
        measured_best = measured_default = None
        source = "analytic"
        shortlist = ranked[:max(self.top_k, 1)]
        if not any(r["config"] == default for r in shortlist):
            shortlist = shortlist + [default_row]
        # a shortlist of one leaves nothing to choose: it is not timed
        if self.measure and len(shortlist) > 1:
            for row in shortlist:
                row["measured_s"] = self._measure(tn, shapes_n, dt,
                                                  row["config"])
            best_row = min(shortlist, key=lambda r: r["measured_s"])
            measured_best = best_row["measured_s"]
            measured_default = default_row.get("measured_s")
            source = "measured"

        key = self.key_for(kernel, shapes_n, dt)
        result = TuneResult(
            kernel=kernel, shapes=shapes_n, dtype=dt, key=key,
            ranked=ranked, best=dict(best_row["config"]), default=default,
            predicted_best_s=best_row["predicted_s"],
            predicted_default_s=default_row["predicted_s"],
            measured_best_s=measured_best,
            measured_default_s=measured_default, source=source)
        self.cache.put(key, self._entry(result))
        self.stats.tunes += 1
        return result

    def tune_all(self, kernels: Optional[List[str]] = None,
                 shapes: Optional[Mapping[str, Mapping[str, int]]] = None,
                 dtype: Optional[str] = None) -> Dict[str, TuneResult]:
        """Tune every (or the named) tunable kernel; per-kernel shape
        overrides come from ``shapes[kernel]``."""
        out = {}
        for name in (kernels or tunable_names()):
            out[name] = self.tune(name, (shapes or {}).get(name),
                                  dtype=dtype)
        return out

    # ----- internals ---------------------------------------------------------

    def _rank(self, tn: Tunable, shapes: Dict[str, int], dtype: str
              ) -> List[Dict[str, Any]]:
        rows = []
        for cand in tn.candidates(
                shapes, dtype, SMEM_MAX,
                allow_low_precision=self.allow_low_precision):
            census = dict(tn.census(shapes, cand, dtype))
            mxu_shape = census.pop("mxu_shape", None)
            pred = self.cost_model.predict(census, dtype=dtype,
                                           mxu_shape=mxu_shape)
            rows.append({
                "config": dict(cand),
                "predicted_s": pred.step_s,
                "bottleneck": pred.bottleneck,
                "issue_overhead_s": pred.issue_overhead_s,
                "smem_bytes": tn.smem_bytes(shapes, cand, dtype),
            })
        # total, reproducible order: time then canonical config JSON
        rows.sort(key=lambda r: (r["predicted_s"],
                                 json.dumps(r["config"], sort_keys=True)))
        return rows

    def example_call(self, kernel: str, shapes: Dict[str, int], dtype: str,
                     config: Dict[str, Any]):
        """``(fn, args)``: the candidate's call through the port's entry
        point on inputs made for it on this tuner's device."""
        return example_call(kernel, shapes, dtype, config, self.device)

    def _measure(self, tn: Tunable, shapes: Dict[str, int], dtype: str,
                 config: Dict[str, Any]) -> float:
        import functools

        from repro_torch.core.microbench.harness import (cold_copies,
                                                         device_time)
        fn, args = self.example_call(tn.name, shapes, dtype, config)
        if self.check is not None:
            self.check(tn.name, config, fn(*args), fn, args)
        calls = [functools.partial(fn, *a) for a in
                 cold_copies(args, self.device, limit=self.measure_iters)]
        return device_time(calls, iters=self.measure_iters,
                           warmup=self.measure_warmup, device=self.device)

    def _entry(self, res: TuneResult) -> Dict[str, Any]:
        return {
            "kernel": res.kernel,
            "shapes": dict(res.shapes),
            "dtype": res.dtype,
            "device_kind": self.device_kind,
            "calibration_id": self.cost_model.cal.name or "?",
            "config": dict(res.best),
            "default_config": dict(res.default),
            "predicted_s": res.predicted_best_s,
            "predicted_default_s": res.predicted_default_s,
            "measured_s": res.measured_best_s,
            "measured_default_s": res.measured_default_s,
            "predicted_speedup": res.predicted_speedup,
            "source": res.source,
            "n_candidates": len(res.ranked),
            "candidates": [dict(row) for row in res.ranked[:_ENTRY_ROWS]],
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }


# ---------------------------------------------------------------------------
# measured-stage example calls (torch imported here only: the analytic
# path never builds a tensor)
# ---------------------------------------------------------------------------

def example_call(kernel: str, shapes: Dict[str, int], dtype: str,
                 config: Dict[str, Any], device):
    """The measured stage's call of ``kernel`` under ``config``: ``(fn,
    args)``, inputs drawn from numpy's generator at seed 0 as the
    reference's are and moved to ``device``.  The paged pools are bf16 on
    the card (the kernel takes only bf16 pools) and ``dtype`` elsewhere."""
    import functools

    import numpy as np
    import torch

    from repro_torch.kernels import ops

    dev = torch.device(device)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16}.get(dtype, torch.float32)
    rng = np.random.default_rng(0)

    def t(a, dt=tdt):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=dev, dtype=dt)

    def n(*s, dt=tdt):
        return t(rng.normal(size=s) * 0.3, dt)

    if kernel == "flash_attention":
        B, Sq, Skv = shapes["batch"], shapes["seq_q"], shapes["seq_kv"]
        H, KH, D = shapes["heads"], shapes["kv_heads"], shapes["head_dim"]
        args = (n(B, Sq, H, D), n(B, Skv, KH, D), n(B, Skv, KH, D))
        return functools.partial(ops.flash_attention, config=config), args
    if kernel == "paged_attention":
        B, H = shapes["batch"], shapes["heads"]
        KH, D, ctx = shapes["kv_heads"], shapes["head_dim"], shapes["ctx"]
        bs = int(config["block_size"])
        nb = -(-ctx // bs)                  # dense per-sequence page runs
        pdt = torch.bfloat16 if dev.type == "cuda" else tdt
        k_pages = n(B * nb, bs, KH, D, dt=pdt)
        v_pages = n(B * nb, bs, KH, D, dt=pdt)
        bt = torch.arange(B * nb, dtype=torch.int32,
                          device=dev).reshape(B, nb)
        ctx_lens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        # block_size is baked into the page layout above; chunk_tokens
        # (and num_splits) are launch parameters and must reach the
        # dispatch to be measured
        return (functools.partial(ops.paged_attention, config=config),
                (n(B, H, D), k_pages, v_pages, bt, ctx_lens))
    if kernel == "ssm_scan":
        B, S = shapes["batch"], shapes["seq"]
        Di, N = shapes["d_inner"], shapes["state_dim"]
        args = (n(B, S, Di), t(rng.uniform(1e-3, 0.1, (B, S, Di))),
                n(B, S, N), n(B, S, N),
                -t(np.abs(rng.normal(size=(Di, N))), torch.float32))
        return functools.partial(ops.ssm_scan, config=config), args
    if kernel == "wkv6":
        B, S = shapes["batch"], shapes["seq"]
        H, N = shapes["heads"], shapes["head_dim"]
        args = (n(B, S, H, N), n(B, S, H, N), n(B, S, H, N),
                t(rng.uniform(0.7, 0.999, (B, S, H, N))), n(H, N))
        return functools.partial(ops.wkv6, config=config), args
    if kernel == "mxu_probe":
        M, Kk, N = shapes["m"], shapes["k"], shapes["n"]
        args = (n(M, Kk), n(Kk, N))
        return functools.partial(ops.mxu_probe, chain=1, config=config), args
    raise KeyError(f"no example call for kernel {kernel!r}")
