"""Cost-model-guided kernel autotuner with a persistent tuning cache, the
port's ``repro.core.autotune``.

Closes the paper's loop - measure (the calibration tables) -> model (the
cost model) -> **tune**: the launch choices the card's CUDA kernels take at
run time (``space``: the paged kernel's page size and token chunk, the
tensor-core probe's block, the flash kernel's opt-in bf16 accumulator and
its KV tile) are enumerated, pruned by each kernel's shared-memory
footprint, ranked analytically with ``CostModel.predict`` (no device,
deterministic) and optionally timed on the card; winners persist in a
schema-versioned JSON cache keyed by ``(kernel, shape-bucket, dtype,
device_kind, calibration_id)``, a document either package reads.

The dispatch side is a process-global handle: ``install`` an
:class:`Autotuner` (both serving engines do this around each step when
given one) and every ``repro_torch.kernels.ops`` wrapper called with
``tuned=True`` resolves its launch config through :func:`tuned_config`.

This ``__init__`` is lazy (PEP 562): the kernels' dispatch layer imports
``space`` without pulling ``search``, ``cache`` or the cost model into
every kernel import; those load on first attribute access.

CLI: ``python -m repro_torch.core.autotune tune --analytic-only --kernel
paged_attention`` (then ``show`` / ``export``) runs with no CUDA.
"""
from __future__ import annotations

import importlib
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional

# public name -> defining submodule (resolved on first access)
_EXPORTS = {
    "Autotuner": "search", "AutotuneStats": "search", "TuneResult": "search",
    "TuningCache": "cache", "DEFAULT_CACHE_PATH": "cache",
    "entry_key": "cache", "split_key": "cache",
    "TUNABLES": "space", "Tunable": "space", "get_tunable": "space",
    "shape_bucket": "space", "tunable_names": "space",
    "SMEM_MAX": "space", "divisor_clamp": "space",
}
_SUBMODULES = ("cache", "cli", "search", "space")


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(
            f"repro_torch.core.autotune.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.core.autotune.{name}")
    raise AttributeError(
        f"module 'repro_torch.core.autotune' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | set(_SUBMODULES))


# the process-global dispatch handle (None: every tuned=True lookup is a
# no-op and the kernels launch their defaults)
_ACTIVE = None


def install(tuner) -> Optional[Any]:
    """Make ``tuner`` the process-global autotuner; returns the previous
    one so callers can restore it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tuner
    return prev


def active():
    return _ACTIVE


@contextmanager
def using(tuner):
    """Scoped :func:`install`."""
    prev = install(tuner)
    try:
        yield tuner
    finally:
        install(prev)


def tuned_config(kernel: str, shapes: Mapping[str, int],
                 dtype: str = "bf16") -> Optional[Dict[str, Any]]:
    """The kernel-dispatch lookup: the installed autotuner's cached config
    for this problem, or None (kernel not tunable / no handle / no entry)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.lookup(kernel, shapes, dtype)
