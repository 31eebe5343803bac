"""The Hopper launch space: tunable-kernel registry, candidate generation,
and analytic per-candidate censuses.

The port's counterpart of ``repro.core.autotune.space``, with the same five
tunable names, ``shape_keys``, ``default_shapes``, ``shape_bucket``,
``divisor_clamp``, dedupe-after-clamping and the rule that the effective
default always survives pruning.  What differs is what a candidate is: on
the card a tunable's axes are the launch choices its CUDA kernel takes at
run time, and a candidate is pruned by that kernel's own shared-memory
footprint against ``SMEM_MAX`` (227 KB a block), not by a TPU's VMEM.

  * ``paged_attention`` - ``block_size`` (the pool's page size, a layout
    choice the paged engine reads when it builds its pool) x
    ``chunk_tokens`` in ``kernels.paged_attention.CHUNKS`` (the chunk
    kernel's token chunk); ``num_splits`` stays 1: it keeps its meaning on
    the CPU but changes no work on the card.  Footprint: the chunk block's
    ``chunk_smem_bytes(CT, D, G)`` (``csrc/paged_attention.cu``).
  * ``mxu_probe`` - ``(block_m, block_n)`` from the reference's ladder,
    kept where the CUDA probe takes them (multiples of 16 that divide the
    problem); footprint ``kernels.mxu_probe.smem_bytes`` at chain 1.
  * ``flash_attention`` - one candidate, the default (the kernel that
    ``kernels.flash_attention.kernel_for`` picks takes no other choice);
    with ``allow_low_precision`` also ``acc_dtype="bf16"`` x ``block_k``
    over the ladder, which selects ``csrc/flash_attention.cu``'s
    bf16-accumulator path (it honours ``block_k`` as the Pallas kernel
    does, up to 256 keys).  ``block_q`` stays at its default: the card's
    kernels run 64 query rows a block whatever it says.  Footprint:
    ``kernels.flash_attention.smem_bytes``.
  * ``ssm_scan``, ``wkv6`` - the effective default only.  ``csrc/ssm_scan.cu``
    fixes its steps unrolled together (``kUnroll``) at compile time and cuts
    its grid (8 channels a one-warp block) from the shapes alone, and
    ``csrc/wkv6.cu`` cuts its grid from the shapes alone, so neither
    ``block_d`` nor ``block_h`` changes the card's work: timing them would
    time one kernel several times.

``census`` builds the census-shaped dict ``CostModel.predict`` prices, pure
arithmetic with no device: FLOPs and HBM bytes, the grid the kernel
launches (``grid_cells``) and an op histogram.  Everything here is
deterministic: same shapes and calibration, same candidates in the same
order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mxu_probe as _mxu
from repro_torch.kernels import paged_attention as _pa

# the reference's block-size ladder (8 kept so tiny shapes still get more
# than one candidate)
_BLOCK_LADDER = (8, 16, 32, 64, 128, 256, 512)

# shared memory a Hopper block may use (227 KB)
SMEM_MAX = _mxu.SMEM_MAX
# threads of a paged chunk block (csrc kThreads)
_PA_THREADS = 128
# query rows of a flash block, and the f32 accumulator's KV tile
_FA_ROWS, _FA_SUB = _fa.ROWS, _fa.SUB
# channels of an ssm_scan block (csrc kChannels)
_SSM_CHANNELS = 8

_TORCH_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _dtype_bytes(dtype: str) -> int:
    return {"f32": 4, "float32": 4, "bf16": 2, "bfloat16": 2, "f16": 2,
            "float16": 2, "s8": 1, "int8": 1}.get(dtype, 4)


def divisor_clamp(value: int, n: int) -> int:
    """Largest launchable block for a divisor-constrained axis: min-clamp
    to the problem size, then fall back to a common divisor when it does
    not divide.  The one implementation the kernel dispatch
    (``kernels.ops``) and the candidate clamping share, so pricing
    describes the block that launches."""
    v = max(min(int(value), n), 1)
    return v if n % v == 0 else math.gcd(v, n)


def _blocks_upto(limit: int) -> List[int]:
    """Ladder values clamped to the problem size, deduped, ascending."""
    out = sorted({min(b, limit) for b in _BLOCK_LADDER})
    return out or [limit]


def _divisors_from_ladder(n: int) -> List[int]:
    out = sorted({math.gcd(min(b, n), n) for b in _BLOCK_LADDER})
    return [d for d in out if d >= 1]


@dataclass(frozen=True)
class Tunable:
    """One tunable kernel: its default problem and launch config, the
    candidate enumerator, the analytic census and the shared-memory
    footprint of a block."""
    name: str
    shape_keys: Tuple[str, ...]
    default_shapes: Dict[str, int]
    default_config: Dict[str, Any]
    enumerate_fn: Callable[..., List[Dict[str, Any]]]
    census_fn: Callable[[Dict[str, int], Dict[str, Any], str],
                        Dict[str, Any]]
    smem_fn: Callable[[Dict[str, int], Dict[str, Any], str], float]

    def normalize_shapes(self, shapes: Optional[Mapping[str, int]]
                         ) -> Dict[str, int]:
        out = dict(self.default_shapes)
        for k, v in (shapes or {}).items():
            if k not in self.shape_keys:
                raise KeyError(
                    f"{self.name}: unknown shape key {k!r} "
                    f"(expected {', '.join(self.shape_keys)})")
            out[k] = int(v)
        return out

    def candidates(self, shapes: Mapping[str, int], dtype: str = "bf16",
                   budget_bytes: Optional[float] = None,
                   allow_low_precision: bool = False
                   ) -> List[Dict[str, Any]]:
        """Enumerate the kernel's launch choices, clamp, dedupe on the
        clamped values, prune those over the shared-memory budget
        (``SMEM_MAX`` by default), and keep the default.
        ``allow_low_precision`` opens the bf16 flash accumulator: off by
        default, so tuning never trades numerics for speed unasked."""
        shapes = self.normalize_shapes(shapes)
        budget = SMEM_MAX if budget_bytes is None else budget_bytes
        seen, out = set(), []
        for cand in self.enumerate_fn(shapes, dtype, allow_low_precision):
            # clamp BEFORE deduping: two raw candidates (block_size 256
            # and 512 at ctx=128) can clamp onto one launched config
            cand = _clamp_config(self.name, shapes,
                                 {**self.default_config, **cand})
            key = tuple(sorted(cand.items()))
            if key in seen:
                continue
            seen.add(key)
            if self.smem_fn(shapes, cand, dtype) > budget:
                continue
            out.append(cand)
        default = self.effective_default(shapes)
        if not any(c == default for c in out):
            # the default must always be rankable: it is what launches
            # when no tuning entry exists
            out.insert(0, default)
        return out

    def effective_default(self, shapes: Mapping[str, int]) -> Dict[str, Any]:
        """The default config clamped as the dispatch clamps it."""
        shapes = self.normalize_shapes(shapes)
        return _clamp_config(self.name, shapes, self.default_config)

    def census(self, shapes: Mapping[str, int], config: Mapping[str, Any],
               dtype: str = "bf16") -> Dict[str, Any]:
        shapes = self.normalize_shapes(shapes)
        cfg = _clamp_config(self.name, shapes,
                            {**self.default_config, **dict(config)})
        return self.census_fn(shapes, cfg, dtype)

    def smem_bytes(self, shapes: Mapping[str, int],
                   config: Mapping[str, Any], dtype: str = "bf16") -> float:
        shapes = self.normalize_shapes(shapes)
        cfg = _clamp_config(self.name, shapes,
                            {**self.default_config, **dict(config)})
        return self.smem_fn(shapes, cfg, dtype)


def _clamp_config(kernel: str, shapes: Mapping[str, int],
                  config: Dict[str, Any]) -> Dict[str, Any]:
    """Mirror the dispatch's clamping (min-with-problem, divisor fallback)
    so dedupe and pricing see the launched values."""
    c = dict(config)
    if kernel == "flash_attention":
        c["block_q"] = max(min(int(c["block_q"]), shapes["seq_q"]), 1)
        c["block_k"] = max(min(int(c["block_k"]), shapes["seq_kv"]), 1)
    elif kernel == "paged_attention":
        # pages pad the context tail; any size up to the context launches
        c["block_size"] = max(min(int(c["block_size"]), shapes["ctx"]), 1)
        nb = -(-shapes["ctx"] // c["block_size"])
        c["num_splits"] = max(min(int(c.get("num_splits", 1)), nb), 1)
    elif kernel == "ssm_scan":
        c["block_d"] = divisor_clamp(c["block_d"], shapes["d_inner"])
    elif kernel == "wkv6":
        c["block_h"] = divisor_clamp(c["block_h"], shapes["heads"])
    elif kernel == "mxu_probe":
        c["block_m"] = divisor_clamp(c["block_m"], shapes["m"])
        c["block_n"] = divisor_clamp(c["block_n"], shapes["n"])
    return c


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _fa_enumerate(shapes, dtype, allow_low_precision=False):
    out = [{}]                               # the default
    if allow_low_precision:
        out += [{"acc_dtype": "bf16", "block_k": bk}
                for bk in _blocks_upto(shapes["seq_kv"]) if bk <= _fa.MAX_LK]
    return out


def _fa_launch(shapes, cfg, dtype):
    """(kernel, query rows a block, KV tile, element bytes) of the kernel
    ``kernel_for`` picks."""
    tdt = _TORCH_DTYPES.get(dtype, torch.float32)
    acc, D = cfg["acc_dtype"], shapes["head_dim"]
    kernel = _fa.kernel_for(tdt, acc, D)
    lk = _FA_SUB if acc == "f32" else cfg["block_k"]
    return kernel, lk, 2 if tdt == torch.bfloat16 else 4


def _fa_smem(shapes, cfg, dtype):
    kernel, lk, elem = _fa_launch(shapes, cfg, dtype)
    return float(_fa.smem_bytes(shapes["head_dim"], lk, kernel, elem))


def _fa_census(shapes, cfg, dtype):
    """The reference's FLOPs and HBM bytes over the card's tiles: 64 query
    rows a block (the tensor-core kernel: positions of one head; the
    CUDA-core one: the GQA group's heads x 64 / G positions) and the KV
    tile the kernel runs."""
    B, H, KH = shapes["batch"], shapes["heads"], shapes["kv_heads"]
    Sq, Skv, D = shapes["seq_q"], shapes["seq_kv"], shapes["head_dim"]
    kernel, lk, _ = _fa_launch(shapes, cfg, dtype)
    it = _dtype_bytes(dtype)
    if kernel == _fa.MMA:
        bq, cells = _FA_ROWS, B * H * -(-Sq // _FA_ROWS)
    else:
        bq = max(_FA_ROWS // max(H // max(KH, 1), 1), 1)
        cells = B * KH * -(-Sq // bq)
    nk = -(-Skv // lk)
    flops = 4.0 * B * H * Sq * Skv * D
    hbm = 2.0 * B * Sq * H * D * it + 2.0 * B * KH * Skv * D * it
    per_cell = {"dot": 2.0 * nk, "exponential": 2.0 * nk,
                "maximum": 2.0 * nk, "multiply": 3.0 * nk,
                "add": 2.0 * nk, "select": 1.0 * nk, "fusion": 1.0}
    hist = {k: v * cells for k, v in per_cell.items()}
    return {"flops": flops, "hbm_bytes": hbm, "op_histogram": hist,
            "grid_cells": float(cells), "mxu_shape": (_FA_ROWS, lk, D)}


# ---------------------------------------------------------------------------
# paged_attention (decode through a block table: the page size is a cache
# LAYOUT parameter the paged engine reads when it builds its pool; the
# chunk is a launch parameter the dispatch resolves)
# ---------------------------------------------------------------------------

def _pa_enumerate(shapes, dtype, allow_low_precision=False):
    return [{"block_size": bs, "chunk_tokens": ct, "num_splits": 1}
            for bs in _blocks_upto(shapes["ctx"]) for ct in _pa.CHUNKS]


def chunk_smem_bytes(CT: int, D: int, G: int) -> int:
    """Dynamic shared memory of one chunk block (``chunk_smem_bytes`` in
    ``csrc/paged_attention.cu``): K rows padded by 16 bytes a thread group,
    V rows, the G scaled query heads in f32, the G x CT scores and the
    chunk's table entries and positions."""
    kstride = D * 2 + 16 * (_PA_THREADS // CT)
    return CT * kstride + CT * D * 2 + G * D * 4 + G * CT * 4 + CT * 8


def _pa_smem(shapes, cfg, dtype):
    G = max(shapes["heads"] // max(shapes["kv_heads"], 1), 1)
    return float(chunk_smem_bytes(int(cfg["chunk_tokens"]),
                                  shapes["head_dim"], G))


def _pa_census(shapes, cfg, dtype):
    """The reference's FLOPs and page-granular K/V bytes (unsplit), over the
    card's grid: ``dim3(NC, KH, B)`` chunk blocks, ``NC = chunk_grid(NB, bs,
    CT)``, each staging its chunk's pages, then one merge block a (head,
    row) folding NC partial rows.  The partial (m, l, acc) rows are f32,
    ``B*H*NC*(D+2)*4`` bytes written and as many read back.  Small chunks
    fill more of the card's SMs (``grid_cells``) and cost more partial
    rows and more merge work; large ones the reverse."""
    B, H, KH = shapes["batch"], shapes["heads"], shapes["kv_heads"]
    D, ctx, bs = shapes["head_dim"], shapes["ctx"], cfg["block_size"]
    CT = int(cfg["chunk_tokens"])
    it = _dtype_bytes(dtype)
    nb = -(-ctx // bs)
    NC = _pa.chunk_grid(nb, bs, CT)
    cells = NC * KH * B
    flops = 4.0 * B * H * ctx * D
    hbm = 2.0 * B * KH * nb * bs * D * it + 2.0 * B * H * D * it \
        + B * nb * 4.0
    hbm += 2.0 * B * H * NC * (D + 2) * 4.0
    pages = -(-CT // bs)                     # pages a chunk gathers
    per_cell = {"dot": 2.0, "exponential": 2.0, "maximum": 2.0,
                "multiply": 3.0, "add": 2.0, "dynamic-slice": 2.0 * pages,
                "fusion": 1.0}
    hist = {k: v * cells for k, v in per_cell.items()}
    merge = B * H * NC                       # partial rows the merge folds
    for k, v in (("exponential", 1.0), ("maximum", 1.0),
                 ("multiply", 2.0), ("add", 2.0)):
        hist[k] += v * merge
    hist["fusion"] += 1.0
    return {"flops": flops, "hbm_bytes": hbm, "op_histogram": hist,
            "grid_cells": float(cells)}


# ---------------------------------------------------------------------------
# ssm_scan and wkv6: one candidate each (see the module docstring)
# ---------------------------------------------------------------------------

def _default_only(shapes, dtype, allow_low_precision=False):
    return [{}]


def _no_footprint(shapes, cfg, dtype):
    """One candidate, which survives any budget: no footprint to weigh."""
    return 0.0


def _ssm_census(shapes, cfg, dtype):
    """The reference's FLOPs and bytes over the card's grid: one block a
    row and 8 channels."""
    B, S = shapes["batch"], shapes["seq"]
    Di, N = shapes["d_inner"], shapes["state_dim"]
    it = _dtype_bytes(dtype)
    cells = B * -(-Di // _SSM_CHANNELS)
    flops = 6.0 * B * S * Di * N
    hbm = (3.0 * B * S * Di + 2.0 * B * S * N) * it + 4.0 * Di * N
    per_cell_step = {"exponential": 1.0, "multiply": 4.0, "add": 2.0,
                     "dot": 1.0}
    hist = {k: v * cells * S for k, v in per_cell_step.items()}
    hist["fusion"] = float(cells)
    return {"flops": flops, "hbm_bytes": hbm, "op_histogram": hist,
            "grid_cells": float(cells)}


def _wkv_census(shapes, cfg, dtype):
    """The reference's FLOPs and bytes over one cell a (row, head), the
    unit the card's grid is cut from."""
    B, S = shapes["batch"], shapes["seq"]
    H, N = shapes["heads"], shapes["head_dim"]
    it = _dtype_bytes(dtype)
    cells = B * H
    flops = 6.0 * B * S * H * N * N
    hbm = 5.0 * B * S * H * N * it + H * N * it
    per_cell_step = {"multiply": 4.0, "add": 2.0, "dot": 1.0}
    hist = {k: v * cells * S for k, v in per_cell_step.items()}
    hist["fusion"] = float(cells)
    return {"flops": flops, "hbm_bytes": hbm, "op_histogram": hist,
            "grid_cells": float(cells)}


# ---------------------------------------------------------------------------
# mxu_probe
# ---------------------------------------------------------------------------

def _mxu_enumerate(shapes, dtype, allow_low_precision=False):
    m, n = shapes["m"], shapes["n"]
    return [{"block_m": bm, "block_n": bn}
            for bm in _divisors_from_ladder(m)
            for bn in _divisors_from_ladder(n)
            if bm % 16 == 0 and bn % 16 == 0]


def _mxu_smem(shapes, cfg, dtype):
    tdt = _TORCH_DTYPES.get(dtype)
    if tdt is None:                          # the probe takes bf16 or f32
        return math.inf
    return float(_mxu.smem_bytes(tdt, shapes["k"], cfg["block_m"],
                                 cfg["block_n"], 1))


def _mxu_census(shapes, cfg, dtype):
    """The reference's census: each block re-reads its A-row and B-column
    panels."""
    M, K, N = shapes["m"], shapes["k"], shapes["n"]
    bm, bn = cfg["block_m"], cfg["block_n"]
    it = _dtype_bytes(dtype)
    cells = (-(-M // bm)) * (-(-N // bn))
    flops = 2.0 * M * K * N
    hbm = (cells * (bm * K + K * bn) + M * N) * it
    hist = {"dot": float(cells), "multiply": float(cells),
            "fusion": float(cells)}
    return {"flops": flops, "hbm_bytes": hbm, "op_histogram": hist,
            "mxu_shape": (bm, bn, K)}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

TUNABLES: Dict[str, Tunable] = {
    t.name: t for t in (
        Tunable(
            name="flash_attention",
            shape_keys=("batch", "seq_q", "seq_kv", "heads", "kv_heads",
                        "head_dim"),
            default_shapes={"batch": 4, "seq_q": 1024, "seq_kv": 1024,
                            "heads": 8, "kv_heads": 2, "head_dim": 128},
            default_config={"block_q": 128, "block_k": 128,
                            "acc_dtype": "f32"},
            enumerate_fn=_fa_enumerate,
            census_fn=_fa_census,
            smem_fn=_fa_smem,
        ),
        Tunable(
            name="paged_attention",
            shape_keys=("batch", "heads", "kv_heads", "head_dim", "ctx"),
            default_shapes={"batch": 8, "heads": 8, "kv_heads": 2,
                            "head_dim": 128, "ctx": 2048},
            default_config={"block_size": 16, "num_splits": 1,
                            "chunk_tokens": _pa.CHUNK_TOKENS},
            enumerate_fn=_pa_enumerate,
            census_fn=_pa_census,
            smem_fn=_pa_smem,
        ),
        Tunable(
            name="ssm_scan",
            shape_keys=("batch", "seq", "d_inner", "state_dim"),
            default_shapes={"batch": 4, "seq": 512, "d_inner": 2048,
                            "state_dim": 16},
            default_config={"block_d": 256},
            enumerate_fn=_default_only,
            census_fn=_ssm_census,
            smem_fn=_no_footprint,
        ),
        Tunable(
            name="wkv6",
            shape_keys=("batch", "seq", "heads", "head_dim"),
            default_shapes={"batch": 4, "seq": 512, "heads": 32,
                            "head_dim": 64},
            default_config={"block_h": 1},
            enumerate_fn=_default_only,
            census_fn=_wkv_census,
            smem_fn=_no_footprint,
        ),
        Tunable(
            name="mxu_probe",
            shape_keys=("m", "k", "n"),
            default_shapes={"m": 512, "k": 512, "n": 512},
            default_config={"block_m": 128, "block_n": 128},
            enumerate_fn=_mxu_enumerate,
            census_fn=_mxu_census,
            smem_fn=_mxu_smem,
        ),
    )
}


def get_tunable(kernel: str) -> Tunable:
    try:
        return TUNABLES[kernel]
    except KeyError:
        raise KeyError(f"unknown tunable kernel {kernel!r}; available: "
                       f"{', '.join(sorted(TUNABLES))}") from None


def tunable_names() -> List[str]:
    return sorted(TUNABLES)


def shape_bucket(shapes: Mapping[str, int]) -> str:
    """Canonical shape-bucket key: every axis rounded UP to a power of two
    (nearby problem sizes share one tuning entry), axes sorted by name."""
    parts = []
    for k in sorted(shapes):
        v = max(int(shapes[k]), 1)
        parts.append(f"{k}{1 << (v - 1).bit_length()}")
    return "_".join(parts)
