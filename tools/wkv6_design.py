"""Design measurements of the RWKV6 recurrence kernel (``csrc/wkv6.cu``) on
one CUDA card; what ``PERF.md`` cites for the kernel's design.  Not part of
the package: run from the repository's root,

  PYTHONPATH=src python tools/wkv6_design.py [--parts chunk,unroll,...]

prints one JSON object with the card's name, the parts asked for (all by
default) and ``ptxas``, every build's ``ptxas -v`` lines.

Parts that compare builds (``VARIANTS``) compile copies of the kernel's
source with one change each (text substitutions, checked to apply), call
each through the wrapper in turns in one process (A, B, ..., then in
reverse, twice), and report for each build:

* ``ms``: one call between a CUDA event pair at the eval shape (B=4,
  S=4096, H=32, N=64, bf16, ``chip_smoke.WKV_CASES`` "short"), median of
  10, as ``chip_smoke.py`` times it; ``device_ms``: 20 calls queued behind
  a device sleep between one event pair, over 20 (the host's share
  hidden), median of 5;
* ``accuracy``: against the plain version on "short" and "long" at the
  eval shape in bf16, and "long" at B=1 in f32: the largest |out - want|
  over ``REC_TOL`` (|want| + max|want|) and the share of outputs not
  bit-equal to the plain version's.

They are: ``chunk``, 8 or 16 (the kernel) steps a chunk; ``ahead``, a
step's shared loads issued 0 (the kernel), 1 or 2 steps ahead of it;
``reduce``, the partial sums through the shared tile (the kernel) or
first halved by one shuffle between the two lanes of a compute warp that
hold the same columns; ``tile``, 4 (the kernel) or 8 state rows a compute
thread (8: half the compute warps, one on each scheduler, and half the
partial sums); ``probes``, builds that are not the function: the steps'
partial sums not stored (``no_partials``: their FMAs go too), stored
only where a partial sum is 1234.5 (``rare_partials``: the FMAs stay),
no y made after the chunk (``no_reduce``), and the steps' shared loads
of r, k and w replaced by the step's first row (``row0_loads``).

``trace`` runs one eval-shape bf16 launch of a traced build: each block's
SM, start and end (``%globaltimer``), and the clock64() cycles of compute
thread 0 and reducer 0 summed over the chunks in their phases
(``PHASES``); it reports the kernel's span, the blocks a SM ran at once,
and the median block's cycles a chunk in each phase.

``sass`` writes the kernel's ``cuobjdump -sass`` into ``wkv6.sass`` in
``chip_smoke.py``'s output directory and gives its opcode mix.  Builds go
to ``kernels/build/`` beside the kernels' own.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as twkv

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_STEPS = "constexpr int kSteps = 16;     // steps a chunk"
# the steps as the kernel runs them, and with each step's shared loads
# issued kAhead steps before it (a ring of registers)
_STEPS_NOW = (
    "      if (tile) {\n"
    "#pragma unroll\n"
    "        for (int tt = 0; tt < kSteps; ++tt) {\n"
    "          float ri[kTileR], ki[kTileR], wi[kTileR], vj[kTile], p[kTile];\n"
    "          load_f32<kTileR>(&sm.r[s][tt][kTileR * rg], ri);\n"
    "          load_f32<kTileR>(&sm.k[s][tt][kTileR * rg], ki);\n"
    "          load_f32<kTileR>(&sm.w[s][tt][kTileR * rg], wi);\n"
    "          load_f32<kTile>(&sm.v[s][tt][kTile * cg], vj);\n"
    "#pragma unroll\n"
    "          for (int j = 0; j < kTile; ++j) {\n"
    "            p[j] = ri[0] * st[0][j];\n"
    "#pragma unroll\n"
    "            for (int i = 1; i < kTileR; ++i)\n"
    "              p[j] = fmaf(ri[i], st[i][j], p[j]);\n"
    "          }\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < kTileR; ++i)\n"
    "#pragma unroll\n"
    "            for (int j = 0; j < kTile; ++j)\n"
    "              st[i][j] = fmaf(wi[i], st[i][j], ki[i] * vj[j]);\n"
    "          *reinterpret_cast<float4*>(&sm.part[b][tt][rg][kTile * cg]) =\n"
    "              make_float4(p[0], p[1], p[2], p[3]);\n"
    "        }\n"
    "      }\n"
)
_STEPS_AHEAD = (
    "      if (tile) {\n"
    "        // r, k, w, v of the steps in flight\n"
    "        float ri[kAhead + 1][kTileR], ki[kAhead + 1][kTileR];\n"
    "        float wi[kAhead + 1][kTileR], vj[kAhead + 1][kTile];\n"
    "        auto load = [&](int tt) {\n"
    "          const int x = tt % (kAhead + 1);\n"
    "          load_f32<kTileR>(&sm.r[s][tt][kTileR * rg], ri[x]);\n"
    "          load_f32<kTileR>(&sm.k[s][tt][kTileR * rg], ki[x]);\n"
    "          load_f32<kTileR>(&sm.w[s][tt][kTileR * rg], wi[x]);\n"
    "          load_f32<kTile>(&sm.v[s][tt][kTile * cg], vj[x]);\n"
    "        };\n"
    "#pragma unroll\n"
    "        for (int tt = 0; tt < kAhead; ++tt) load(tt);\n"
    "#pragma unroll\n"
    "        for (int tt = 0; tt < kSteps; ++tt) {\n"
    "          if (tt + kAhead < kSteps) load(tt + kAhead);\n"
    "          const int x = tt % (kAhead + 1);\n"
    "          float p[kTile];\n"
    "#pragma unroll\n"
    "          for (int j = 0; j < kTile; ++j) {\n"
    "            p[j] = ri[x][0] * st[0][j];\n"
    "#pragma unroll\n"
    "            for (int i = 1; i < kTileR; ++i)\n"
    "              p[j] = fmaf(ri[x][i], st[i][j], p[j]);\n"
    "          }\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < kTileR; ++i)\n"
    "#pragma unroll\n"
    "            for (int j = 0; j < kTile; ++j)\n"
    "              st[i][j] = fmaf(wi[x][i], st[i][j], ki[x][i] * vj[x][j]);\n"
    "          *reinterpret_cast<float4*>(&sm.part[b][tt][rg][kTile * cg]) =\n"
    "              make_float4(p[0], p[1], p[2], p[3]);\n"
    "        }\n"
    "      }\n"
)
_TILE_R = "constexpr int kTileR = 4; "
_PART = ("          *reinterpret_cast<float4*>(&sm.part[b][tt][rg][kTile * cg]) =\n"
         "              make_float4(p[0], p[1], p[2], p[3]);\n")
_LOADS = ("          load_f32<kTileR>(&sm.r[s][tt][kTileR * rg], ri);\n"
          "          load_f32<kTileR>(&sm.k[s][tt][kTileR * rg], ki);\n"
          "          load_f32<kTileR>(&sm.w[s][tt][kTileR * rg], wi);\n")
_STORE = "    if (t < S) store4(yq + t * stride, yv);\n"
# one level of shuffle first: lanes CG apart hold the same 4 columns of
# row groups 2m and 2m + 1; each keeps 2 columns' sum of the pair and
# stores it over the pair's tile rows, so the tile is read at half width
_SHUFFLE = [
    (_PART,
     "          {\n            const bool hi = rg & 1;\n"
     "            float keep[2];\n"
     "#pragma unroll\n            for (int j = 0; j < 2; ++j)\n"
     "              keep[j] = (hi ? p[2 + j] : p[j]) +\n"
     "                  __shfl_xor_sync(0xffffffffu, hi ? p[j] : p[2 + j],"
     " CG);\n"
     "            *reinterpret_cast<float2*>(\n"
     "                &sm.part[b][tt][rg & ~1][kTile * cg + 2 * hi]) =\n"
     "                make_float2(keep[0], keep[1]);\n          }\n"),
    ("&sm.part[b][tt][1][kTile * g]", "&sm.part[b][tt][2][kTile * g]"),
    ("    for (int j = 2; j < RG; j += 2) {",
     "    for (int j = 4; j < RG; j += 4) {"),
    ("&sm.part[b][tt][j + 1][kTile * g]", "&sm.part[b][tt][j + 2][kTile * g]"),
]

VARIANTS = {
    "chunk": {f"steps_{n}": ([] if n == 16 else
                             [(_STEPS, f"constexpr int kSteps = {n};")])
              for n in (8, 16)},
    "ahead": {f"ahead_{n}": ([] if n == 0 else
                             [(_STEPS_NOW,
                               _STEPS_AHEAD.replace("kAhead", str(n)))])
              for n in (0, 1, 2)},
    "reduce": {"tile": [], "shuffle_then_tile": _SHUFFLE},
    "tile": {"rows_4": [],
             "rows_8": [(_TILE_R, _TILE_R.replace("4", "8", 1))]},
    "probes": {"kernel": [], "no_partials": [(_PART, "")],
               "rare_partials": [(_PART,
                                  "      if (p[0] == 1234.5f)\n" + _PART)],
               "no_reduce": [(_STORE, "")],
               "row0_loads": [(_LOADS, _LOADS.replace("kTileR * rg", "0"))]},
}
EVAL = (4, 4096, 32, 64)


PTXAS: dict = {}       # build name -> its ptxas -v lines


def _source(subs, name="") -> str:
    src = (_build.CSRC / "wkv6.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def _compile_lib(name: str, src: str) -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{name}.cu"
    lib = _build.BUILD_DIR / f"lib{name}.so"
    path.write_text(src)
    proc = subprocess.run([_build._tool("nvcc"), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(path)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    PTXAS[name] = [ln.strip() for ln in (proc.stdout + proc.stderr)
                   .splitlines() if "registers" in ln or "spill" in ln
                   or "Compiling entry" in ln]
    return ctypes.CDLL(str(lib))


def _bind(lib: ctypes.CDLL):
    fn = lib.wkv6_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
    fn.restype = I
    return fn


def _compile(name: str, subs):
    return _bind(_compile_lib(f"wkv6_{name}", _source(subs, name)))


def _device_ms(fn, n=20, reps=5) -> float:
    """ms a call: n calls queued behind a device sleep between a CUDA event
    pair, over n; the median of ``reps``."""
    runs = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        runs.append(e0.elapsed_time(e1) / n)
    return statistics.median(runs[1:])


def _accuracy(out, want) -> dict:
    tol = chip_smoke.REC_TOL[str(out.dtype).split(".")[-1]]
    w = want.float()
    scale = tol * (w.abs() + w.abs().max())
    return {"tol_ratio": ((out.float() - w).abs() / scale).max().item(),
            "mismatch": (out != want).float().mean().item()}


def compare(part: str) -> dict:
    with ThreadPoolExecutor(max_workers=len(VARIANTS[part])) as pool:
        futures = {name: pool.submit(_compile, f"{part}_{name}", subs)
                   for name, subs in VARIANTS[part].items()}
        builds = {name: f.result() for name, f in futures.items()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for case, shape, dtype in (("short", EVAL, torch.bfloat16),
                               ("long", EVAL, torch.bfloat16),
                               ("long_f32", (1,) + EVAL[1:], torch.float32)):
        args = chip_smoke.wkv_inputs(torch, g, dev, *shape, dtype,
                                     case.split("_")[0])
        cases[case] = (args, ref.wkv6_plain(*args))
    short = cases["short"][0]
    res = {name: {"ms": [], "device_ms": [], "accuracy": {}}
           for name in builds}
    order = list(builds)
    for name in (order + order[::-1]) * 2:
        twkv._fn = builds[name]
        r = res[name]
        for case, (args, want) in cases.items():
            out = ops.wkv6(*args)
            torch.cuda.synchronize()
            r["accuracy"][case] = _accuracy(out, want)
        r["ms"].append(chip_smoke.gpu_ms(torch, lambda: ops.wkv6(*short),
                                         10))
        r["device_ms"].append(_device_ms(lambda: ops.wkv6(*short)))
    twkv._fn = None
    return res


# per-block timing: %smid and %globaltimer at the compute warps' start
# and the reducers' end, and clock64() cycles summed over the chunks for
# compute thread 0 (PHASES[:3]) and reducer 0 (PHASES[3:])
_TRACE = [
    ("namespace {\n", "namespace {\n__device__ long long g_trace[10 * 4096];\n"),
    ("  if (threadIdx.x < NC) {\n",
     "  long long ph[4] = {}, trace_t0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(trace_t0));\n"
     "  long long* trace_o = g_trace + 10 * blockIdx.x;\n"
     "  if (threadIdx.x < NC) {\n"),
    ("      if (c >= 2) bar_sync(kBarEmpty + b, kBoth);\n",
     "      const long long q0 = clock64();\n"
     "      if (c >= 2) bar_sync(kBarEmpty + b, kBoth);\n"),
    ("      cp_wait<2>();                              // this thread's chunk c\n",
     "      const long long q1 = clock64();\n"
     "      cp_wait<2>();\n"),
    ("      if (tile) {\n",
     "      const long long q2 = clock64();\n      if (tile) {\n"),
    ("      bar_arrive(kBarFull + b, kBoth);           // tile b holds chunk c\n",
     "      ph[0] += q1 - q0;\n      ph[1] += q2 - q1;\n"
     "      ph[2] += clock64() - q2;\n"
     "      bar_arrive(kBarFull + b, kBoth);\n"),
    ("    return;\n",
     "    if (tid == 0 && blockIdx.x < 4096) {\n"
     "      unsigned smid;\n"
     "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "      trace_o[0] = smid;\n      trace_o[1] = trace_t0;\n"
     "      for (int i = 0; i < 3; ++i) trace_o[3 + i] = ph[i];\n    }\n"
     "    return;\n"),
    ("    bar_sync(kBarFull + b, kBoth);               // chunk c's partials\n",
     "    const long long q0 = clock64();\n"
     "    bar_sync(kBarFull + b, kBoth);\n"
     "    const long long q1 = clock64();\n"),
    ("    const float yv[kTile] = {fmaf(at, vq[0], even.x + odd.x),\n",
     "    const long long q2 = clock64();\n"
     "    const float yv[kTile] = {fmaf(at, vq[0], even.x + odd.x),\n"),
    ("    if (t < S) store4(yq + t * stride, yv);\n  }\n}\n",
     "    if (t < S) store4(yq + t * stride, yv);\n"
     "    ph[0] += q1 - q0;\n    ph[1] += q2 - q1;\n"
     "    ph[2] += clock64() - q2;\n  }\n"
     "  if (q == 0 && blockIdx.x < 4096) {\n"
     "    long long t1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
     "    trace_o[2] = t1;\n"
     "    for (int i = 0; i < 3; ++i) trace_o[6 + i] = ph[i];\n  }\n}\n"),
]
PHASES = ("empty_wait_stage", "copy_wait_barrier", "steps",
          "full_wait", "read_sum", "y_store")


def trace() -> dict:
    """One eval-shape bf16 launch of a traced build: the kernel's span,
    the blocks' durations, the most blocks one SM ran at once, and the
    median block's cycles a chunk in each phase."""
    src = _source(_TRACE, "trace") + (
        '\nextern "C" int wkv6_trace(long long* h) {\n'
        '  return (int)cudaMemcpyFromSymbol(h, g_trace, 10 * 4096 * 8);\n}\n')
    lib = _compile_lib("wkv6_trace", src)
    lib.wkv6_trace.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    args = chip_smoke.wkv_inputs(torch, g, dev, *EVAL, torch.bfloat16,
                                 "short")
    twkv._fn = _bind(lib)
    for _ in range(3):
        ops.wkv6(*args)
    torch.cuda.synchronize()
    twkv._fn = None
    blocks = EVAL[0] * EVAL[2] * 2
    buf = (ctypes.c_longlong * (10 * 4096))()
    if lib.wkv6_trace(ctypes.addressof(buf)):
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    rows = [buf[10 * i:10 * i + 10] for i in range(blocks)]
    t0 = min(r[1] for r in rows)
    t1 = max(r[2] for r in rows)
    events = sorted([(r[1], 1, r[0]) for r in rows] +
                    [(r[2], -1, r[0]) for r in rows])
    live, most = {}, 0
    for _, d, sm in events:
        live[sm] = live.get(sm, 0) + d
        most = max(most, live[sm])
    chunks = -(-EVAL[1] // 16)
    med = {name: statistics.median(r[3 + i] for r in rows) / chunks
           for i, name in enumerate(PHASES)}
    return {"span_us": (t1 - t0) / 1e3,
            "block_us": {"min": min(r[2] - r[1] for r in rows) / 1e3,
                         "median": statistics.median(
                             r[2] - r[1] for r in rows) / 1e3,
                         "max": max(r[2] - r[1] for r in rows) / 1e3},
            "sms": len({r[0] for r in rows}), "most_blocks_an_sm": most,
            "cycles_a_chunk": med}


def sass(path: Path) -> dict:
    """The kernel's SASS (``cuobjdump -sass``) into ``path``; the opcode
    mix of each instance."""
    lib = _build.build("wkv6")
    tool = _build.shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(proc.stdout)
    return _build.sass_mix("wkv6", top=16)


PARTS = tuple(VARIANTS) + ("trace", "sass")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS}")
    parts = ap.parse_args(argv).parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_design needs a CUDA card")
    out = {"card": torch.cuda.get_device_name(0)}
    for part in parts:
        if part == "sass":
            out[part] = sass(chip_smoke.OUT / "wkv6.sass")
        elif part == "trace":
            out[part] = trace()
        else:
            out[part] = compare(part)
    out["ptxas"] = PTXAS
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
