"""Design measurements of the CUDA-core flash-attention kernel
(``csrc/flash_attention.cu``) on one CUDA card; what ``PERF.md`` cites for
the kernel's design.  Not part of the package: run from the repository's
root,

  PYTHONPATH=src python tools/flash_attention_design.py [--parts stages,...]

prints one JSON object with the card's name, the parts asked for (all by
default) and ``ptxas``, every build's ``ptxas -v`` lines.

Parts that compare builds (``VARIANTS``) compile copies of the kernel's
source with one change each (text substitutions, checked to apply), call
each through the wrapper in turns in one process (A, B, ..., then in
reverse, twice), and report for each build ``stream_ms``: 20 calls back to
back between a CUDA event pair, over 20, median of 5, at the f32 prefill
case (B=1, Sq=Skv=900, H=8, KH=4, D=256, causal) and at Sq=Skv=4096
(balanced: many items an SM), and ``max_rel``: the largest |out - want| /
max|want| against the plain version at 900 (probes are not the function).
They are: ``stages``, 2, 3 or 4 (the kernel) slots of the cp.async ring;
``layout``, a K slab row of 64 + 16 (the kernel: each key 16 banks from
the last, so the 8 lanes of a quarter-warp read 8 bank-disjoint chunks)
or 64 + 8 floats (``k72``, the first design: two lanes of a
quarter-warp on one bank group); ``branches``, the first design's
guards back in the products: a branch around each V chunk's load
(``pv_branch``: a column chunk past D skipped) and around each score
chunk (``s_guard``: the guarded slab path for full slabs too);
``unroll``, the score slab's 4 chunk steps one a trip (the kernel) or
unrolled (``t_4``: more loads in flight, registers spilled), and P V's
16 keys a slab unrolled (the kernel) or 4 a trip (``kk_4``);
``probes``, builds that are not the function: the score product with one
FFMA of its four a chunk (``s_quarter``), the P V product with one column
of its four (``pv_quarter``), every lane reading the same Q chunk
(``q_same``) or the same K chunk (``k_same``) a score load, and the
slabs not copied (``no_copy``: the ring's instructions and memory
traffic gone, its barriers kept).

``sass`` writes the kernel's ``cuobjdump -sass`` into
``flash_attention.sass`` in ``chip_smoke.py``'s output directory and gives
each instance's opcode mix.

``split_warps`` compares the kernel, in turns as above, with
``tools/flash_attention_ws.cu``: the same function with 8 score warps
(8 x 8 score micro-tiles, a row's softmax in one warp) beside 8 P V warps
(8 x 8 of O), each group on its own ring, P handed over through two
buffers and named barriers (its header).

``items`` calls the kernel itself with the split's aim (``ITEMS_PER_SM``)
at 1, 2 (the wrapper's), 4, 8 and 16 items an SM, in turns.

``trace`` runs one launch of a traced build at each case: each block's
SM, start and end (``%globaltimer``), and thread 0's clock64() cycles in
the tile loop's phases (``PHASES``: the scores with their slab waits, the
softmax step with its two barriers, P V with its slab waits, and the slab
waits alone); it reports the kernel's span, the blocks' durations, and
the cycles a KV tile in each phase (median block).
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

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_STAGES = "constexpr int kStages = 4;"
_S_FMA = ("          a = fmaf(qa[j].x, kb.x, a);\n"
          "          a = fmaf(qa[j].y, kb.y, a);\n"
          "          a = fmaf(qa[j].z, kb.z, a);\n"
          "          sacc[j][ii] = fmaf(qa[j].w, kb.w, a);\n")
_PV_FMA = ("              acc[j][4 * u] = fmaf(pa[j], vv.x, acc[j][4 * u]);\n"
           "              acc[j][4 * u + 1] = fmaf(pa[j], vv.y, acc[j][4 * u + 1]);\n"
           "              acc[j][4 * u + 2] = fmaf(pa[j], vv.z, acc[j][4 * u + 2]);\n"
           "              acc[j][4 * u + 3] = fmaf(pa[j], vv.w, acc[j][4 * u + 3]);\n")
_COPY = "          cp_async16(dst + key * kLdK + c, src, ok);\n"
_LDK = "constexpr int kLdK = kSlabD + 16;"
_V_LOAD = "          const float4 vv = ld4(vt + kk * ldv + vcol[u]);\n"
_S_FULL = "        if (nch == kSlabD / 4)\n"
_T_LOOP = "#pragma unroll 1\n  for (int t = 0; t < kSlabD / 16; ++t) {\n"
_KK_LOOP = "#pragma unroll\n      for (int kk = 0; kk < kSlabV; ++kk) {\n"
_COPY_V = "          cp_async16(dst + key * ldv + c, src, ok);\n"

VARIANTS = {
    "stages": {f"stages_{n}": ([] if n == 4 else
                               [(_STAGES, f"constexpr int kStages = {n};")])
               for n in (2, 3, 4)},
    "layout": {"kernel": [],
               "k72": [(_LDK, "constexpr int kLdK = kSlabD + 8;")]},
    "branches": {"kernel": [],
                 "pv_branch": [(_V_LOAD,
                                "          if (!colok[u]) continue;\n"
                                "          const float4 vv = ld4(vt + kk"
                                " * ldv + 4 * (cg + 32 * u));\n")],
                 "s_guard": [(_S_FULL, "        if (nch < 0)\n")]},
    "unroll": {"kernel": [],
               "t_4": [(_T_LOOP, _T_LOOP.replace("unroll 1", "unroll"))],
               "kk_4": [(_KK_LOOP, _KK_LOOP.replace("unroll", "unroll 4"))]},
    "probes": {"kernel": [],
               "s_quarter": [(_S_FMA,
                              "          sacc[j][ii] = fmaf(qa[j].x"
                              " + qa[j].y + qa[j].z + qa[j].w, kb.x,"
                              " sacc[j][ii]);\n")],
               "pv_quarter": [(_PV_FMA,
                               "              acc[j][4 * u] = fmaf(pa[j],"
                               " vv.x + vv.y + vv.z + vv.w, acc[j][4 * u]);\n")],
               "q_same": [("      for (int j = 0; j < 4; ++j) qa[j] = ld4(qs + j * ldq"
                           " + 4 * c);\n",
                           "      for (int j = 0; j < 4; ++j) qa[j] = ld4(qs + j * ldq"
                           " + 16 * t);\n")],
               "k_same": [("        const float4 kb = ld4(kt + (kg + 8 * ii) * kLdK"
                           " + 4 * c);\n",
                           "        const float4 kb = ld4(kt + 8 * ii * kLdK"
                           " + 16 * t);\n")],
               "no_copy": [(_COPY, "          if (ok && kp < 0) cp_async16("
                                   "dst + key * kLdK + c, src, ok);\n"),
                           (_COPY_V, "          if (ok && kp < 0) cp_async16("
                                     "dst + key * ldv + c, src, ok);\n")]},
}
CASES = {"900": (1, 900, 900, 8, 4, 256), "4096": (1, 4096, 4096, 8, 4, 256)}

PTXAS: dict = {}       # build name -> its ptxas -v lines


def _source(subs, name="") -> str:
    src = (_build.CSRC / "flash_attention.cu").read_text()
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
    fn = lib.flash_attention_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, P, P, P] + [I] * 13 + [F, I, I, F, P]
    fn.restype = I
    return fn


def _inputs(shape):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, Sq, Skv, H, KH, D = shape
    return [torch.randn((B, S, h, D), generator=g, device=dev)
            for S, h in ((Sq, H), (Skv, KH), (Skv, KH))]


WS_SOURCE = ROOT / "tools" / "flash_attention_ws.cu"


def compare(part: str) -> dict:
    if part == "split_warps":     # the kernel beside the two-group variant
        sources = {"kernel": _source([]), "split_warps": WS_SOURCE.read_text()}
    else:
        sources = {name: _source(subs, name)
                   for name, subs in VARIANTS[part].items()}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {name: pool.submit(
            lambda n, src: _bind(_compile_lib(f"fa_{part}_{n}", src)),
            name, src) for name, src in sources.items()}
        builds = {name: f.result() for name, f in futures.items()}
    data = {case: _inputs(shape) for case, shape in CASES.items()}
    want = ref.flash_attention_plain(*data["900"])
    res = {name: {"stream_ms": {c: [] for c in CASES}, "max_rel": None}
           for name in builds}
    order = list(builds)
    for name in (order + order[::-1]) * 2:
        fa._fns[fa.SIMT] = builds[name]
        r = res[name]
        out = fa.flash_attention(*data["900"])
        torch.cuda.synchronize()
        r["max_rel"] = ((out - want).abs().max()
                        / want.abs().max()).item()
        for case, args in data.items():
            r["stream_ms"][case].append(chip_smoke.stream_ms(
                torch, lambda: fa.flash_attention(*args)))
    fa._fns.pop(fa.SIMT)
    return res


def items() -> dict:
    data = {case: _inputs(shape) for case, shape in CASES.items()}
    aims, aim = (1, 2, 4, 8, 16), fa.ITEMS_PER_SM
    res = {n: {"stream_ms": {c: [] for c in CASES}, "T_smax": {}}
           for n in aims}
    for n in (aims + aims[::-1]) * 2:
        fa.ITEMS_PER_SM = n
        fa.work_split.cache_clear()
        for case, args in data.items():
            sp = fa.work_split(*CASES[case][:5])
            res[n]["T_smax"][case] = (sp.T, sp.smax)
            res[n]["stream_ms"][case].append(chip_smoke.stream_ms(
                torch, lambda: fa.flash_attention(*args)))
    fa.ITEMS_PER_SM = aim
    fa.work_split.cache_clear()
    return {str(n): r for n, r in res.items()}


_NROW = 8
_TRACE = [
    ("namespace {\n",
     f"namespace {{\n__device__ long long g_trace[{_NROW} * 65536];\n"),
    ("  int cur = 0;   // the slab the block computes next\n",
     "  long long ph[4] = {0, 0, 0, 0}, trace_t0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(trace_t0));\n"
     "  int cur = 0;   // the slab the block computes next\n"),
    ("    cp_async_wait<kStages - 2>();\n    __syncthreads();\n",
     "    const long long w0 = clock64();\n"
     "    cp_async_wait<kStages - 2>();\n    __syncthreads();\n"
     "    ph[3] += clock64() - w0;\n"),
    ("    float tmax[2] = {kNegInf, kNegInf};\n",
     "    const long long c0 = clock64();\n"
     "    float tmax[2] = {kNegInf, kNegInf};\n"),
    ("    // 2. the online-softmax step",
     "    const long long c1 = clock64();\n    ph[0] += c1 - c0;\n"
     "    // 2. the online-softmax step"),
    ("    // 3. acc = acc * alpha + P @ V",
     "    const long long c2 = clock64();\n    ph[1] += c2 - c1;\n"
     "    // 3. acc = acc * alpha + P @ V"),
    ("    if constexpr (BF16ACC) {\n#pragma unroll\n      for (int j = 0;",
     "    ph[2] += clock64() - c2;\n"
     "    if constexpr (BF16ACC) {\n#pragma unroll\n      for (int j = 0;"),
    ("  // the rows' (m, l) to shared memory",
     "  if (tid == 0 && blockIdx.x < 65536) {\n"
     "    long long t1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
     "    unsigned smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     f"    long long* o = g_trace + {_NROW} * blockIdx.x;\n"
     "    o[0] = smid; o[1] = trace_t0; o[2] = t1;\n"
     "    for (int e = 0; e < 4; ++e) o[3 + e] = ph[e];\n"
     "    o[7] = je - jb;\n  }\n"
     "  // the rows' (m, l) to shared memory"),
]
PHASES = ("scores", "softmax", "pv", "slab_waits")


def trace() -> dict:
    src = _source(_TRACE, "trace") + (
        '\nextern "C" int fa_trace(long long* h, int n) {\n'
        '  return (int)cudaMemcpyFromSymbol(h, g_trace, n * 8);\n}\n')
    lib = _compile_lib("fa_trace", src)
    lib.fa_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fa._fns[fa.SIMT] = _bind(lib)
    out = {}
    for case, shape in CASES.items():
        args = _inputs(shape)
        sp = fa.work_split(*shape[:5])
        blocks = shape[0] * shape[4] * sp.nq * sp.smax
        for _ in range(3):
            fa.flash_attention(*args)
        torch.cuda.synchronize()
        n = _NROW * min(blocks, 65536)
        buf = (ctypes.c_longlong * n)()
        if lib.fa_trace(ctypes.addressof(buf), n):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        rows = [buf[_NROW * i:_NROW * i + _NROW]
                for i in range(min(blocks, 65536))]
        rows = [r for r in rows if r[1] and r[7] > 0]   # live items
        t0 = min(r[1] for r in rows)
        t1 = max(r[2] for r in rows)
        events = sorted([(r[1], 1, r[0]) for r in rows] +
                        [(r[2], -1, r[0]) for r in rows])
        live, most = {}, 0
        for _, d, sm in events:
            live[sm] = live.get(sm, 0) + d
            most = max(most, live[sm])
        busy = {}
        for r in rows:
            busy[r[0]] = busy.get(r[0], 0) + r[2] - r[1]
        out[case] = {
            "T": sp.T, "smax": sp.smax, "items": len(rows),
            "span_us": (t1 - t0) / 1e3,
            "sm_busy_us": {"min": min(busy.values()) / 1e3,
                           "median": statistics.median(busy.values()) / 1e3,
                           "max": max(busy.values()) / 1e3},
            "sms": len(busy), "most_blocks_an_sm": most,
            "block_us": {"min": min(r[2] - r[1] for r in rows) / 1e3,
                         "median": statistics.median(
                             r[2] - r[1] for r in rows) / 1e3,
                         "max": max(r[2] - r[1] for r in rows) / 1e3},
            "cycles_a_tile": {name: statistics.median(
                r[3 + e] / r[7] for r in rows)
                for e, name in enumerate(PHASES)}}
    fa._fns.pop(fa.SIMT)
    return out


def sass(path: Path) -> dict:
    """The kernel's SASS (``cuobjdump -sass``) into ``path``; the opcode
    mix of each instance."""
    lib = _build.build("flash_attention")
    tool = _build.shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(proc.stdout)
    return _build.sass_mix("flash_attention", top=24)


PARTS = tuple(VARIANTS) + ("split_warps", "items", "trace", "sass")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS}")
    parts = ap.parse_args(argv).parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_design needs a CUDA card")
    out = {"card": torch.cuda.get_device_name(0)}
    for part in parts:
        if part == "trace":
            out[part] = trace()
        elif part == "sass":
            out[part] = sass(chip_smoke.OUT / "flash_attention.sass")
        elif part == "items":
            out[part] = items()
        else:
            out[part] = compare(part)
    out["ptxas"] = PTXAS
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
