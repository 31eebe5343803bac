"""Design measurements of the selective-scan kernel (``csrc/ssm_scan.cu``)
on one CUDA card; what ``PERF.md`` cites for the kernel's design.  Not part
of the package: run from the repository's root,

  PYTHONPATH=src python tools/ssm_scan_design.py [--parts exp,trace,...]

prints one JSON object with the card's name, the parts asked for (all by
default) and ``ptxas``, every build's ``ptxas -v`` lines.

Parts that compare builds (``VARIANTS``) compile copies of the kernel's
source with one change each (text substitutions, checked to apply), call
each through the wrapper in turns in one process (A, B, ..., then in
reverse, twice), and report for each build:

* ``ms``: one call between a CUDA event pair at the eval shape (Bt=4,
  S=4224, Di=1600, N=16, bf16), median of 10, as ``chip_smoke.py`` times
  it; ``device_ms``: 20 calls queued behind a device sleep between one
  event pair, over 20 (the host's share hidden), median of 5;
* ``accuracy``: against the plain version on ``chip_smoke.SSM_CASES``
  "eval" and "long" at the eval shape in bf16, and "long" at Bt=1 in f32:
  the largest |out - want| over ``REC_TOL`` (|want| + max|want|) and the
  share of outputs not bit-equal to the plain version's.

They are: ``exp``, the exponential: ``decay`` (the kernel: expf's range
reduction on dt times the prescaled A log2 e, one MUFU.EX2), ``expf``
(exp(dt A) by the CUDA library's ``expf``), ``ex2`` (2^(dt A log2 e) by one
``ex2.approx.ftz`` and nothing else), ``ex2_reduced`` (0.5 * 2^(dt A log2
e + 1): one MUFU.EX2 on an argument moved into [0, 1) where dt A log2 e is
in [-1, 0)) and ``no_exp`` (1 + dt A log2 e in place of the exponential:
not the function, a probe of what the exponentials cost); ``reduce``: the
partial sums through the shared tile (the kernel) or by shuffles after
every 8 steps; ``blocks``: one warp a block (the kernel) or up to 4 that
stage B and C once for all their channels; ``unroll``: 4, 8 (the
kernel) and 16 steps unrolled together; ``loads``: probes with B_t, C_t
or (dt, dt x) taken from registers, not shared memory, and with B and C
not staged at all; ``stages``: the cp.async ring of 2, 3 (the kernel)
and 4 chunks.

The other parts: ``trace``, per-block start and end (``%globaltimer``),
SM, and clock64() cycles a chunk in four phases, from one eval-shape
launch of a traced copy; ``expacc``, exp(x) by ``expf``, by one
``ex2.approx.ftz`` of x log2 e, by the reduced form and by the kernel's
``decay``, against float64 on the card (mean and largest relative error);
``sass``, the kernel's ``cuobjdump -sass`` into ``ssm_scan.sass`` in
``chip_smoke.py``'s output directory, and its opcode mix.  Builds go to
``kernels/build/`` beside the kernels' own.
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
from repro_torch.kernels import ssm_scan as tssm

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_H = "h[i] = fmaf(decay(dtt, al[i], al252[i]), h[i], dx * bv[i]);"
_AL = "al[i] = static_cast<float>(__ldg(&A[at]) * 1.4426950408889634);"
_EX2_FN = ("namespace {\n", "namespace {\n__device__ __forceinline__ float "
           "ex2(float z) {\n  float r;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\" "
           ": \"=f\"(r) : \"f\"(z));\n  return r;\n}\n")
_STAGES = "constexpr int kStages = 3;"
_UNROLL = "constexpr int kUnroll = 8;"
_BLOAD = "load_states<P>(&sm.b[s][t][sub * P], bv);"
_CLOAD = "load_states<P>(&sm.c[s][t][sub * P], cv);"
_DDLOAD = "if (u % 2 == 0) load4(&sm.dd[ch][2 * t], d);"
_BSTAGE = "    cp_row<T, N>(sm.b[s][lane], Bm + r * N, live);\n"
_CSTAGE = "    cp_row<T, N>(sm.c[s][lane], Cm + r * N, live);\n"


def _h(expr):
    return (_H, f"h[i] = fmaf({expr}, h[i], dx * bv[i]);")


# the partial sums summed by shuffles among a channel's 4 lanes after each
# 8 steps (each lane then stores 2 steps' y of its channel), in place of
# the [32 x 32] shared tile read once a chunk
_TILE = """#pragma unroll
      for (int u = 0; u < kUnroll; ++u) sm.part[t0 + u][lane] = part[u];
    }
    __syncwarp();
    const int t = k * kSteps + lane;               // lane t: step t's y
    if (t < S) {
#pragma unroll
      for (int c0 = 0; c0 < kChannels; c0 += 4) {
        float yv[4], v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {              // the channel's partials
          load4(&sm.part[lane][(c0 + c) * kLanes], v);
          yv[c] = (v[0] + v[1]) + (v[2] + v[3]);
        }
        store4(y + (row + t) * Di + d0 + c0, yv);
      }
    }
"""
_SHUFFLE = [
    (_TILE, """      static_assert(kUnroll == 8 && kLanes == 4, "8 steps x 4");
      const bool hi2 = sub & 2, hi1 = sub & 1;
      float q[4], r[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (hi2 ? part[4 + i] : part[i]) +
               __shfl_xor_sync(0xffffffffu, hi2 ? part[i] : part[4 + i], 2);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        r[i] = (hi1 ? q[2 + i] : q[i]) +
               __shfl_xor_sync(0xffffffffu, hi1 ? q[i] : q[2 + i], 1);
      const int tl = k * kSteps + t0 + (hi2 ? 4 : 0) + (hi1 ? 2 : 0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tl + i < S)
          y[(row + tl + i) * Di + d0 + ch] = static_cast<T>(r[i]);
    }
"""),
]
# blocks of up to 4 warps (as many as divide Di / 8) that stage B and C
# once for all their channels, behind a block barrier a chunk; partial sums
# by shuffles (no shared tile, to stay within 48 KB of static shared
# memory): two spans of the kernel's source replaced
_WARPS4 = [
    (("template <typename T, int N>\nstruct Smem {",
      "// exp(dt A) from the lane"), """constexpr int kMaxWarps = 4;  // sharing B, C

template <typename T, int N>
struct Smem {
  T x[kStages][kSteps][kMaxWarps * kChannels];
  float dt[kStages][kSteps][kMaxWarps * kChannels];
  T b[kStages][kSteps][N];
  T c[kStages][kSteps][N];
  float dd[kMaxWarps * kChannels][2 * kSteps + kPad];
};

"""),
    (("template <typename T, int N>\n__global__",
      "template <typename T>\nint dispatch_n("), r"""template <typename T, int N>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const float* __restrict__ A, T* __restrict__ y, int S,
                    int Di) {
  constexpr int P = N / kLanes;
  constexpr int kRow = N * sizeof(T);
  constexpr int kCopy = kRow < 16 ? kRow : 16;
  constexpr int kPieces = kRow / kCopy;
  __shared__ __align__(16) Smem<T, N> sm;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ch = lane / kLanes;
  const int sub = lane % kLanes;
  const int wc = warp * kChannels;
  const int d0 = blockIdx.x * blockDim.x / kLanes + wc;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * S;
  float al[P], al252[P], h[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int64_t at = static_cast<int64_t>(d0 + ch) * N + sub * P + i;
    al[i] = static_cast<float>(__ldg(&A[at]) * 1.4426950408889634);
    al252[i] = al[i] / 252.f;
    h[i] = 0.f;
  }
  auto stage = [&](int k) {
    const int s = k % kStages;
    const int t0 = k * kSteps;
    const bool live = t0 + lane < S;
    const int64_t r = row + (live ? t0 + lane : S - 1);
    cp_row<T, kChannels>(&sm.x[s][lane][wc], x + r * Di + d0, live);
    cp_row<float, kChannels>(&sm.dt[s][lane][wc], dt + r * Di + d0, live);
    for (int i = threadIdx.x; i < 2 * kSteps * kPieces; i += blockDim.x) {
      const int t = i / (2 * kPieces), j = i % (2 * kPieces);
      const bool ok = t0 + t < S;
      const int64_t at = (row + (ok ? t0 + t : S - 1)) * N +
                         (j % kPieces) * (kCopy / sizeof(T));
      T* dst = (j < kPieces ? sm.b[s][t] : sm.c[s][t]) +
               (j % kPieces) * (kCopy / sizeof(T));
      cp_async<kCopy>(dst, (j < kPieces ? Bm : Cm) + at, ok);
    }
  };
  const int nchunk = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nchunk) stage(k);
    cp_commit();
  }
  for (int k = 0; k < nchunk; ++k) {
    const int s = k % kStages;
    cp_wait<kStages - 2>();
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < kChannels; c0 += 4) {
      float xv[4], dv[4];
      load4(&sm.x[s][lane][wc + c0], xv);
      load4(&sm.dt[s][lane][wc + c0], dv);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float2*>(&sm.dd[wc + c0 + c][2 * lane]) =
            make_float2(dv[c], dv[c] * xv[c]);
    }
    __syncwarp();
    if (k + kStages - 1 < nchunk) stage(k + kStages - 1);
    cp_commit();
#pragma unroll 1
    for (int t0 = 0; t0 < kSteps; t0 += kUnroll) {
      float part[kUnroll], d[4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u;
        if (u % 2 == 0) load4(&sm.dd[wc + ch][2 * t], d);
        const float dtt = d[2 * (u % 2)];
        const float dx = d[2 * (u % 2) + 1];
        float bv[P], cv[P];
        load_states<P>(&sm.b[s][t][sub * P], bv);
        load_states<P>(&sm.c[s][t][sub * P], cv);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          h[i] = fmaf(decay(dtt, al[i], al252[i]), h[i], dx * bv[i]);
          acc = fmaf(h[i], cv[i], acc);
        }
        part[u] = acc;
      }
      static_assert(kUnroll == 8 && kLanes == 4, "8 steps x 4");
      const bool hi2 = sub & 2, hi1 = sub & 1;
      float q[4], yv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (hi2 ? part[4 + i] : part[i]) +
               __shfl_xor_sync(0xffffffffu, hi2 ? part[i] : part[4 + i], 2);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        yv[i] = (hi1 ? q[2 + i] : q[i]) +
                __shfl_xor_sync(0xffffffffu, hi1 ? q[i] : q[2 + i], 1);
      const int t = k * kSteps + t0 + (hi2 ? 4 : 0) + (hi1 ? 2 : 0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (t + i < S)
          y[(row + t + i) * Di + d0 + ch] = static_cast<T>(yv[i]);
    }
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           const void* A, void* y, int Bt, int S, int Di,
           cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      ssm_scan_kernel<T, N>, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (set != cudaSuccess) return static_cast<int>(set);
  const int units = Di / kChannels;
  const int warps = units % 4 == 0 ? 4 : units % 2 == 0 ? 2 : 1;
  dim3 grid(units / warps, Bt);
  ssm_scan_kernel<T, N><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A), static_cast<T*>(y), S, Di);
  return static_cast<int>(cudaGetLastError());
}

"""),
]
VARIANTS = {
    "exp": {"decay": [],
            "expf": [(_AL, "al[i] = __ldg(&A[at]);"),
                     _h("expf(dtt * al[i])")],
            "ex2": [_EX2_FN, _h("ex2(dtt * al[i])")],
            "ex2_reduced": [_EX2_FN,
                            _h("0.5f * ex2(fmaf(dtt, al[i], 1.0f))")],
            # not an exponential: what the kernel takes without one
            "no_exp": [_h("fmaf(dtt, al[i], 1.0f)")]},
    "reduce": {"tile": [], "shuffle": _SHUFFLE},
    "blocks": {"warps_1": [], "warps_4": _WARPS4},
    "unroll": {f"unroll_{n}": ([] if n == 8 else
                               [(_UNROLL, f"constexpr int kUnroll = {n};")])
               for n in (4, 8, 16)},
    # probes, not the function: B_t and C_t, or dt and dt x, from registers
    # in place of shared memory
    "loads": {"kernel": [],
              "no_bc_loads": [
                  (_BLOAD, "for (int i = 0; i < P; ++i) bv[i] = dtt;"),
                  (_CLOAD, "for (int i = 0; i < P; ++i) cv[i] = dx;")],
              "no_dd_loads": [
                  (_DDLOAD, "if (u % 2 == 0) { d[0] = d[2] = 1e-3f * (t + 1);"
                   " d[1] = d[3] = 1e-3f * t; }")],
              # B and C not staged at all: the most that sharing their
              # staging among the warps of a larger block could save
              "no_bc_staging": [(_BSTAGE, ""), (_CSTAGE, "")]},
    "stages": {f"stages_{n}": ([] if n == 3 else
                               [(_STAGES, f"constexpr int kStages = {n};")])
               for n in (2, 3, 4)},
}
EVAL = (4, 4224, 1600, 16)


PTXAS: dict = {}       # build name -> its ptxas -v lines


def _source(subs, name="") -> str:
    src = (_build.CSRC / "ssm_scan.cu").read_text()
    for old, new in subs:
        if isinstance(old, tuple):                 # the span a to b
            a, b = old
            if src.count(a) != 1 or src.count(b) != 1:
                raise RuntimeError(f"{name}: span not found once: {old!r}")
            src = src[:src.index(a)] + new + src[src.index(b):]
            continue
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
    fn = lib.ssm_scan_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
    fn.restype = I
    return fn


def _compile(name: str, subs):
    return _bind(_compile_lib(f"ssm_scan_{name}", _source(subs, name)))


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
    for case, shape, dtype in (("eval", EVAL, torch.bfloat16),
                               ("long", EVAL, torch.bfloat16),
                               ("long_f32", (1,) + EVAL[1:], torch.float32)):
        args = chip_smoke.ssm_inputs(torch, g, dev, *shape, dtype,
                                     case.split("_")[0])
        cases[case] = (args, ref.ssm_scan_plain(*args))
    eval_args = cases["eval"][0]
    res = {name: {"ms": [], "device_ms": [], "accuracy": {}}
           for name in builds}
    order = list(builds)
    for name in (order + order[::-1]) * 2:
        tssm._fn = builds[name]
        r = res[name]
        for case, (args, want) in cases.items():
            out = ops.ssm_scan(*args)
            torch.cuda.synchronize()
            r["accuracy"][case] = _accuracy(out, want)
        r["ms"].append(chip_smoke.gpu_ms(torch,
                                         lambda: ops.ssm_scan(*eval_args),
                                         10))
        r["device_ms"].append(_device_ms(lambda: ops.ssm_scan(*eval_args)))
    tssm._fn = None
    return res


# per-block timing: %smid and %globaltimer at a block's start and end, and
# clock64() cycles summed over the chunks for four phases (waiting for the
# chunk and converting it, issuing the next copies, the steps, the partial
# sums out and y stored), written by lane 0 into a device array
_TRACE = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_trace[7 * 4096];\n"),
    ("  const int lane = threadIdx.x;\n",
     "  const int lane = threadIdx.x;\n  long long trace_t0, ph[4] = {};\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(trace_t0));\n"),
    ("    cp_wait<kStages - 2>();",
     "    const long long q0 = clock64();\n    cp_wait<kStages - 2>();"),
    ("    if (k + kStages - 1 < nchunk) stage(k + kStages - 1);",
     "    const long long q1 = clock64();\n"
     "    if (k + kStages - 1 < nchunk) stage(k + kStages - 1);"),
    ("    // the steps, kUnroll at a time",
     "    const long long q2 = clock64();\n"
     "    // the steps, kUnroll at a time"),
    ("    __syncwarp();\n    const int t = k * kSteps + lane;",
     "    const long long q3 = clock64();\n"
     "    __syncwarp();\n    const int t = k * kSteps + lane;"),
    ("        store4(y + (row + t) * Di + d0 + c0, yv);\n      }\n    }\n",
     "        store4(y + (row + t) * Di + d0 + c0, yv);\n      }\n    }\n"
     "    ph[0] += q1 - q0;\n    ph[1] += q2 - q1;\n    ph[2] += q3 - q2;\n"
     "    ph[3] += clock64() - q3;\n"),
    ("  }\n}\n\ntemplate <typename T, int N>\nint launch(",
     "  }\n  if (lane == 0) {\n    long long t1;\n    unsigned smid;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    const int blk = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "    if (blk < 4096) {\n      long long* o = g_trace + 7 * blk;\n"
     "      o[0] = smid;\n      o[1] = trace_t0;\n      o[2] = t1;\n"
     "      for (int i = 0; i < 4; ++i) o[3 + i] = ph[i];\n    }\n  }\n"
     "}\n\ntemplate <typename T, int N>\nint launch("),
]
PHASES = ("wait_convert", "issue_copies", "steps", "partials_y")


def trace() -> dict:
    """One eval-shape bf16 launch of a traced build: the blocks' durations,
    the kernel's span, the SMs used, the most blocks that ran on one SM at
    one time, and the median block's cycles a chunk in each phase."""
    src = _source(_TRACE, "trace") + (
        '\nextern "C" int ssm_trace(long long* h) {\n'
        '  return (int)cudaMemcpyFromSymbol(h, g_trace, 7 * 4096 * 8);\n}\n')
    lib = _compile_lib("ssm_scan_trace", src)
    lib.ssm_trace.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    args = chip_smoke.ssm_inputs(torch, g, dev, *EVAL, torch.bfloat16, "eval")
    tssm._fn = _bind(lib)
    for _ in range(3):
        ops.ssm_scan(*args)
    torch.cuda.synchronize()
    tssm._fn = None
    nchunk = -(-EVAL[1] // 32)
    buf = (ctypes.c_longlong * (7 * 4096))()
    if lib.ssm_trace(buf) != 0:
        raise RuntimeError("reading the trace failed")
    rows = [tuple(buf[7 * b:7 * b + 7]) for b in range(4096)
            if buf[7 * b + 2]]
    nblk = len(rows)
    t0 = min(r[1] for r in rows)
    dur = sorted((r[2] - r[1]) / 1e3 for r in rows)
    events = sorted([(r[1], 1, r[0]) for r in rows]
                    + [(r[2], -1, r[0]) for r in rows])
    live, most = {}, {}
    for _, d, sm in events:
        live[sm] = live.get(sm, 0) + d
        most[sm] = max(most.get(sm, 0), live[sm])
    per_sm = {}
    for r in rows:
        per_sm[r[0]] = per_sm.get(r[0], 0) + 1
    return {"blocks": nblk, "sms": len(per_sm),
            "blocks_per_sm": sorted(set(per_sm.values())),
            "most_at_once_per_sm": sorted(set(most.values())),
            "span_us": (max(r[2] for r in rows) - t0) / 1e3,
            "block_us": {"min": dur[0], "median": dur[len(dur) // 2],
                         "max": dur[-1]},
            "last_start_us": (max(r[1] for r in rows) - t0) / 1e3,
            "cycles_a_chunk": {
                name: statistics.median(r[3 + i] for r in rows) / nchunk
                for i, name in enumerate(PHASES)}}


_EXP_CU = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float z) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}
DECAY
__global__ void exps(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float L = 1.4426950408889634f, xi = x[i];
  out[i] = expf(xi);
  out[n + i] = ex2(xi * L);
  out[2 * n + i] = 0.5f * ex2(fmaf(xi, L, 1.0f));
  out[3 * n + i] = decay(xi, L, L / 252.f);
}
extern "C" int exps_launch(const float* x, float* out, int n) {
  exps<<<(n + 255) / 256, 256>>>(x, out, n);
  return (int)cudaGetLastError();
}
"""
EXPS = ("expf", "ex2", "ex2_reduced", "decay")


def expacc(n=1 << 22) -> dict:
    """exp(x) three ways against float64 on the card, for x uniform in
    ranges the scan meets: the mean signed and the largest error relative to
    exp(x), in units of 2^-24 (half an f32 ulp near 1)."""
    src = (_build.CSRC / "ssm_scan.cu").read_text()
    a = src.index("__device__ __forceinline__ float decay(")
    lib = _compile_lib("ssm_exps", _EXP_CU.replace(
        "DECAY", src[a:src.index("\n}\n", a) + 3]))
    fn = lib.exps_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for lo, hi in ((-1e-5, 0.0), (-0.01, 0.0), (-1.0, -0.01), (-10.0, -1.0)):
        x = torch.rand(n, generator=g, device=dev) * (hi - lo) + lo
        got = torch.empty(len(EXPS) * n, device=dev)
        if fn(x.data_ptr(), got.data_ptr(), n) != 0:
            raise RuntimeError("exps launch failed")
        exact = torch.exp(x.double())
        for k, name in enumerate(EXPS):
            rel = (got[k * n:(k + 1) * n].double() - exact) / exact * 2 ** 24
            out.setdefault(name, {})[f"[{lo}, {hi})"] = {
                "mean": rel.mean().item(), "max_abs": rel.abs().max().item()}
    return out


def sass(path: Path) -> dict:
    """The kernel's SASS (``cuobjdump -sass``) into ``path``; the opcode
    mix of each instance."""
    lib = _build.build("ssm_scan")
    tool = _build.shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(proc.stdout)
    return _build.sass_mix("ssm_scan", top=16)


PARTS = tuple(VARIANTS) + ("trace", "expacc", "sass")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS}")
    parts = ap.parse_args(argv).parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("ssm_scan_design needs a CUDA card")
    out = {"card": torch.cuda.get_device_name(0)}
    for part in parts:
        if part in VARIANTS:
            out[part] = compare(part)
        elif part == "sass":
            out[part] = sass(chip_smoke.OUT / "ssm_scan.sass")
        else:
            out[part] = globals()[part]()
    out["ptxas"] = PTXAS
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
