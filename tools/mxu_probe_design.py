"""Design measurements of the tensor-core probe (``csrc/mxu_probe.cu``) on
one CUDA card; what ``PERF.md`` cites for the probe's design.  Not part of
the package: run from the repository's root,

  PYTHONPATH=src python tools/mxu_probe_design.py [--parts tma_ab,...]

prints one JSON object with the parts asked for (all by default):

* ``phases``: clock64() cycles at points inside a lone block (grid of one
  block, chain 1, block (128, 128)) and in a chain of 4 steps, from a copy
  of the kernel's source with trace points added (thread 0 of block (0, 0)
  writes clock64() into a device array): ``loads_issued`` when thread 0 has
  issued its loads, ``unit_k`` when it starts on load unit (or ring slab)
  k of the first pass, ``multiplied`` when it has issued the pass's last
  HMMA, ``step_s`` at the end of step s (the tile written to the next
  panel or to shared memory for the output), ``stored`` at the end (the
  output tile in device memory); the median of 5 launches;
* ``loads``: the bytes a cycle one lone block moves from L2 into shared
  memory, 128 KB at a time (A [128, 256] and B [256, 128] bf16), by 2-D
  TMA tensor-map boxes under the 128-byte swizzle (one thread issues 6
  boxes) against 16-byte cp.async from 256 and 384 threads;
* ``host_us``: the host's microseconds a call, 400 calls queued without a
  synchronisation, median of 5: ``mxu_probe`` through ``ops``, the wrapper
  alone, the bare ctypes launch, ``torch.empty``'s share, and
  ``torch.matmul`` at the same shape (bf16 256 x 256 x 256, block
  (128, 128));
* ``tma_ab``: the kernel as built against a build of the same source with
  ``-DMXU_PROBE_TMA=0`` (every shape loaded by cp.async), in turns in one
  process (TMA, cp.async, cp.async, TMA, twice): each build checked
  against the plain version, then the main case's device ms (20 launches queued behind
  a device sleep, over 20, median of 5), the independent ``mxu_shapes``
  cells' and ``mxu_peak_tflops``' TFLOP/s (``run_mxu``, one wave of blocks
  a unit of L) and the bf16 128^3 and 256^3 chain steps' cycles.

Builds go to ``kernels/build/`` beside the kernels' own.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import _build

# trace points: (anchor in csrc/mxu_probe.cu, text, insert after the anchor)
_TRACE = [
    ("namespace {\n",
     "__device__ long long g_trace[64];\n"
     "#define TRACE(i) do { if (clocked) g_trace[(i)] = clock64(); } "
     "while (0)\n", True),
    ("    t0 = clock64();\n  }\n", "  TRACE(0);\n", True),
    ("  int ring_n = 0;", "  TRACE(1);\n", False),
    ("        for (int j = 0; j < nchunk; ++j) {\n",
     "          if (step == 0 && pm0 == 0 && pn0 == 0 && j < 16) "
     "TRACE(2 + j);\n", True),
    ("        if (!p.staged) {\n          ring_n += nslab;",
     "        if (step == 0 && pm0 == 0 && pn0 == 0) TRACE(19);\n", False),
    ("    __syncthreads();  // the step's panel is written and its source "
     "free\n", "    if (step < 8) TRACE(22 + step);\n", True),
    ("  if (clocked && timing != nullptr) {", "  TRACE(31);\n", False),
]

_LOADS_CU = r'''
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void tma_kernel(const __grid_constant__ CUtensorMap ma,
                           const __grid_constant__ CUtensorMap mb,
                           long long* out, int reps) {
  extern __shared__ __align__(1024) unsigned char sm[];
  uint64_t* bar = (uint64_t*)sm;
  unsigned char* data = sm + 1024;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sa(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(sa(bar)), "r"(131072) : "memory");
      for (int i = 0; i < 4; ++i)
        asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile."
                     "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
                     ::"r"(sa(data + i * 16384)), "l"(&ma), "r"(i * 64),
                     "r"(0), "r"(sa(bar)) : "memory");
      for (int i = 0; i < 2; ++i)
        asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile."
                     "mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
                     ::"r"(sa(data + 65536 + i * 32768)), "l"(&mb),
                     "r"(i * 64), "r"(0), "r"(sa(bar)) : "memory");
    }
    uint32_t done = 0;
    while (!done)
      asm volatile("{.reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 "
                   "p, [%1], %2; selp.u32 %0, 1, 0, p;}"
                   : "=r"(done) : "r"(sa(bar)), "r"(rep & 1) : "memory");
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = clock64() - t0;
}

__global__ void cpasync_kernel(const char* a, const char* b, long long* out,
                               int reps) {
  extern __shared__ __align__(1024) unsigned char sm[];
  long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    for (int c = threadIdx.x; c < 8192; c += blockDim.x) {
      const char* src = c < 4096 ? a + c * 16 : b + (c - 4096) * 16;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(sa(sm + c * 16)), "l"(src) : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = clock64() - t0;
}

typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                           void*, const cuuint64_t*, const cuuint64_t*,
                           const cuuint32_t*, const cuuint32_t*,
                           CUtensorMapInterleave, CUtensorMapSwizzle,
                           CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static int map(Encode enc, CUtensorMap* m, const void* p, int rows, int cols,
               int box_rows) {
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, steps[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)p, dims, strides,
             box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// out[0]: TMA cycles, out[1]: cp.async cycles with `threads` threads
extern "C" int loads(const void* a, const void* b, long long* out, int reps,
                     int threads) {
  Encode enc = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&enc,
                              cudaEnableDefault, &q) != cudaSuccess || !enc)
    return -1;
  CUtensorMap ma, mb;
  if (map(enc, &ma, a, 128, 256, 128) || map(enc, &mb, b, 256, 128, 256))
    return -2;
  const int smem = 131072 + 1024;
  cudaFuncSetAttribute(tma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(cpasync_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tma_kernel<<<1, 128, smem>>>(ma, mb, out, reps);
  cpasync_kernel<<<1, threads, smem>>>((const char*)a, (const char*)b,
                                       out + 1, reps);
  return (int)cudaDeviceSynchronize();
}
'''

_NAMES = {0: "start", 1: "loads_issued", 19: "multiplied", 31: "stored"}


def _compile(name: str, source: str, flags=()) -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"{name}.cu"
    lib = _build.BUILD_DIR / f"lib{name}.so"
    src.write_text(source)
    proc = subprocess.run([_build._tool("nvcc"), *_build.NVCC_FLAGS, *flags, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _traced_lib() -> ctypes.CDLL:
    src = (_build.CSRC / "mxu_probe.cu").read_text()
    for anchor, text, after in _TRACE:
        if anchor not in src:
            raise RuntimeError(f"trace anchor missing: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor,
                          1)
    src += ('\nextern "C" int mxu_trace(long long* h, int clear) {\n'
            '  void* p; cudaGetSymbolAddress(&p, g_trace);\n'
            '  if (clear) return (int)cudaMemset(p, 0, 64 * 8);\n'
            '  return (int)cudaMemcpy(h, p, 64 * 8, cudaMemcpyDeviceToHost);'
            '\n}\n')
    lib = _compile("mxu_probe_traced", src)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mxu_probe_launch.argtypes = [I, P, P, P, I, I, I, I, I, I, P, P]
    lib.mxu_trace.argtypes = [P, I]
    return lib


def phases(lib, dtype, M, K, N, block, chain, reps=5) -> dict:
    dev = torch.device("cuda")
    a = (torch.randn((M, K), device=dev) * 0.1).to(dtype)
    b = (torch.randn((K, N), device=dev) * 0.1).to(dtype)
    out = torch.empty((M, N), device=dev, dtype=dtype)
    host = (ctypes.c_longlong * 64)()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(100000)
        lib.mxu_trace(None, 1)
        rc = lib.mxu_probe_launch(int(dtype == torch.bfloat16), a.data_ptr(),
                                  b.data_ptr(), out.data_ptr(), M, N, K,
                                  block[0], block[1], chain, None,
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed (rc={rc})")
        torch.cuda.synchronize()
        lib.mxu_trace(host, 0)
        t = list(host)
        runs.append({i: t[i] - t[0] for i in range(64) if t[i] >= t[0]
                     and t[i] != 0})
    keys = sorted(set.intersection(*(set(r) for r in runs)))

    def name(i):
        if i in _NAMES:
            return _NAMES[i]
        if 2 <= i < 18:
            return f"unit_{i - 2}"
        return f"step_{i - 22}"
    return {name(i): statistics.median(r[i] for r in runs) for i in keys}


def loads(reps=16) -> dict:
    lib = _compile("load_bench", _LOADS_CU)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.loads.argtypes = [P, P, P, I, I]
    dev = torch.device("cuda")
    a = torch.randn((128, 256), device=dev).bfloat16()
    b = torch.randn((256, 128), device=dev).bfloat16()
    o = torch.zeros(2, dtype=torch.int64, device=dev)
    res = {}
    for threads in (256, 384):
        for _ in range(3):
            rc = lib.loads(a.data_ptr(), b.data_ptr(), o.data_ptr(), reps,
                           threads)
            if rc != 0:
                raise RuntimeError(f"load bench failed (rc={rc})")
        tma, cp = o.tolist()
        res["tma_bytes_per_cycle"] = 131072 * reps / tma
        res[f"cp_async_{threads}_bytes_per_cycle"] = 131072 * reps / cp
    return res


def host_us(n=400, reps=5) -> dict:
    from repro_torch.kernels import mxu_probe as probe
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    a = torch.randn((256, 256), device=dev).bfloat16()
    b = torch.randn((256, 256), device=dev).bfloat16()
    out = a.new_empty((256, 256))
    launch = probe._launchers()[0]

    def bare():
        launch(1, a.data_ptr(), b.data_ptr(), out.data_ptr(), 256, 256, 256,
               128, 128, 1, None,
               torch._C._cuda_getCurrentRawStream(a.get_device()))

    def timed(fn):
        runs = []
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        return statistics.median(runs)
    return {"ops": timed(lambda: ops.mxu_probe(a, b, chain=1)),
            "wrapper": timed(lambda: probe.mxu_probe(a, b, chain=1,
                                                     block=(128, 128))),
            "ctypes_launch": timed(bare),
            "new_empty": timed(lambda: a.new_empty((256, 256))),
            "torch_matmul": timed(lambda: torch.matmul(a, b))}


def _device_ms(fn, n=20, reps=5) -> float:
    """ms a call of ``fn``: n calls queued behind a device sleep (so the
    host's call is hidden) between a CUDA event pair, over n; median of
    ``reps``."""
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


# the A/B's correctness cases: (m, k, n, chain, block), the staged TMA
# load, a staged chain and the ring (bf16 K=256 at bn=128; f32 K=256; a
# case beyond a block's shared memory in a dtype is left out there)
_AB_CASES = [(256, 256, 256, 1, (128, 128)), (128, 128, 128, 4, (128, 128)),
             (256, 256, 256, 8, (256, 128)), (256, 256, 256, 3, (256, 64))]
# the independent cells: the mxu_shapes grid at L (1, 2, 4, 8) and the
# roofline's mxu_peak_tflops (f32 512^3 at L (1, 2, 4))
_AB_CELLS = [(dt, s, (1, 2, 4, 8)) for dt in ("bfloat16", "float32")
             for s in ((128, 128, 128), (256, 256, 256), (512, 512, 128))]
_AB_CELLS.append(("float32", (512, 512, 512), (1, 2, 4)))


def tma_ab() -> dict:
    from repro_torch.core.microbench import mxu
    from repro_torch.kernels import mxu_probe as probe
    from repro_torch.kernels import ops, ref
    src = (_build.CSRC / "mxu_probe.cu").read_text()
    builds = {"tma": probe.bind(_build.load("mxu_probe")),
              "cp_async": probe.bind(_compile("mxu_probe_cp_async", src,
                                              ["-DMXU_PROBE_TMA=0"]))}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {name: {"max_err_of_max": 0.0, "main_ms": [], "cells": {},
                  "chain_cycles": {}} for name in builds}
    a = torch.randn((256, 256), device=dev, generator=gen).bfloat16()
    b = torch.randn((256, 256), device=dev, generator=gen).bfloat16()
    for name in ("tma", "cp_async", "cp_async", "tma") * 2:
        probe._fns = builds[name]
        r = res[name]
        for dt in (torch.bfloat16, torch.float32):
            for m, k, n, chain, block in _AB_CASES:
                if probe.smem_bytes(dt, k, *block, chain) > probe.SMEM_MAX:
                    continue
                x = (torch.randn((m, k), device=dev, generator=gen) * 0.1).to(dt)
                y = (torch.randn((k, n), device=dev, generator=gen) * 0.1).to(dt)
                got = ops.mxu_probe(x, y, chain=chain, block=block)
                want = ref.mxu_probe_plain(x, y, chain=chain)
                err = ((got.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                if not err <= probe.REL_TOL:
                    raise AssertionError(f"{name} build: {dt} {(m, k, n)} "
                                         f"chain {chain}: {err}")
                r["max_err_of_max"] = max(r["max_err_of_max"], err)
        r["main_ms"].append(_device_ms(lambda: ops.mxu_probe(a, b, chain=1)))
        for dt, shape, lengths in _AB_CELLS:
            cell = mxu.run_mxu(dt, shape, dependent=False, lengths=lengths,
                               device=dev)
            key = f"{dt} {'x'.join(map(str, shape))}"
            r["cells"].setdefault(key, {"reps": cell.reps, "tflops": []})
            r["cells"][key]["tflops"].append(cell.tflops)
        for shape in ((128, 128, 128), (256, 256, 256)):
            cell = mxu.run_mxu("bfloat16", shape, dependent=True, device=dev)
            r["chain_cycles"].setdefault(
                f"bfloat16 {shape[0]}^3 block {cell.block}", []).append(
                cell.cycles_per_op)
    probe._fns = builds["tma"]
    return res


PARTS = ("phases", "loads", "host_us", "tma_ab")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS}")
    parts = ap.parse_args(argv).parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("mxu_probe_design needs a CUDA card")
    out = {"card": torch.cuda.get_device_name(0)}
    if "phases" in parts:
        lib = _traced_lib()
        out["phases"] = {}
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            for K in (128, 256, 512):
                out["phases"][f"{name} lone K={K} chain 1"] = phases(
                    lib, dt, 128, K, 128, (128, 128), 1)
            out["phases"][f"{name} K=128 chain 4"] = phases(
                lib, dt, 128, 128, 128, (128, 128), 4)
    if "loads" in parts:
        out["loads"] = loads()
    if "host_us" in parts:
        out["host_us"] = host_us()
    if "tma_ab" in parts:
        out["tma_ab"] = tma_ab()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
