// Pointer-chase probe for Hopper (sm_90a), bound through a plain C interface
// (ctypes) by repro_torch/kernels/pointer_chase.py.
//
// Replaces the TPU Pallas kernel `pointer_chase` (`_chase_kernel`) of
// repro/kernels/microbench_chase.py: the paper's Fig. 2 / Table IV chase.
// One thread runs `hops` serially dependent loads i <- nxt[i] from `start`
// and writes the final index; every load's address is the previous load's
// value, so the time per hop is the latency of the level that holds nxt.
//
// Two memory spaces:
//   shared: the block first copies the whole array into shared memory (the
//           faithful port of the Pallas BlockSpec's VMEM residency), up to
//           the 227 KB a block can hold, then chases there (LDS latency);
//   global: the array stays in device memory and every hop is one
//           ld.global with the cache operator under test (the paper's
//           Fig. 2): .ca (cache in L1 and L2), .cg (L2 only), .cv (volatile:
//           fetched again).  With `warm`, the block's 1024 threads first read
//           the array once, coalesced, under the same operator, so a working
//           set that fits the level under test is resident when the clock
//           starts; the chase itself never warms (64 MiB would take seconds).
// Thread 0 writes the chase's clock64() cycles and %globaltimer ns
// (`timing[0]`, `timing[1]`); the host regresses cycles over hop counts.
//
// Bound: bytes, `hops` int32 loads (at most the array) over 3.35 TB/s; but a
// chase is latency-bound by design: one load in flight at any time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int OP>
__device__ __forceinline__ int ld(const int* p) {
  int v;
  if (OP == 0)
    asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(v) : "l"(p));
  else if (OP == 1)
    asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  else
    asm volatile("ld.global.cv.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(1024)
    chase_shared(const int* __restrict__ nxt, int n, int start, int hops,
                 int* __restrict__ out, long long* __restrict__ timing) {
  extern __shared__ int s[];
  for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = nxt[j];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int i = start;
  asm volatile("" : "+r"(i)::"memory");
  const unsigned long long g0 = globaltimer();
  const long long t0 = clock64();
#pragma unroll 4
  for (int h = 0; h < hops; ++h) i = s[i];
  asm volatile("" : "+r"(i)::"memory");
  const long long t1 = clock64();
  const unsigned long long g1 = globaltimer();
  out[0] = i;
  if (timing != nullptr) {
    timing[0] = t1 - t0;
    timing[1] = static_cast<long long>(g1 - g0);
  }
}

template <int OP>
__global__ void __launch_bounds__(1024)
    chase_global(const int* __restrict__ nxt, int n, int start, int hops,
                 int warm, int* __restrict__ out,
                 long long* __restrict__ timing) {
  if (warm) {
    // the loaded values are folded into `acc` and (never, hops >= 0)
    // stored, so that ptxas keeps the loads and waits for them before
    // the barrier
    int acc = 0;
    for (int j = threadIdx.x; j < n; j += blockDim.x) acc ^= ld<OP>(nxt + j);
    if (hops < 0) out[0] = acc;
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  int i = start;
  asm volatile("" : "+r"(i)::"memory");
  const unsigned long long g0 = globaltimer();
  const long long t0 = clock64();
#pragma unroll 4
  for (int h = 0; h < hops; ++h) i = ld<OP>(nxt + i);
  asm volatile("" : "+r"(i)::"memory");
  const long long t1 = clock64();
  const unsigned long long g1 = globaltimer();
  out[0] = i;
  if (timing != nullptr) {
    timing[0] = t1 - t0;
    timing[1] = static_cast<long long>(g1 - g0);
  }
}

}  // namespace

// space: 0 shared, 1 global.  cache_op (global): 0 .ca, 1 .cg, 2 .cv.
// out: 1 int32.  timing: NULL or 2 int64 (cycles, ns).  Returns 0 or a CUDA
// error code (-1: bad arguments).
extern "C" int pointer_chase_launch(const int* nxt, int n, int start,
                                    int hops, int space, int cache_op,
                                    int warm, int* out, long long* timing,
                                    void* stream) {
  if (n <= 0 || hops < 0 || start < 0 || start >= n) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (space == 0) {
    const size_t smem = static_cast<size_t>(n) * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        chase_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    chase_shared<<<1, 1024, smem, s>>>(nxt, n, start, hops, out, timing);
  } else if (space == 1) {
    switch (cache_op) {
      case 0:
        chase_global<0><<<1, 1024, 0, s>>>(nxt, n, start, hops, warm, out,
                                           timing);
        break;
      case 1:
        chase_global<1><<<1, 1024, 0, s>>>(nxt, n, start, hops, warm, out,
                                           timing);
        break;
      case 2:
        chase_global<2><<<1, 1024, 0, s>>>(nxt, n, start, hops, warm, out,
                                           timing);
        break;
      default:
        return -1;
    }
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
