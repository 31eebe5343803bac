// Tensor-core probe for Hopper (sm_90a) through WMMA (nvcuda::wmma, the
// paper's own API), bound through a plain C interface (ctypes) by
// repro_torch/kernels/mxu_probe.py.
//
// Replaces the TPU Pallas kernel `mxu_probe` (`_probe_kernel`) of
// repro/kernels/mxu_probe.py: the paper's Table III / Fig. 5 experiment.
// It computes, per (bm, bn) output tile, the dependent chain
//   C <- (A_tile @ C) * 0.001, cast to the input dtype, `chain` times,
// from C = B[:, tile columns], with f32 accumulation: a [M,K], b [K,N] ->
// out [M,N].  With chain > 1 the reference needs bm == K == M (C <- A @ C),
// so a block owns the whole [K, bn] column panel.
//
// Fragments: bf16 -> m16n16k16 with f32 accumulators; f32 -> the paper's
// tf32 m16n16k8 row (inputs rounded to tf32, 10 mantissa bits; f32
// accumulators).  One block of 8 warps per tile; warp w computes the tile's
// 16x16 fragments w, w+8, ...; A's fragments load from device memory (L2),
// C's from B (step 0) or from the previous step's panel in shared memory.
// The panel is double-buffered in shared memory ([K, bn] in the input dtype,
// one __syncthreads per step): each step reads one buffer, scales by 0.001,
// rounds to the input dtype and writes the other, exactly where the
// reference rounds; the last step writes the output tile.  bf16 results pass
// through an f32 staging fragment per warp for the rounding.
//
// Thread 0 of block (0, 0) writes the chain's clock64() cycles and
// %globaltimer ns (`timing[0]`, `timing[1]`).
//
// Bound: operations for the shapes the harness runs, chain * 2*M*N*K over
// the dense tensor-core peak (989 TFLOP/s bf16, 495 tf32); bytes (A, B read
// once, out written once) over 3.35 TB/s otherwise.  This first kernel
// uses WMMA's mma.sync path, not wgmma, and reloads A per fragment.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T>
struct Frag;
template <>
struct Frag<__nv_bfloat16> {
  static constexpr int KS = 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> A;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> B;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
  template <typename F>
  static __device__ __forceinline__ void load(F& f, const __nv_bfloat16* p,
                                              int ld) {
    wmma::load_matrix_sync(f, p, ld);
  }
};
template <>
struct Frag<float> {
  static constexpr int KS = 8;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                         wmma::row_major> A;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                         wmma::row_major> B;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 8, float> Acc;
  template <typename F>
  static __device__ __forceinline__ void load(F& f, const float* p, int ld) {
    wmma::load_matrix_sync(f, p, ld);
#pragma unroll
    for (int i = 0; i < f.num_elements; ++i) f.x[i] = wmma::__float_to_tf32(f.x[i]);
  }
};

// store 0.001 * acc into dst (ld) in T; `stage` is this warp's 16x16 f32
template <typename T>
__device__ __forceinline__ void store_scaled(
    typename Frag<T>::Acc& acc, T* dst, int ld, float* stage);
template <>
__device__ __forceinline__ void store_scaled<float>(Frag<float>::Acc& acc,
                                                    float* dst, int ld,
                                                    float*) {
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= 0.001f;
  wmma::store_matrix_sync(dst, acc, ld, wmma::mem_row_major);
}
template <>
__device__ __forceinline__ void store_scaled<__nv_bfloat16>(
    Frag<__nv_bfloat16>::Acc& acc, __nv_bfloat16* dst, int ld, float* stage) {
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= 0.001f;
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = lane; e < 256; e += 32)
    dst[(e >> 4) * ld + (e & 15)] = __float2bfloat16_rn(stage[e]);
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mxu_probe_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ out, int M, int N, int K, int bm, int bn,
                     int chain, long long* __restrict__ timing) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nbuf = chain > 1 ? (chain > 2 ? 2 : 1) : 0;
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + (nbuf > 1 ? K * bn : 0);
  float* stage = reinterpret_cast<float*>(buf0 + nbuf * K * bn);
  const int warp = threadIdx.x >> 5;
  float* my_stage = stage + warp * 256;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  const int frags = (bm / 16) * (bn / 16), fcols = bn / 16;
  const bool clocked = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;
  unsigned long long g0 = 0;
  long long t0 = 0;
  if (clocked) {
    g0 = globaltimer();
    t0 = clock64();
  }
  for (int step = 0; step < chain; ++step) {
    const T* src = step == 0 ? b + col0 : ((step - 1) & 1 ? buf1 : buf0);
    const int ld_src = step == 0 ? N : bn;
    const bool last = step == chain - 1;
    T* dst = last ? out + static_cast<size_t>(row0) * N + col0
                  : (step & 1 ? buf1 : buf0);
    const int ld_dst = last ? N : bn;
    for (int f = warp; f < frags; f += kWarps) {
      const int fr = (f / fcols) * 16, fc = (f % fcols) * 16;
      typename Frag<T>::Acc acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < K; kk += Frag<T>::KS) {
        typename Frag<T>::A fa;
        typename Frag<T>::B fb;
        Frag<T>::load(fa, a + static_cast<size_t>(row0 + fr) * K + kk, K);
        Frag<T>::load(fb, src + static_cast<size_t>(kk) * ld_src + fc, ld_src);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      store_scaled<T>(acc, dst + static_cast<size_t>(fr) * ld_dst + fc,
                      ld_dst, my_stage);
    }
    __syncthreads();
  }
  if (clocked && timing != nullptr) {
    const long long t1 = clock64();
    const unsigned long long g1 = globaltimer();
    timing[0] = t1 - t0;
    timing[1] = static_cast<long long>(g1 - g0);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int M, int N, int K,
           int bm, int bn, int chain, long long* timing, size_t smem,
           cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      mxu_probe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(N / bn, M / bm);
  mxu_probe_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, N, K, bm, bn, chain, timing);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shared memory a launch needs: the panel buffers plus bf16 staging.
extern "C" long long mxu_probe_smem_bytes(int is_bf16, int K, int bn,
                                          int chain) {
  const long long elem = is_bf16 ? 2 : 4;
  const long long nbuf = chain > 1 ? (chain > 2 ? 2 : 1) : 0;
  return nbuf * K * bn * elem + kWarps * 256 * 4;
}

// is_bf16: 1 bf16, 0 f32 (tf32 tensor cores).  M, N, K, bm, bn multiples of
// 16; bm | M, bn | N; chain > 1 needs bm == K == M.  timing: NULL or
// 2 int64 (cycles, ns).  Returns 0 or a CUDA error code (-1: bad arguments).
extern "C" int mxu_probe_launch(int is_bf16, const void* a, const void* b,
                                void* out, int M, int N, int K, int bm, int bn,
                                int chain, long long* timing, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || chain <= 0 ||
      M % 16 || N % 16 || K % 16 || bm % 16 || bn % 16 || M % bm || N % bn ||
      (chain > 1 && (bm != K || M != K)))
    return -1;
  const size_t smem = static_cast<size_t>(mxu_probe_smem_bytes(is_bf16, K, bn,
                                                               chain));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, b, out, M, N, K, bm, bn, chain,
                                         timing, smem, s)
                 : launch<float>(a, b, out, M, N, K, bm, bn, chain, timing,
                                 smem, s);
}
