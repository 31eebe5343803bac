// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by repro_torch/kernels/wkv6.py.
//
// Replaces the TPU Pallas kernel `wkv6` of repro/kernels/wkv6.py:46 (body
// `_wkv_kernel`).
//
// What it computes: r, k, v [B,S,H,N] (all bf16, or all f32), w [B,S,H,N]
// f32, u [H,N] f32 -> y [B,S,H,N] in r's dtype.  Per (row, head) an N x N
// f32 state S, zero at t = 0:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Every input is read in f32 and the state stays f32, as the Pallas kernel
// upcasts r, k, v, w and u; y is rounded to r's dtype once per element.
//
// Bound: at the eval shape (B=4, S=4096, H=32, N=64, r/k/v/y bf16, w f32)
// the kernel must read r, k, v, w and write y once, 12 bytes an element:
// 0.40 GB, 0.12 ms at 3.35 TB/s; the recurrence does 7 N^2 f32 operations
// per (row, step, head), 1.5e10 in all, 0.22 ms at 67 TFLOP/s on the CUDA
// cores, so the operations bound it.  There is no matrix product to put on
// the tensor cores: each step is an outer product and a matrix-vector
// product on a state that depends on the last.
//
// Design: one block per (row, block_h heads); thread (g, j) of the block's
// block_h x N threads keeps column j of head g's state in N registers, so
// the state never leaves the SM.  The sequence runs in chunks of L steps:
// the block stages r, k, v and w of the chunk in shared memory (one
// coalesced load per thread and step, all in flight together), syncs, runs
// the L steps from shared memory (r_i, k_i, w_i, u_i are broadcasts: every
// thread of a head reads the same word), writes y_t[j] straight to device
// memory (coalesced over the head's threads), and syncs before the next
// chunk.  The grid is B x H / block_h blocks: 128 at the eval shape with
// block_h = 1, fewer than the 132 SMs, each SM running 2 warps; the serial
// recurrence, not the memory, bounds this kernel.  Only N in {16, 32, 64}
// is built.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxChunk = 32;
constexpr int kSmemFloats = 12288;  // 48 KB of staged inputs per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
__global__ void wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ w,
                            const float* __restrict__ u, T* __restrict__ y,
                            int S, int H, int block_h, int L) {
  extern __shared__ float smem[];
  const int width = block_h * N;            // threads, and floats per step
  float* sr = smem;                         // [L][block_h][N]
  float* sk = sr + L * width;
  float* sv = sk + L * width;
  float* sw = sv + L * width;
  float* su = sw + L * width;               // [block_h][N]

  const int tid = threadIdx.x;
  const int g = tid / N;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * block_h;
  su[tid] = u[h0 * N + tid];

  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = 0.f;

  // offset of (row b, step t, head h0, element tid); heads h0..h0+block_h
  // are contiguous, so a step of the block is `width` contiguous values
  const int64_t row = static_cast<int64_t>(b) * S;
  for (int t0 = 0; t0 < S; t0 += L) {
    const int len = min(L, S - t0);
    __syncthreads();                        // the last chunk's reads done
#pragma unroll 8
    for (int tt = 0; tt < len; ++tt) {
      const int64_t off = ((row + t0 + tt) * H + h0) * N + tid;
      sr[tt * width + tid] = to_f32(r[off]);
      sk[tt * width + tid] = to_f32(k[off]);
      sv[tt * width + tid] = to_f32(v[off]);
      sw[tt * width + tid] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float* rt = sr + tt * width + g * N;
      const float* kt = sk + tt * width + g * N;
      const float* wt = sw + tt * width + g * N;
      const float* ut = su + g * N;
      const float vj = sv[tt * width + tid];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = kt[i] * vj;
        acc += rt[i] * (s[i] + ut[i] * kv);
        s[i] = wt[i] * s[i] + kv;
      }
      store(&y[((row + t0 + tt) * H + h0) * N + tid], acc);
    }
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, int B, int S, int H, int block_h,
           cudaStream_t stream) {
  const int width = block_h * N;
  // chunk length: 4 staged inputs of `width` floats a step, plus u, in
  // 48 KB (at least 2 steps for the widest block of 1024 threads)
  const int L = std::min(kMaxChunk, (kSmemFloats - width) / (4 * width));
  const size_t smem = sizeof(float) * (4 * static_cast<size_t>(L) * width +
                                       width);
  dim3 grid(B, H / block_h);
  wkv6_kernel<T, N><<<grid, width, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(y), S, H, block_h, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* w, const void* u, void* y, int B, int S, int H,
               int block_h, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, B, S, H, block_h, s);
    case 32: return launch<T, 32>(r, k, v, w, u, y, B, S, H, block_h, s);
    case 64: return launch<T, 64>(r, k, v, w, u, y, B, S, H, block_h, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0, -1 for arguments the kernel does not take, or the CUDA error
// of the launch.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y, int is_bf16,
                           int B, int S, int H, int N, int block_h,
                           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || block_h <= 0 || H % block_h ||
      block_h * N > kMaxThreads)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, w, u, y, B, S, H, block_h,
                                     s);
  return dispatch_n<float>(N, r, k, v, w, u, y, B, S, H, block_h, s);
}
