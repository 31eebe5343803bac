// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by repro_torch/kernels/wkv6.py.
//
// Replaces the TPU Pallas kernel `wkv6` of repro/kernels/wkv6.py:46 (body
// `_wkv_kernel`).
//
// What it computes: r, k, v [B,S,H,N] (all bf16, or all f32), w [B,S,H,N]
// and u [H,N] f32 -> y [B,S,H,N] in r's dtype.  Per (row, head) an N x N
// f32 state S, zero at t = 0:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Every input is read in f32 and the state stays f32, as the Pallas kernel
// upcasts r, k, v, w and u; y is rounded to r's dtype once per element.
// The kernel computes y in the form that hoists the bonus term:
//   a_t = sum_i r_t[i] u[i] k_t[i]      (one value a step and head)
//   y_t[j] = sum_i r_t[i] S[i][j] + a_t v_t[j]
//
// Bound: at the eval shape (B=4, S=4096, H=32, N=64; r, k, v, y bf16, w
// f32) the recurrence needs 5 N^2 + 5 N f32 operations a (row, step, head)
// (r.S 2 N^2, k v^T and w S + k v^T 3 N^2, a_t 3 N, a_t v 2 N): 1.09e10,
// 0.163 ms at 67 TFLOP/s; r, k, v, w read and y written once, 12 bytes an
// element, take 0.120 ms at 3.35 TB/s.  The operations bound it.  Each
// state element costs three FP32 instructions a step (the product
// k_i v_j, the update w_i S_ij + k_i v_j, the sum r_i S_ij): 6.44e9 at
// 132 SMs x 128 lanes x 1.98 GHz, an issue floor of 0.193 ms that no
// kernel on the CUDA cores in this form goes below.  There is no matrix
// product for the tensor cores: each step is an outer product and a
// matrix-vector product on a state that depends on the last.
//
// Design.  Each compute thread keeps a 4 x 4 tile of one head's state in
// 16 registers for the whole sequence: rows 4 rg.., columns 4 cg.. .  A
// step loads 4 values each of r, k, w and v (r, k, v bf16 as staged, w
// f32) and issues 48 FP32 instructions.  Columns are independent, so a
// head's columns split over blocks of at most 32: a block's compute warps
// are N/4 x C/4 threads (N=64: 16 x 8 = 128 threads, two blocks a head;
// N=32: 64; N=16: 16 of one warp).  At the eval shape that is 256 blocks,
// all resident at once at two an SM: 1,024 compute warps on 132 SMs,
// 7.76 an SM (124 SMs hold 8, two on each scheduler; 8 hold 4), beside
// the same number of reducer warps.
// - The sequence runs in chunks of 16 steps.  The compute warps stage
//   chunk c + 2 by cp.async into a 4-slot ring while chunk c runs; a step
//   past S has r, k, v zero-filled by the copy's source size and w set to
//   1, so it changes no state.
// - A step's partial sums of y_t (4 columns over the thread's 4 rows) go
//   into a [16 steps x N/4 row groups x C] tile in shared memory, one of
//   two.  Reducer warps, one thread for each 4 columns of a step, sum a
//   chunk's tile while the compute warps run the next chunk: the row
//   groups' partials in a fixed order, plus a_t v_t, where a_t comes from
//   each reducer's N/(C/4) rows and shuffles across the step's reducers.
//   So the sum over rows is off the recurrence's path, and two calls are
//   bit-equal (no atomics).
// - Named barriers hand a tile over: the compute warps arrive on "full"
//   after a chunk, the reducers on "empty" when they have read it (and
//   its ring slot), two chunks before the compute warps reuse it.
// - What bounds it: shared-memory bandwidth (128 bytes a cycle an SM).
//   Each compute thread reads 40 bytes a step for 16 elements and writes
//   16 of partial sums, which the reducers read back (PERF.md,
//   tools/wkv6_design.py).
// Only N in {16, 32, 64} is built.  r, k, v and w must be 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kTileR = 4;      // a thread's state tile: 4 rows ...
constexpr int kTile = 4;       // ... x 4 columns; y in 4 columns a thread
constexpr int kSteps = 16;     // steps a chunk
constexpr int kStages = 4;     // chunks in the cp.async ring
constexpr int kMaxCols = 32;   // columns a block

// named barriers (0 is __syncthreads): the compute warps among
// themselves, and a tile full or empty
constexpr int kBarCompute = 1, kBarFull = 2, kBarEmpty = 4;

template <int N>
struct Shape {
  static constexpr int C = N < kMaxCols ? N : kMaxCols;  // columns a block
  static constexpr int RG = N / kTileR;                  // row groups
  static constexpr int CG = C / kTile;                   // column groups
  static constexpr int TILES = RG * CG;                  // state tiles
  // compute threads: whole warps (N=16: 16 tiles, one warp)
  static constexpr int NC = TILES < 32 ? 32 : TILES;
  // reducer threads, one for each 4 columns of a step of y (N=64 or 32:
  // four warps; N=16: two), each with N / CG rows of a_t's dot product
  static constexpr int NR = kSteps * CG;
  static constexpr int ROWS = N / CG;
  static constexpr int THREADS = NC + NR;
  static_assert(NR % 32 == 0 && ROWS % 4 == 0, "reducers");
};

template <typename T, int N>
struct Smem {
  static constexpr int C = Shape<N>::C;
  // the ring: chunks as they arrive (r, k, v in T; w f32)
  T r[kStages][kSteps][N];
  T k[kStages][kSteps][N];
  T v[kStages][kSteps][C];
  float w[kStages][kSteps][N];
  // each compute thread's partial y at each step: the chunk the compute
  // warps run and the one the reducers sum
  float part[2][kSteps][Shape<N>::RG][C];
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// 16 bytes from src to shared dst; with live false nothing is read and dst
// is filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// COUNT values a step of the chunk at step t0, from src (step t at
// src + t * stride) into dst[step][COUNT], in 16-byte copies spread over
// the block's NT copying threads.  A step past S is zero-filled by the
// copy's source size or, with ONES, set to 1 by a store.
template <int NT, bool ONES, typename E, int COUNT>
__device__ __forceinline__ void stage_rows(E (*dst)[COUNT], const E* src,
                                           int64_t stride, int t0, int S,
                                           int tid) {
  constexpr int kPer = 16 / sizeof(E);       // values a copy
  constexpr int kPieces = COUNT / kPer;      // copies a step
  constexpr int kCopies = kSteps * kPieces;
#pragma unroll
  for (int i = 0; i < (kCopies + NT - 1) / NT; ++i) {
    const int p = tid + i * NT;
    if (kCopies % NT == 0 || p < kCopies) {
      const int tt = p / kPieces, q = p % kPieces;
      const int t = t0 + tt;
      const bool live = t < S;
      if (ONES && !live)
        *reinterpret_cast<float4*>(&dst[tt][q * kPer]) =
            make_float4(1.f, 1.f, 1.f, 1.f);
      else
        cp_async16(&dst[tt][q * kPer],
                   src + (live ? t : S - 1) * stride + q * kPer, live);
    }
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// out[0:COUNT] <- the COUNT values at p, in f32 (p aligned to 16 bytes, or
// to 8 where COUNT is 4 bf16)
template <int COUNT>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float* out) {
  static_assert(COUNT == 4 || COUNT % 8 == 0, "whole 8- or 16-byte loads");
  if constexpr (COUNT == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(q.x);
    out[1] = bf16_hi(q.x);
    out[2] = bf16_lo(q.y);
    out[3] = bf16_hi(q.y);
  } else {
#pragma unroll
    for (int i = 0; i < COUNT; i += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      out[i + 0] = bf16_lo(q.x);
      out[i + 1] = bf16_hi(q.x);
      out[i + 2] = bf16_lo(q.y);
      out[i + 3] = bf16_hi(q.y);
      out[i + 4] = bf16_lo(q.z);
      out[i + 5] = bf16_hi(q.z);
      out[i + 6] = bf16_lo(q.w);
      out[i + 7] = bf16_hi(q.w);
    }
  }
}
template <int COUNT>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < COUNT; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    out[i + 0] = q.x;
    out[i + 1] = q.y;
    out[i + 2] = q.z;
    out[i + 3] = q.w;
  }
}

// y of 4 columns, rounded once to the output's dtype (16 or 8 bytes)
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::THREADS, 2)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, T* __restrict__ y,
                int S, int H) {
  using Sh = Shape<N>;
  constexpr int C = Sh::C, RG = Sh::RG, CG = Sh::CG, NC = Sh::NC;
  constexpr int kBoth = NC + Sh::NR;      // a tile barrier's threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, N>& sm = *reinterpret_cast<Smem<T, N>*>(smem_raw);

  const int bh = blockIdx.x / (N / C);          // row * H + head
  const int h = bh % H;
  const int j0 = (blockIdx.x % (N / C)) * C;    // the block's first column
  // step t of (row, head) starts at base + t * stride
  const int64_t base = (static_cast<int64_t>(bh / H) * S * H + h) * N;
  const int64_t stride = static_cast<int64_t>(H) * N;
  const int nchunk = (S + kSteps - 1) / kSteps;

  if (threadIdx.x < NC) {
    // ---- the compute warps: the state, the copies, the partial sums ----
    const int tid = threadIdx.x;
    const bool tile = tid < Sh::TILES;          // N=16: half the warp
    const int rg = tid / CG, cg = tid % CG;     // rows 4 rg.., cols 4 cg..
    const T* rs = r + base;
    const T* ks = k + base;
    const T* vs = v + base + j0;
    const float* ws = w + base;
    auto stage = [&](int c) {
      const int s = c % kStages, t0 = c * kSteps;
      stage_rows<NC, false>(sm.r[s], rs, stride, t0, S, tid);
      stage_rows<NC, false>(sm.k[s], ks, stride, t0, S, tid);
      stage_rows<NC, false>(sm.v[s], vs, stride, t0, S, tid);
      // w = 1 past S (and k = 0): those steps change no state
      stage_rows<NC, true>(sm.w[s], ws, stride, t0, S, tid);
    };
    float st[kTileR][kTile];
#pragma unroll
    for (int i = 0; i < kTileR; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) st[i][j] = 0.f;

    stage(0);
    cp_commit();
    if (nchunk > 1) stage(1);
    cp_commit();
    for (int c = 0; c < nchunk; ++c) {
      const int s = c % kStages, b = c % 2;
      // the reducers are done with chunk c - 2: its tile and its slot
      if (c >= 2) bar_sync(kBarEmpty + b, kBoth);
      if (c + 2 < nchunk) stage(c + 2);
      cp_commit();
      cp_wait<2>();                              // this thread's chunk c
      bar_sync(kBarCompute, NC);                 // ... every thread's
      if (tile) {
#pragma unroll
        for (int tt = 0; tt < kSteps; ++tt) {
          float ri[kTileR], ki[kTileR], wi[kTileR], vj[kTile], p[kTile];
          load_f32<kTileR>(&sm.r[s][tt][kTileR * rg], ri);
          load_f32<kTileR>(&sm.k[s][tt][kTileR * rg], ki);
          load_f32<kTileR>(&sm.w[s][tt][kTileR * rg], wi);
          load_f32<kTile>(&sm.v[s][tt][kTile * cg], vj);
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            p[j] = ri[0] * st[0][j];
#pragma unroll
            for (int i = 1; i < kTileR; ++i)
              p[j] = fmaf(ri[i], st[i][j], p[j]);
          }
#pragma unroll
          for (int i = 0; i < kTileR; ++i)
#pragma unroll
            for (int j = 0; j < kTile; ++j)
              st[i][j] = fmaf(wi[i], st[i][j], ki[i] * vj[j]);
          *reinterpret_cast<float4*>(&sm.part[b][tt][rg][kTile * cg]) =
              make_float4(p[0], p[1], p[2], p[3]);
        }
      }
      bar_arrive(kBarFull + b, kBoth);           // tile b holds chunk c
    }
    return;
  }

  // ---- the reducers: y from the partial sums, and a_t ----
  // reducer q: columns 4 g.. of step tt of each chunk, and rows ROWS g..
  // of a_t's dot product, summed over the CG lanes of the step by shuffles
  const int q = threadIdx.x - NC;
  const int tt = q / CG, g = q % CG;
  float uu[Sh::ROWS];
#pragma unroll
  for (int i = 0; i < Sh::ROWS; ++i) uu[i] = u[h * N + g * Sh::ROWS + i];
  T* yq = y + base + j0 + kTile * g;
  for (int c = 0; c < nchunk; ++c) {
    const int s = c % kStages, b = c % 2;
    bar_sync(kBarFull + b, kBoth);               // chunk c's partials
    float rv[Sh::ROWS], kv[Sh::ROWS], vq[kTile];
    load_f32<Sh::ROWS>(&sm.r[s][tt][g * Sh::ROWS], rv);
    load_f32<Sh::ROWS>(&sm.k[s][tt][g * Sh::ROWS], kv);
    load_f32<kTile>(&sm.v[s][tt][kTile * g], vq);
    // the row groups' partials in two interleaved sums, then added
    float4 even =
        *reinterpret_cast<const float4*>(&sm.part[b][tt][0][kTile * g]);
    float4 odd =
        *reinterpret_cast<const float4*>(&sm.part[b][tt][1][kTile * g]);
#pragma unroll
    for (int j = 2; j < RG; j += 2) {
      const float4 pe =
          *reinterpret_cast<const float4*>(&sm.part[b][tt][j][kTile * g]);
      const float4 po =
          *reinterpret_cast<const float4*>(&sm.part[b][tt][j + 1][kTile * g]);
      even.x += pe.x;
      even.y += pe.y;
      even.z += pe.z;
      even.w += pe.w;
      odd.x += po.x;
      odd.y += po.y;
      odd.z += po.z;
      odd.w += po.w;
    }
    float at = 0.f;
#pragma unroll
    for (int i = 0; i < Sh::ROWS; ++i) at = fmaf(rv[i], uu[i] * kv[i], at);
#pragma unroll
    for (int m = 1; m < CG; m *= 2) at += __shfl_xor_sync(0xffffffffu, at, m);
    const float yv[kTile] = {fmaf(at, vq[0], even.x + odd.x),
                             fmaf(at, vq[1], even.y + odd.y),
                             fmaf(at, vq[2], even.z + odd.z),
                             fmaf(at, vq[3], even.w + odd.w)};
    // every value read: tile b and slot s are free for chunk c + 2
    // (arrived on only where the compute warps will wait for it)
    if (c + 2 < nchunk) bar_arrive(kBarEmpty + b, kBoth);
    const int t = c * kSteps + tt;
    if (t < S) store4(yq + t * stride, yv);
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, int B, int S, int H,
           cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(Smem<T, N>));
  // more than 48 KB a block, and two blocks an SM want the largest carveout
  static const cudaError_t set = [] {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        wkv6_kernel<T, N>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }();
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = static_cast<int64_t>(B) * H * (N / Shape<N>::C);
  if (blocks > INT_MAX) return -1;
  wkv6_kernel<T, N><<<static_cast<int>(blocks), Shape<N>::THREADS, smem,
                      stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(y), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* w, const void* u, void* y, int B, int S, int H,
               cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, B, S, H, s);
    case 32: return launch<T, 32>(r, k, v, w, u, y, B, S, H, s);
    case 64: return launch<T, 64>(r, k, v, w, u, y, B, S, H, s);
    default: return -1;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// w and u are f32.  Returns 0, -1 for arguments the kernel does not take,
// or the CUDA error of the launch.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y, int is_bf16,
                           int B, int S, int H, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || !aligned16(r) || !aligned16(k) ||
      !aligned16(v) || !aligned16(w) || !aligned16(y))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, w, u, y, B, S, H, s);
  return dispatch_n<float>(N, r, k, v, w, u, y, B, S, H, s);
}
