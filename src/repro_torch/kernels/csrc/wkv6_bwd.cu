// The gradient of the RWKV6 WKV recurrence for Hopper (sm_90a), bound
// through a plain C interface (ctypes) by repro_torch/kernels/wkv6.py
// (`wkv6_bwd`, behind `Wkv6Fn`).
//
// Replaces the gradient of the TPU Pallas kernel `wkv6` of
// repro/kernels/wkv6.py:46: JAX cannot differentiate the Pallas kernel, so
// the reference trains through `jax.grad` of its scan
// (repro/models/layers/rwkv.py `_wkv_scan_ref`); this kernel computes that
// gradient of the same function.
//
// What it computes: r, k, v, dy [B,S,H,N] (all bf16, or all f32), w
// [B,S,H,N] and u [H,N] f32 -> dr, dk, dv [B,S,H,N] in r's dtype, dw
// [B,S,H,N] f32 and du [H,N] f32.  Per (row, head), with S_0 = 0 the
// N x N f32 state after t steps, the forward
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   y_t = r_t^T S_{t-1} + (r_t . (u o k_t)) v_t
// and the state's cotangent G_t = dL/dS_t (G after the last step = 0:
// training never reads the final state),
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T:
//   dr_t = S_{t-1} dy_t + (u o k_t)(v_t . dy_t)
//   dk_t = G_t v_t + (u o r_t)(v_t . dy_t)
//   dv_t = G_t^T k_t + (r_t . (u o k_t)) dy_t
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du = sum_{row,t} (r_t o k_t)(v_t . dy_t)
// Every input is read in f32 and every sum is f32; dr, dk, dv are rounded
// to r's dtype once (plain version: ref.wkv6_bwd_plain; the split of the
// sums below: ref.wkv6_bwd_split_plain).
//
// Bound: at the train shape (B=2, S=4096, H=32, N=64; r, k, v, dy, dr,
// dk, dv bf16, w, dw f32) the gradient needs 14 N^2 + 16 N f32 operations
// a (row, step, head): the state S_{t-1} it reads (k v^T, w S + k v^T:
// 3 N^2), G's update (r dy^T, w G + r dy^T: 3 N^2), the four sums over the
// state (S dy, G v, G^T k, G o S: 8 N^2); v . dy 2 N, a_t 3 N, the bonus
// terms of dr, dk, dv 8 N, du 3 N: 1.53e10, 0.2284 ms at 67 TFLOP/s
// (chip_smoke.py `wkv_bwd_bound`).  The bytes (r, k, v, dy, w read and dr,
// dk, dv, dw written once, 22 bytes an element: 0.369 GB) take 0.110 ms
// at 3.35 TB/s.  The operations bound it.  No product here is a matrix
// product for the tensor cores: each step is an outer product and
// matrix-vector products on a state that depends on the last.
//
// Design.  Both recurrences are linear with a per-row decay, so over a
// segment of L steps their effect composes: S_end = diag(P) S_start +
// S_local and G_{start-1} = diag(P) G_end + G_local, P the product of the
// segment's w, S_local and G_local the walks from zero.  Three passes, the
// sequence cut into segments of kSeg = 64 steps (B=2, S=4096: 64 segments,
// 4,096 blocks where one block a head's 32-column block had 128):
// 1. `wkv6_bwd_local`: segments in parallel take S_local and G_local as
//    sums of outer products, S_local = sum_t d_t o k_t v_t^T and G_local =
//    sum_t c_t o r_t dy_t^T (c_t, d_t the products of the segment's w
//    before and after step t, per-row scans), and write them and P to the
//    workspace.
// 2. `wkv6_bwd_combine`: one thread 4 state elements walks the segments
//    in order, in place: S_start[m+1] = P_m S_start[m] + S_local[m], then
//    G_end[m-1] = P_m G_end[m] + G_local[m].  It only multiplies, so it
//    never divides by w, which reaches 5e-6; a P that underflows to 0 is
//    the true product.
// 3. `wkv6_bwd_kernel`: segments in parallel, each from its own S_start
//    and G_end.  A block takes one (row, head, segment) and all N columns;
//    each thread keeps a 4 x 4 tile of the state and of G (N=64: 256
//    threads, one block an SM).  A forward sweep over the segment keeps
//    the state at the start of each of its 8-step chunks in shared memory
//    (7 tiles a thread); the reverse walk, chunk by chunk from the last,
//    rebuilds a chunk's 8 states into registers and walks them backwards:
//    the partials of S_{t-1} dy_t, G_t v_t, sum_j G_t S_{t-1} and G_t^T
//    k_t, then G's update.  So no state leaves the chip but the 2 per
//    segment of passes 1 and 2 (2 x 64 MiB at the train shape, where one
//    every 8 steps took 512 MiB).
// - Every 4 steps the block adds the partials in a fixed order: over its
//   column groups for dr, dk, dw (plus the bonus terms, from v . dy), over
//   its row groups for dv (plus a_t dy_t, a_t = r_t . (u o k_t)).  A head's
//   columns stay in one block, so dr, dk, dw leave once, with no partials
//   in device memory: two blocks of 32 columns a head, adding theirs
//   through distributed shared memory as one cluster, took 1.79 ms at the
//   train shape against this design's 1.34 (PERF.md §6).  du leaves
//   as one partial a (row, segment) that a small kernel adds in order.  No
//   atomics: two calls give the same bits.
// - Inputs stage by cp.async into a 2-slot ring, a chunk ahead, issued
//   after the barrier that opens a chunk (which also frees the other
//   slot); a step past S has r, k, v, dy zero and w one, so it changes
//   neither S nor G.
// Only N in {16, 32, 64} is built; every pointer 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kTile = 4;               // a thread's tile: 4 rows x 4 columns
constexpr int kSteps = 8;              // steps a chunk, rebuilt in registers
constexpr int kSeg = 64;               // steps a segment
constexpr int kChunks = kSeg / kSteps; // chunks a segment
constexpr int kHalf = kSteps / 2;      // steps whose partials add at once
constexpr int kPad = 4;                // floats after a partial row (banks)

template <int N>
struct Shape {
  static constexpr int RG = N / kTile;                   // row groups
  static constexpr int CG = N / kTile;                   // column groups
  static constexpr int TILES = RG * CG;
  static constexpr int NT = TILES < 32 ? 32 : TILES;     // whole warps
  static constexpr int Q = NT / kSteps;                  // a step's scalars
  static_assert(NT % N == 0, "a row's du in NT / N threads");
  static_assert(kHalf * N % NT == 0, "items");
  static_assert(NT % kSteps == 0 && N % Q == 0 && Q <= 32, "scalars");
};

// pass 1: the segment's inputs at once (r, k, v, dy in T; w f32), and r
// and k weighted by their decay products
template <typename T, int N>
struct LocalSmem {
  alignas(16) T r[kSeg][N];
  alignas(16) T k[kSeg][N];
  alignas(16) T v[kSeg][N];
  alignas(16) T dy[kSeg][N];
  alignas(16) float w[kSeg][N];
  alignas(16) float rc[kSeg][N];   // c_t r_t, c_t = prod_{tau < t} w_tau
  alignas(16) float kd[kSeg][N];   // d_t k_t, d_t = prod_{tau > t} w_tau
  alignas(16) float p[N];          // the segment's product of w
};

// pass 3
template <typename T, int N>
struct Smem {
  static constexpr int CG = Shape<N>::CG;
  static constexpr int NT = Shape<N>::NT;
  // the ring: chunks as they arrive
  alignas(16) T r[2][kSteps][N];
  alignas(16) T k[2][kSteps][N];
  alignas(16) T v[2][kSteps][N];
  alignas(16) T dy[2][kSteps][N];
  alignas(16) float w[2][kSteps][N];
  float u[N];
  // each thread's tile of the state at the start of chunks 0 .. kChunks-2
  // (the last chunk's start stays in registers)
  float4 ckpt[kChunks - 1][kTile][NT];
  // each thread's partial sums at each of 4 steps: over its 4 columns of
  // S_{t-1} dy_t, G_t v_t and G_t o S_{t-1} (4 rows each), over its 4 rows
  // of G_t^T k_t (4 columns)
  float pr[kHalf][CG][N + kPad];
  float pk[kHalf][CG][N + kPad];
  float pw[kHalf][CG][N + kPad];
  float pv[kHalf][Shape<N>::RG][N];
  float vdy[kSteps];    // v_t . dy_t
  float at[kSteps];     // r_t . (u o k_t)
  float du[NT];
};

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

// COUNT values a step for STEPS steps from step t0, from src (step t at
// src + t * stride) into dst[step][COUNT], in 16-byte copies spread over
// the block's NT threads.  A step past S is zero-filled by the copy's
// source size or, with ONES, set to 1 by a store.
template <int NT, int STEPS, bool ONES, typename E, int COUNT>
__device__ __forceinline__ void stage_rows(E (*dst)[COUNT], const E* src,
                                           int64_t stride, int t0, int S,
                                           int tid) {
  constexpr int kPer = 16 / sizeof(E);       // values a copy
  constexpr int kPieces = COUNT / kPer;      // copies a step
  constexpr int kCopies = STEPS * kPieces;
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// out[0:4] <- the 4 values at p, in f32 (bf16: 8-byte aligned; f32: 16)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  out[0] = bf16_lo(q.x);
  out[1] = bf16_hi(q.x);
  out[2] = bf16_lo(q.y);
  out[3] = bf16_hi(q.y);
}
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}

// one step of a recurrence on a thread's tile: x = diag(a) x + b c^T
__device__ __forceinline__ void step_tile(float (&x)[kTile][kTile],
                                          const float* a, const float* b,
                                          const float* c) {
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) x[i][j] = fmaf(a[i], x[i][j], b[i] * c[j]);
}

// the block's (row, head, segment) from blockIdx.x, the segment fastest
struct Place {
  int seg, bh, b, h;
};

__device__ __forceinline__ Place place(int H, int nseg) {
  Place p;
  p.seg = blockIdx.x % nseg;
  p.bh = blockIdx.x / nseg;
  p.b = p.bh / H;
  p.h = p.bh % H;
  return p;
}

// ---- pass 1: each segment's walks from zero, as sums of outer products:
// S_local = sum_t d_t o k_t v_t^T and G_local = sum_t c_t o r_t dy_t^T,
// c_t and d_t the products of the segment's w before and after step t
// (per-row scans: products, never quotients) ----
template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::NT)
    wkv6_bwd_local(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const T* __restrict__ dy, float* __restrict__ sb,
                   float* __restrict__ gb, float* __restrict__ pb, int S,
                   int H, int nseg) {
  using Sh = Shape<N>;
  constexpr int CG = Sh::CG, NT = Sh::NT;
  static_assert(2 * N <= NT, "a thread a row's scan");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LocalSmem<T, N>& sm = *reinterpret_cast<LocalSmem<T, N>*>(smem_raw);
  const int tid = threadIdx.x;
  const Place pl = place(H, nseg);
  const int t0 = pl.seg * kSeg;
  const int64_t base = (static_cast<int64_t>(pl.b) * S * H + pl.h) * N;
  const int64_t stride = static_cast<int64_t>(H) * N;
  stage_rows<NT, kSeg, false>(sm.r, r + base, stride, t0, S, tid);
  stage_rows<NT, kSeg, false>(sm.k, k + base, stride, t0, S, tid);
  stage_rows<NT, kSeg, false>(sm.v, v + base, stride, t0, S, tid);
  stage_rows<NT, kSeg, false>(sm.dy, dy + base, stride, t0, S, tid);
  stage_rows<NT, kSeg, true>(sm.w, w + base, stride, t0, S, tid);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // the scans: threads 0..N-1 c_t r_t forward, N..2N-1 d_t k_t backward
  if (tid < N) {
    float c = 1.f;
#pragma unroll 8
    for (int tt = 0; tt < kSeg; ++tt) {
      sm.rc[tt][tid] = c * to_f32(sm.r[tt][tid]);
      c *= sm.w[tt][tid];
    }
    sm.p[tid] = c;
  } else if (tid < 2 * N) {
    const int i = tid - N;
    float d = 1.f;
#pragma unroll 8
    for (int tt = kSeg - 1; tt >= 0; --tt) {
      sm.kd[tt][i] = d * to_f32(sm.k[tt][i]);
      d *= sm.w[tt][i];
    }
  }
  __syncthreads();
  if (tid >= Sh::TILES) return;
  const int rg = tid / CG, cg = tid % CG;
  float s[kTile][kTile], g[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[i][j] = g[i][j] = 0.f;
#pragma unroll 4
  for (int tt = 0; tt < kSeg; ++tt) {
    float ki[kTile], vj[kTile], ri[kTile], dj[kTile];
    load4(&sm.kd[tt][kTile * rg], ki);
    load4(&sm.v[tt][kTile * cg], vj);
    load4(&sm.rc[tt][kTile * rg], ri);
    load4(&sm.dy[tt][kTile * cg], dj);
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        s[i][j] = fmaf(ki[i], vj[j], s[i][j]);
        g[i][j] = fmaf(ri[i], dj[j], g[i][j]);
      }
  }
  const int64_t slot = (static_cast<int64_t>(pl.bh) * nseg + pl.seg) * N;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int64_t o = (slot + kTile * rg + i) * N + kTile * cg;
    *reinterpret_cast<float4*>(sb + o) =
        make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    *reinterpret_cast<float4*>(gb + o) =
        make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
  }
  if (cg == 0)
    *reinterpret_cast<float4*>(pb + slot + kTile * rg) =
        *reinterpret_cast<const float4*>(&sm.p[kTile * rg]);
}

// ---- pass 2: the segments in order, one thread 4 state elements of a
// row ----
__device__ __forceinline__ float4 fma4(float p, float4 x, float4 y) {
  return make_float4(fmaf(p, x.x, y.x), fmaf(p, x.y, y.y), fmaf(p, x.z, y.z),
                     fmaf(p, x.w, y.w));
}

__global__ void wkv6_bwd_combine(float* __restrict__ sb, float* __restrict__ gb,
                                 const float* __restrict__ pb, int64_t quads,
                                 int N, int nseg) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (e >= quads) return;
  const int64_t nq = static_cast<int64_t>(N) * N / 4;   // quads a state
  const int64_t bh = e / nq, q = e % nq;
  float4* sp = reinterpret_cast<float4*>(sb) + bh * nseg * nq + q;
  float4* gp = reinterpret_cast<float4*>(gb) + bh * nseg * nq + q;
  const float* pp = pb + bh * nseg * N + q * 4 / N;
  constexpr int kAhead = 8;              // loads in flight ahead of the walk
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m0 = 0; m0 < nseg; m0 += kAhead) {
    float4 y[kAhead];
    float pw[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (m0 + d < nseg) {
        y[d] = sp[(m0 + d) * nq];
        pw[d] = pp[(m0 + d) * N];
      }
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (m0 + d < nseg) {
        sp[(m0 + d) * nq] = x;             // S_start[m]
        x = fma4(pw[d], x, y[d]);
      }
  }
  x = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m0 = nseg - 1; m0 >= 0; m0 -= kAhead) {
    float4 y[kAhead];
    float pw[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (m0 - d >= 0) {
        y[d] = gp[(m0 - d) * nq];
        pw[d] = pp[(m0 - d) * N];
      }
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (m0 - d >= 0) {
        gp[(m0 - d) * nq] = x;             // G_end[m]
        x = fma4(pw[d], x, y[d]);
      }
  }
}

// ---- pass 3: each segment's gradient from its start state and end
// cotangent ----
template <typename T>
struct Args {
  const T* r;
  const T* k;
  const T* v;
  const float* w;
  const float* u;
  const T* dy;
  T* dr;
  T* dk;
  T* dv;
  float* dw;
  const float* sb;
  const float* gb;
  float* du_part;
  int S, H, nseg;
};

template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::NT, Shape<N>::NT <= 128 ? 2 : 1)
    wkv6_bwd_kernel(const Args<T> a) {
  using Sh = Shape<N>;
  constexpr int CG = Sh::CG, RG = Sh::RG, NT = Sh::NT, Q = Sh::Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, N>& sm = *reinterpret_cast<Smem<T, N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int S = a.S, H = a.H;
  const Place pl = place(H, a.nseg);
  const int t0 = pl.seg * kSeg;
  const int nc = (min(kSeg, S - t0) + kSteps - 1) / kSteps;
  // step t of (row, head) starts at base + t * stride
  const int64_t base = (static_cast<int64_t>(pl.b) * S * H + pl.h) * N;
  const int64_t stride = static_cast<int64_t>(H) * N;
  const bool tile = tid < Sh::TILES;            // N=16: half the warp
  const int rg = tid / CG, cg = tid % CG;       // rows 4 rg.., cols 4 cg..
  const int64_t slot = (static_cast<int64_t>(pl.bh) * a.nseg + pl.seg) * N;

  for (int i = tid; i < N; i += NT) sm.u[i] = a.u[pl.h * N + i];

  auto stage = [&](int c, int s, bool all) {
    const int tc = t0 + c * kSteps;
    stage_rows<NT, kSteps, false>(sm.k[s], a.k + base, stride, tc, S, tid);
    stage_rows<NT, kSteps, false>(sm.v[s], a.v + base, stride, tc, S, tid);
    // w = 1 past S (and k = 0): those steps change no state
    stage_rows<NT, kSteps, true>(sm.w[s], a.w + base, stride, tc, S, tid);
    if (all) {
      stage_rows<NT, kSteps, false>(sm.r[s], a.r + base, stride, tc, S, tid);
      stage_rows<NT, kSteps, false>(sm.dy[s], a.dy + base, stride, tc, S,
                                    tid);
    }
  };

  // the segment's start state and end cotangent (passes 1 and 2)
  float st[kTile][kTile], g[kTile][kTile];
  if (tile) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int64_t o = (slot + kTile * rg + i) * N + kTile * cg;
      const float4 x = *reinterpret_cast<const float4*>(a.sb + o);
      const float4 y = *reinterpret_cast<const float4*>(a.gb + o);
      st[i][0] = x.x, st[i][1] = x.y, st[i][2] = x.z, st[i][3] = x.w;
      g[i][0] = y.x, g[i][1] = y.y, g[i][2] = y.z, g[i][3] = y.w;
    }
  }

  // ---- the forward sweep: the state at the start of every chunk ----
  stage(0, 0, nc == 1);
  cp_commit();
  for (int c = 0; c + 1 < nc; ++c) {
    const int s = c & 1;
    cp_wait<0>();                               // chunk c, every thread's,
    __syncthreads();                            // and slot s ^ 1 read
    stage(c + 1, s ^ 1, c + 2 == nc);
    cp_commit();
    if (tile) {
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        sm.ckpt[c][i][tid] = make_float4(st[i][0], st[i][1], st[i][2],
                                         st[i][3]);
#pragma unroll
      for (int tt = 0; tt < kSteps; ++tt) {
        float ki[kTile], wi[kTile], vj[kTile];
        load4(&sm.k[s][tt][kTile * rg], ki);
        load4(&sm.w[s][tt][kTile * rg], wi);
        load4(&sm.v[s][tt][kTile * cg], vj);
        step_tile(st, wi, ki, vj);
      }
    }
  }

  // ---- the reverse walk, chunk by chunk from the last ----
  float du_acc = 0.f;                           // row tid % N's du
  constexpr int IT = kHalf * N / NT;            // a thread's rows a half
  for (int c = nc - 1; c >= 0; --c) {
    const int s = c & 1;
    // the chunk's states S_{t-1}, rebuilt from its start
    float sp[kSteps][kTile][kTile];
    if (tile) {
      if (c == nc - 1) {
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j) sp[0][i][j] = st[i][j];
      } else {
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const float4 q = sm.ckpt[c][i][tid];
          sp[0][i][0] = q.x, sp[0][i][1] = q.y, sp[0][i][2] = q.z;
          sp[0][i][3] = q.w;
        }
      }
    }
    cp_wait<0>();                               // chunk c in; slot s ^ 1
    __syncthreads();                            // and the partials read
    if (c > 0) stage(c - 1, s ^ 1, true);
    cp_commit();
    // each step's scalars, v . dy and a_t = r . (u o k), Q threads a step,
    // added by shuffles
    {
      const int tt = tid / Q, l = tid % Q;
      float d = 0.f, at = 0.f;
#pragma unroll
      for (int x = 0; x < N / Q; ++x) {
        const int i = l * (N / Q) + x;
        d = fmaf(to_f32(sm.v[s][tt][i]), to_f32(sm.dy[s][tt][i]), d);
        at = fmaf(to_f32(sm.r[s][tt][i]), sm.u[i] * to_f32(sm.k[s][tt][i]),
                  at);
      }
#pragma unroll
      for (int o = Q / 2; o > 0; o /= 2) {
        d += __shfl_xor_sync(0xffffffffu, d, o);
        at += __shfl_xor_sync(0xffffffffu, at, o);
      }
      if (l == 0) {
        sm.vdy[tt] = d;
        sm.at[tt] = at;
      }
    }
    if (tile) {
#pragma unroll
      for (int tt = 0; tt + 1 < kSteps; ++tt) {
        float ki[kTile], wi[kTile], vj[kTile];
        load4(&sm.k[s][tt][kTile * rg], ki);
        load4(&sm.w[s][tt][kTile * rg], wi);
        load4(&sm.v[s][tt][kTile * cg], vj);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            sp[tt + 1][i][j] = fmaf(wi[i], sp[tt][i][j], ki[i] * vj[j]);
      }
    }
#pragma unroll
    for (int hf = 1; hf >= 0; --hf) {
      // the half's steps backwards: G_t's sums, then G_{t-1}
      if (tile) {
#pragma unroll
        for (int x = kHalf - 1; x >= 0; --x) {
          const int tt = hf * kHalf + x;
          float ri[kTile], ki[kTile], wi[kTile], vj[kTile], dj[kTile];
          float pr[kTile], pk[kTile], pw[kTile], pv[kTile];
          load4(&sm.r[s][tt][kTile * rg], ri);
          load4(&sm.k[s][tt][kTile * rg], ki);
          load4(&sm.w[s][tt][kTile * rg], wi);
          load4(&sm.v[s][tt][kTile * cg], vj);
          load4(&sm.dy[s][tt][kTile * cg], dj);
#pragma unroll
          for (int i = 0; i < kTile; ++i) {
            pr[i] = sp[tt][i][0] * dj[0];
            pk[i] = g[i][0] * vj[0];
            pw[i] = g[i][0] * sp[tt][i][0];
#pragma unroll
            for (int j = 1; j < kTile; ++j) {
              pr[i] = fmaf(sp[tt][i][j], dj[j], pr[i]);
              pk[i] = fmaf(g[i][j], vj[j], pk[i]);
              pw[i] = fmaf(g[i][j], sp[tt][i][j], pw[i]);
            }
          }
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            pv[j] = g[0][j] * ki[0];
#pragma unroll
            for (int i = 1; i < kTile; ++i) pv[j] = fmaf(g[i][j], ki[i], pv[j]);
          }
          *reinterpret_cast<float4*>(&sm.pr[x][cg][kTile * rg]) =
              make_float4(pr[0], pr[1], pr[2], pr[3]);
          *reinterpret_cast<float4*>(&sm.pk[x][cg][kTile * rg]) =
              make_float4(pk[0], pk[1], pk[2], pk[3]);
          *reinterpret_cast<float4*>(&sm.pw[x][cg][kTile * rg]) =
              make_float4(pw[0], pw[1], pw[2], pw[3]);
          *reinterpret_cast<float4*>(&sm.pv[x][rg][kTile * cg]) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
          step_tile(g, wi, ri, dj);
        }
      }
      __syncthreads();
      // dr, dk, dw over the columns, the bonus terms added
      const int tc = t0 + c * kSteps + hf * kHalf;   // the half's first step
#pragma unroll
      for (int m = 0; m < IT; ++m) {
        const int q = tid + m * NT;
        const int x = q / N, i = q % N, tt = hf * kHalf + x, t = tc + x;
        float p0 = sm.pr[x][0][i], p1 = sm.pk[x][0][i], p2 = sm.pw[x][0][i];
#pragma unroll
        for (int y = 1; y < CG; ++y) {
          p0 += sm.pr[x][y][i];
          p1 += sm.pk[x][y][i];
          p2 += sm.pw[x][y][i];
        }
        const float rr = to_f32(sm.r[s][tt][i]), kk = to_f32(sm.k[s][tt][i]);
        const float d = sm.vdy[tt], uu = sm.u[i];
        du_acc = fmaf(rr * kk, d, du_acc);      // 0 past S (r, k zero)
        if (t < S) {
          const int64_t o = base + static_cast<int64_t>(t) * stride + i;
          a.dr[o] = from_f32<T>(fmaf(uu * kk, d, p0));
          a.dk[o] = from_f32<T>(fmaf(uu * rr, d, p1));
          a.dw[o] = p2;
        }
      }
      // dv over all rows
#pragma unroll
      for (int m = 0; m < IT; ++m) {
        const int q = tid + m * NT;
        const int x = q / N, j = q % N, tt = hf * kHalf + x, t = tc + x;
        float p = sm.pv[x][0][j];
#pragma unroll
        for (int y = 1; y < RG; ++y) p += sm.pv[x][y][j];
        p = fmaf(sm.at[tt], to_f32(sm.dy[s][tt][j]), p);
        if (t < S)
          a.dv[base + static_cast<int64_t>(t) * stride + j] =
              from_f32<T>(p);
      }
      if (hf == 1) __syncthreads();             // the partials read
    }
  }
  // du of the (row, segment): a row's NT / N threads in thread order
  sm.du[tid] = du_acc;
  __syncthreads();
  if (tid < N) {
    float d = sm.du[tid];
    for (int q = tid + N; q < NT; q += N) d += sm.du[q];
    a.du_part[(static_cast<int64_t>(pl.b) * a.nseg + pl.seg) * H * N +
              pl.h * N + tid] = d;
  }
}

// du: the (row, segment) partials added in order
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, int parts,
                            int HN, float* __restrict__ du) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HN) return;
  float a = du_part[i];
  for (int p = 1; p < parts; ++p)
    a += du_part[static_cast<int64_t>(p) * HN + i];
  du[i] = a;
}

int segments(int S) { return (S + kSeg - 1) / kSeg; }

template <int N>
int64_t workspace_floats(int B, int S, int H) {
  const int64_t bhs = static_cast<int64_t>(B) * H * segments(S);
  return 2 * bhs * N * N + 2 * bhs * N;
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, void* dr, void* dk, void* dv,
           void* dw, void* du, float* ws, int64_t ws_floats, int B, int S,
           int H, cudaStream_t stream) {
  using Sh = Shape<N>;
  if (ws_floats < workspace_floats<N>(B, S, H)) return -1;
  const int nseg = segments(S);
  const int64_t blocks = static_cast<int64_t>(B) * H * nseg;
  if (blocks > INT_MAX) return -1;
  const int smem_local = static_cast<int>(sizeof(LocalSmem<T, N>));
  const int smem = static_cast<int>(sizeof(Smem<T, N>));
  static const cudaError_t set = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_local<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_local);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_kernel<T, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_kernel<T, N>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t bhs = static_cast<int64_t>(B) * H * nseg;
  float* sb = ws;
  float* gb = sb + bhs * N * N;
  float* pb = gb + bhs * N * N;
  float* du_part = pb + bhs * N;
  wkv6_bwd_local<T, N><<<static_cast<int>(blocks), Sh::NT, smem_local,
                         stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(dy), sb, gb, pb, S, H, nseg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t quads = static_cast<int64_t>(B) * H * N * N / 4;
  wkv6_bwd_combine<<<static_cast<int>((quads + 127) / 128), 128, 0,
                     stream>>>(sb, gb, pb, quads, N, nseg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  Args<T> a;
  a.r = static_cast<const T*>(r);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.dy = static_cast<const T*>(dy);
  a.dr = static_cast<T*>(dr);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.dw = static_cast<float*>(dw);
  a.sb = sb;
  a.gb = gb;
  a.du_part = du_part;
  a.S = S;
  a.H = H;
  a.nseg = nseg;
  wkv6_bwd_kernel<T, N><<<static_cast<int>(blocks), Sh::NT, smem, stream>>>(
      a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_du<<<(H * N + 255) / 256, 256, 0, stream>>>(
      du_part, static_cast<int>(bhs / H), H * N,
      static_cast<float*>(du));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* w, const void* u, const void* dy, void* dr,
               void* dk, void* dv, void* dw, void* du, float* ws,
               int64_t ws_floats, int B, int S, int H, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, dy, dr, dk, dv, dw, du, ws,
                           ws_floats, B, S, H, s);
    case 32:
      return launch<T, 32>(r, k, v, w, u, dy, dr, dk, dv, dw, du, ws,
                           ws_floats, B, S, H, s);
    case 64:
      return launch<T, 64>(r, k, v, w, u, dy, dr, dk, dv, dw, du, ws,
                           ws_floats, B, S, H, s);
    default:
      return -1;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// w and u are f32; dw and du f32; ws a float workspace of ws_floats
// (repro_torch/kernels/wkv6.py `bwd_workspace_floats`).  Returns 0, -1
// for arguments the kernel does not take, or the CUDA error of a launch.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* dy,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ws, long long ws_floats,
                               int is_bf16, int B, int S, int H, int N,
                               void* stream) {
  const void* ptrs[] = {r, k, v, w, u, dy, dr, dk, dv, dw, du, ws};
  for (const void* p : ptrs)
    if (!aligned16(p)) return -1;
  if (B <= 0 || S <= 0 || H <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (is_bf16)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, w, u, dy, dr, dk, dv, dw,
                                     du, wsf, ws_floats, B, S, H, s);
  return dispatch_n<float>(N, r, k, v, w, u, dy, dr, dk, dv, dw, du, wsf,
                           ws_floats, B, S, H, s);
}
