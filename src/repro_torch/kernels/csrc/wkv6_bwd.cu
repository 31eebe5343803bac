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
// dk, dv bf16, w, dw f32) the gradient needs 14 N^2 + 12 N f32 operations
// a (row, step, head): the state S_{t-1} it reads (k v^T, w S + k v^T:
// 3 N^2), G's update (r dy^T, w G + r dy^T: 3 N^2), the four sums over the
// state (S dy, G v, G^T k, G o S: 8 N^2), the bonus terms and v . dy
// (12 N): 1.52e10, 0.227 ms at 67 TFLOP/s.  The bytes (r, k, v, dy, w
// read and dr, dk, dv, dw written once, 22 bytes an element: 0.369 GB)
// take 0.110 ms at 3.35 TB/s.  The operations bound it.  No product here
// is a matrix product for the tensor cores: each step is an outer product
// and matrix-vector products on a state that depends on the last.
//
// Design.  A block takes one (row, head) and a block of C = min(N, 32) of
// its columns, as the forward kernel does (N=64: 256 blocks at B=4, two
// a head); each thread keeps a 4 x 4 tile of the state (rows 4 rg..,
// columns 4 cg..) and of G in registers.  A row i of the state decays by
// w_t[i] alone, so a column block holds everything dv needs (sums over
// rows) and a share of dr, dk, dw and du (sums over columns).
// - Forward sweep: the block runs the recurrence over the sequence in
//   chunks of 8 steps and writes the state at the start of each chunk to
//   a workspace (f32, B H ceil(S/8) N^2 floats): S_{t-1} is never
//   recovered by dividing by w, which reaches 5e-6.
// - Reverse walk, chunk by chunk from the last: the chunk's boundary
//   state is read back and the chunk's 8 states rebuilt into shared
//   memory (each thread its own tile, so no barrier between the two);
//   the rebuild also forms the partial sums of S_{t-1} dy_t.  Then the
//   steps run backwards: the partials of G_t v_t, G_t^T k_t and
//   sum_j G_t S_{t-1}, then G's update.
// - After each chunk the block adds the partials in a fixed order: over
//   its column groups for dr, dk, dw (plus the bonus terms, from v . dy
//   over the block's columns), over its row groups for dv (plus a_t dy_t,
//   a_t = r_t . (u o k_t) over all rows).  dr, dk, dw leave as one f32
//   partial a column block, du as one a (row, column block); a fold
//   kernel adds them in block order and rounds dr and dk once.  No
//   atomics: two calls give the same bits.
// - Inputs stage by cp.async into a 2-slot ring, a chunk ahead; a step
//   past S has r, k, v, dy zero and w one, so it changes neither S nor G.
// Only N in {16, 32, 64} is built; every pointer 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kTile = 4;       // a thread's tile: 4 rows x 4 columns
constexpr int kSteps = 8;      // steps a chunk; the state kept at its start
constexpr int kMaxCols = 32;   // columns a block
constexpr int kPad = 4;        // floats after each partial row (banks)

template <int N>
struct Shape {
  static constexpr int C = N < kMaxCols ? N : kMaxCols;  // columns a block
  static constexpr int NCB = N / C;                      // blocks a head
  static constexpr int RG = N / kTile;                   // row groups
  static constexpr int CG = C / kTile;                   // column groups
  static constexpr int TILES = RG * CG;
  static constexpr int NT = TILES < 32 ? 32 : TILES;     // whole warps
  static_assert(NT % N == 0, "a row's du in NT / N threads");
  static_assert(kSteps * N % NT == 0 && kSteps * C % NT == 0, "items");
  static_assert(2 * kSteps <= NT, "a thread a step's scalar");
};

template <typename T, int N>
struct Smem {
  static constexpr int C = Shape<N>::C;
  static constexpr int CG = Shape<N>::CG;
  // each thread's tile of S_{t-1} at each step of the chunk
  float4 st[kSteps][kTile][Shape<N>::NT];
  // the ring: chunks as they arrive (r, k, v, dy in T; w f32)
  T r[2][kSteps][N];
  T k[2][kSteps][N];
  T v[2][kSteps][C];
  T dy[2][kSteps][C];
  float w[2][kSteps][N];
  float u[N];
  // each thread's partial sums at each step: over its 4 columns of
  // S_{t-1} dy_t, G_t v_t and G_t o S_{t-1} (4 rows each), over its 4 rows
  // of G_t^T k_t (4 columns)
  float pr[kSteps][CG][N + kPad];
  float pk[kSteps][CG][N + kPad];
  float pw[kSteps][CG][N + kPad];
  float pv[kSteps][Shape<N>::RG][C];
  float vdy[kSteps];    // v_t . dy_t over the block's columns
  float at[kSteps];     // r_t . (u o k_t) over all rows
  float du[Shape<N>::NT];
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

// COUNT values a step of the chunk at step t0, from src (step t at
// src + t * stride) into dst[step][COUNT], in 16-byte copies spread over
// the block's NT threads.  A step past S is zero-filled by the copy's
// source size or, with ONES, set to 1 by a store.
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

template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::NT)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const T* __restrict__ dy,
                    T* __restrict__ dv, float* __restrict__ states,
                    float* __restrict__ part, float* __restrict__ du_part,
                    int B, int S, int H) {
  using Sh = Shape<N>;
  constexpr int C = Sh::C, NCB = Sh::NCB, CG = Sh::CG, RG = Sh::RG;
  constexpr int NT = Sh::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, N>& sm = *reinterpret_cast<Smem<T, N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / NCB;              // row * H + head
  const int cb = blockIdx.x % NCB;              // the column block
  const int b = bh / H, h = bh % H;
  const int j0 = cb * C;
  // step t of (row, head) starts at base + t * stride
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * N;
  const int64_t stride = static_cast<int64_t>(H) * N;
  const int64_t plane = static_cast<int64_t>(B) * S * H * N;
  const int nchunk = (S + kSteps - 1) / kSteps;
  const bool tile = tid < Sh::TILES;            // N=16: half the warp
  const int rg = tid / CG, cg = tid % CG;       // rows 4 rg.., cols 4 cg..
  // the block's boundary states [nchunk][N][C], its partials of dr, dk, dw
  float* kept = states + static_cast<int64_t>(blockIdx.x) * nchunk * N * C;
  float* out_r = part + cb * plane;
  float* out_k = part + (NCB + cb) * plane;
  float* out_w = part + (2 * NCB + cb) * plane;

  for (int i = tid; i < N; i += NT) sm.u[i] = u[h * N + i];

  auto stage = [&](int c, int s, bool all) {
    const int t0 = c * kSteps;
    stage_rows<NT, false>(sm.k[s], k + base, stride, t0, S, tid);
    stage_rows<NT, false>(sm.v[s], v + base + j0, stride, t0, S, tid);
    // w = 1 past S (and k = 0): those steps change no state
    stage_rows<NT, true>(sm.w[s], w + base, stride, t0, S, tid);
    if (all) {
      stage_rows<NT, false>(sm.r[s], r + base, stride, t0, S, tid);
      stage_rows<NT, false>(sm.dy[s], dy + base + j0, stride, t0, S, tid);
    }
  };

  // ---- the forward sweep: the state at the start of every chunk ----
  float st[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) st[i][j] = 0.f;
  stage(0, 0, false);
  cp_commit();
  for (int c = 0; c < nchunk; ++c) {
    const int s = c & 1;
    if (c + 1 < nchunk) stage(c + 1, s ^ 1, false);
    cp_commit();
    cp_wait<1>();                               // chunk c, every thread's
    __syncthreads();
    if (tile) {
      float* o = kept + (static_cast<int64_t>(c) * N + kTile * rg) * C +
                 kTile * cg;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        *reinterpret_cast<float4*>(o + i * C) =
            make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
#pragma unroll
      for (int tt = 0; tt < kSteps; ++tt) {
        float ki[kTile], wi[kTile], vj[kTile];
        load4(&sm.k[s][tt][kTile * rg], ki);
        load4(&sm.w[s][tt][kTile * rg], wi);
        load4(&sm.v[s][tt][kTile * cg], vj);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            st[i][j] = fmaf(wi[i], st[i][j], ki[i] * vj[j]);
      }
    }
    __syncthreads();                            // slot s free again
  }

  // ---- the reverse walk, chunk by chunk from the last ----
  float g[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) g[i][j] = 0.f;
  float du_acc = 0.f;                           // row tid % N's du
  stage(nchunk - 1, 0, true);
  cp_commit();
  for (int m = 0; m < nchunk; ++m) {
    const int c = nchunk - 1 - m, s = m & 1;
    if (c > 0) stage(c - 1, s ^ 1, true);
    cp_commit();
    if (tile) {                                 // this thread's own writes
      const float* o = kept + (static_cast<int64_t>(c) * N + kTile * rg) * C +
                       kTile * cg;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(o + i * C);
        st[i][0] = q.x;
        st[i][1] = q.y;
        st[i][2] = q.z;
        st[i][3] = q.w;
      }
    }
    cp_wait<1>();
    __syncthreads();
    // each step's scalars, read after the chunk: v . dy (the block's
    // columns) and a_t = r . (u o k) (all rows)
    if (tid < kSteps) {
      float a = 0.f;
      for (int j = 0; j < C; ++j)
        a = fmaf(to_f32(sm.v[s][tid][j]), to_f32(sm.dy[s][tid][j]), a);
      sm.vdy[tid] = a;
    } else if (tid < 2 * kSteps) {
      const int tt = tid - kSteps;
      float a = 0.f;
      for (int i = 0; i < N; ++i)
        a = fmaf(to_f32(sm.r[s][tt][i]), sm.u[i] * to_f32(sm.k[s][tt][i]),
                 a);
      sm.at[tt] = a;
    }
    if (tile) {
      // the chunk's states rebuilt, and S_{t-1} dy_t over 4 columns
#pragma unroll
      for (int tt = 0; tt < kSteps; ++tt) {
        float ki[kTile], wi[kTile], vj[kTile], dj[kTile], p[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          sm.st[tt][i][tid] =
              make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
        load4(&sm.k[s][tt][kTile * rg], ki);
        load4(&sm.w[s][tt][kTile * rg], wi);
        load4(&sm.v[s][tt][kTile * cg], vj);
        load4(&sm.dy[s][tt][kTile * cg], dj);
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          p[i] = st[i][0] * dj[0];
#pragma unroll
          for (int j = 1; j < kTile; ++j) p[i] = fmaf(st[i][j], dj[j], p[i]);
        }
        *reinterpret_cast<float4*>(&sm.pr[tt][cg][kTile * rg]) =
            make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            st[i][j] = fmaf(wi[i], st[i][j], ki[i] * vj[j]);
      }
      // the steps backwards: G_t's sums, then G_{t-1}
#pragma unroll
      for (int tt = kSteps - 1; tt >= 0; --tt) {
        float ri[kTile], ki[kTile], wi[kTile], vj[kTile], dj[kTile];
        float sp[kTile][kTile], pk[kTile], pw[kTile], pv[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const float4 q = sm.st[tt][i][tid];
          sp[i][0] = q.x;
          sp[i][1] = q.y;
          sp[i][2] = q.z;
          sp[i][3] = q.w;
        }
        load4(&sm.r[s][tt][kTile * rg], ri);
        load4(&sm.k[s][tt][kTile * rg], ki);
        load4(&sm.w[s][tt][kTile * rg], wi);
        load4(&sm.v[s][tt][kTile * cg], vj);
        load4(&sm.dy[s][tt][kTile * cg], dj);
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          pk[i] = g[i][0] * vj[0];
          pw[i] = g[i][0] * sp[i][0];
#pragma unroll
          for (int j = 1; j < kTile; ++j) {
            pk[i] = fmaf(g[i][j], vj[j], pk[i]);
            pw[i] = fmaf(g[i][j], sp[i][j], pw[i]);
          }
        }
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          pv[j] = g[0][j] * ki[0];
#pragma unroll
          for (int i = 1; i < kTile; ++i) pv[j] = fmaf(g[i][j], ki[i], pv[j]);
        }
        *reinterpret_cast<float4*>(&sm.pk[tt][cg][kTile * rg]) =
            make_float4(pk[0], pk[1], pk[2], pk[3]);
        *reinterpret_cast<float4*>(&sm.pw[tt][cg][kTile * rg]) =
            make_float4(pw[0], pw[1], pw[2], pw[3]);
        *reinterpret_cast<float4*>(&sm.pv[tt][rg][kTile * cg]) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            g[i][j] = fmaf(wi[i], g[i][j], ri[i] * dj[j]);
      }
    }
    __syncthreads();
    // the partials added in a fixed order, with the bonus terms
    const int t0 = c * kSteps;
#pragma unroll
    for (int m2 = 0; m2 < kSteps * N / NT; ++m2) {
      const int q = tid + m2 * NT;
      const int tt = q / N, i = q % N, t = t0 + tt;
      float a = sm.pr[tt][0][i], bk = sm.pk[tt][0][i], bw = sm.pw[tt][0][i];
#pragma unroll
      for (int x = 1; x < CG; ++x) {
        a += sm.pr[tt][x][i];
        bk += sm.pk[tt][x][i];
        bw += sm.pw[tt][x][i];
      }
      const float rr = to_f32(sm.r[s][tt][i]), kk = to_f32(sm.k[s][tt][i]);
      const float d = sm.vdy[tt], uu = sm.u[i];
      if (t < S) {
        const int64_t o = base + static_cast<int64_t>(t) * stride + i;
        out_r[o] = fmaf(uu * kk, d, a);
        out_k[o] = fmaf(uu * rr, d, bk);
        out_w[o] = bw;
      }
      du_acc = fmaf(rr * kk, d, du_acc);        // 0 past S (r, k zero)
    }
#pragma unroll
    for (int m2 = 0; m2 < kSteps * C / NT; ++m2) {
      const int q = tid + m2 * NT;
      const int tt = q / C, j = q % C, t = t0 + tt;
      float a = sm.pv[tt][0][j];
#pragma unroll
      for (int x = 1; x < RG; ++x) a += sm.pv[tt][x][j];
      a = fmaf(sm.at[tt], to_f32(sm.dy[s][tt][j]), a);
      if (t < S)
        dv[base + static_cast<int64_t>(t) * stride + j0 + j] = from_f32<T>(a);
    }
    __syncthreads();                            // slot s and the partials
  }
  // du of the (row, column block): a row's NT / N threads in thread order
  sm.du[tid] = du_acc;
  __syncthreads();
  if (tid < N) {
    float a = sm.du[tid];
    for (int q = tid + N; q < NT; q += N) a += sm.du[q];
    du_part[(static_cast<int64_t>(b) * NCB + cb) * H * N + h * N + tid] = a;
  }
}

// dr, dk, dw: the column blocks' partials added in block order, dr and dk
// rounded once; 4 elements a thread
template <typename T, int NCB>
__global__ void wkv6_bwd_fold(const float* __restrict__ part, int64_t plane,
                              T* __restrict__ dr, T* __restrict__ dk,
                              float* __restrict__ dw) {
  const int64_t n4 = plane / 4;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < n4; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 s[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      s[x] = reinterpret_cast<const float4*>(part + x * NCB * plane)[e];
#pragma unroll
      for (int c = 1; c < NCB; ++c) {
        const float4 p =
            reinterpret_cast<const float4*>(part + (x * NCB + c) * plane)[e];
        s[x].x += p.x;
        s[x].y += p.y;
        s[x].z += p.z;
        s[x].w += p.w;
      }
    }
    reinterpret_cast<float4*>(dw)[e] = s[2];
    T* outs[2] = {dr, dk};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      T* o = outs[x] + 4 * e;
      o[0] = from_f32<T>(s[x].x);
      o[1] = from_f32<T>(s[x].y);
      o[2] = from_f32<T>(s[x].z);
      o[3] = from_f32<T>(s[x].w);
    }
  }
}

// du: the (row, column block) partials added in order
__global__ void wkv6_bwd_du(const float* __restrict__ du_part, int parts,
                            int HN, float* __restrict__ du) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HN) return;
  float a = du_part[i];
  for (int p = 1; p < parts; ++p) a += du_part[static_cast<int64_t>(p) * HN + i];
  du[i] = a;
}

template <int N>
int64_t workspace_floats(int B, int S, int H) {
  using Sh = Shape<N>;
  const int64_t nchunk = (S + kSteps - 1) / kSteps;
  const int64_t plane = static_cast<int64_t>(B) * S * H * N;
  return static_cast<int64_t>(B) * H * nchunk * N * N + 3 * Sh::NCB * plane +
         static_cast<int64_t>(B) * Sh::NCB * H * N;
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, void* dr, void* dk, void* dv,
           void* dw, void* du, float* ws, int64_t ws_floats, int B, int S,
           int H, cudaStream_t stream) {
  using Sh = Shape<N>;
  if (ws_floats < workspace_floats<N>(B, S, H)) return -1;
  constexpr int smem = static_cast<int>(sizeof(Smem<T, N>));
  static const cudaError_t set = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = static_cast<int64_t>(B) * H * Sh::NCB;
  if (blocks > INT_MAX) return -1;
  const int64_t nchunk = (S + kSteps - 1) / kSteps;
  const int64_t plane = static_cast<int64_t>(B) * S * H * N;
  float* states = ws;
  float* part = states + static_cast<int64_t>(B) * H * nchunk * N * N;
  float* du_part = part + 3 * Sh::NCB * plane;
  wkv6_bwd_kernel<T, N><<<static_cast<int>(blocks), Sh::NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const T*>(dy),
      static_cast<T*>(dv), states, part, du_part, B, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n4 = plane / 4;
  const int fold_blocks =
      static_cast<int>(n4 / 256 + 1 < 132 * 16 ? n4 / 256 + 1 : 132 * 16);
  wkv6_bwd_fold<T, Sh::NCB><<<fold_blocks, 256, 0, stream>>>(
      part, plane, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<float*>(dw));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_du<<<(H * N + 255) / 256, 256, 0, stream>>>(
      du_part, B * Sh::NCB, H * N, static_cast<float*>(du));
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
