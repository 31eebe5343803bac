// Blocked flash-attention forward kernel for Hopper (sm_90a), bound through
// a plain C interface (ctypes) by repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU Pallas kernel `flash_attention` of
// repro/kernels/flash_attention.py:80 (body `_fa_kernel`).
//
// What it computes: q [B,Sq,H,D], k/v [B,Skv,KH,D] (all bf16, or all f32)
// -> out [B,Sq,H,D] in q's dtype.  Query row i sits at position i and key
// j at position j (causal is top-left aligned).  Scores are (q * scale) . k
// in f32; an optional logit softcap cap * tanh(s / cap) applies before the
// mask; the mask drops keys past Skv, keys above the diagonal (causal) and
// keys with q_pos - k_pos >= window (window > 0).  Online softmax over KV
// tiles; out = acc / max(l, 1e-30).  Query head h reads KV head h / (H/KH).
// The running (m, l, acc) live in f32, or, with bf16_acc, are rounded to
// bf16 after every KV tile of `lk` keys exactly where the Pallas kernel
// rounds them (so the kernel matches the plain version's arithmetic).
//
// Bound: at the serving prefill shape (B=1, Sq=Skv=900, H=8, KH=4, D=256,
// causal) the work is 4*D*H*(valid pairs) = 3.3 GFLOP, 3.4 us at 989
// TFLOP/s (bf16 tensor cores), against 11 MB of Q/K/V/O, 3.3 us at
// 3.35 TB/s: both bounds are a few microseconds, so a kernel on the CUDA
// cores (67 TFLOP/s f32) is compute-bound far above them.  This first
// kernel is simple and right; wgmma tiles, TMA loads and a pipeline are
// later work.
//
// Design: one block of 256 threads per (query tile, KV head, batch row).
// The block serves the whole GQA group: its 64 query rows are G = H/KH
// heads x BQ = 64/G positions, so each K/V tile is read from device memory
// once per group, not once per head.  Q (pre-scaled, f32) stays in shared
// memory; K and V stream through one shared buffer of 64 keys, converted to
// f32.  Per KV tile of `lk` keys: the scores of all its keys go to shared
// memory (64 keys at a time), one warp per row takes the online-softmax
// step, then P @ V accumulates in registers (4 rows x NC columns a thread).
// KV tiles that lie wholly above the diagonal (causal) or wholly below the
// window of the tile's first query are skipped: a fully masked tile's
// contribution is wiped by alpha = 0 as soon as a valid key arrives, and
// with causal masking every row (Sq <= Skv) has at least its own key.
// Head dims above 48 KB of shared memory need the dynamic-shared-memory
// attribute; the launcher sets it and returns its error when a tile does
// not fit in 227 KB (a refused launch never runs, and a later synchronize
// would not report it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows per block: G heads x BQ positions
constexpr int kSub = 64;    // keys per shared-memory K/V sub-tile

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the accumulator dtype's rounding: identity for f32
template <bool BF16ACC>
__device__ __forceinline__ float acc_round(float x) {
  if constexpr (BF16ACC) return bf16_round(x);
  return x;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + n) of one KV head of `src` [B,Skv,KH,D] into
// dst[kSub][ld] as f32; rows past n or past Skv are zero
template <typename T>
__device__ __forceinline__ void load_kv(const T* __restrict__ src, float* dst,
                                        int ld, int b, int row0, int n,
                                        int Skv, int KH, int kh, int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int dv = D / VEC;
  for (int idx = threadIdx.x; idx < kSub * dv; idx += kThreads) {
    const int r = idx / dv, c = (idx % dv) * VEC;
    const int row = row0 + r;
    float f[VEC];
    if (r < n && row < Skv) {
      load16(src + (((size_t)b * Skv + row) * KH + kh) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * ld + c + e] = f[e];
  }
}

// NC: head-dim columns a thread owns (D <= 16 * NC); BF16ACC: round m, l
// and acc to bf16 after every KV tile
template <typename T, int NC, bool BF16ACC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int KH, int D, int BQ, int LK,
                       float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  const int ld = D + 1;          // padded rows: no bank conflicts on columns
  const int lds = LK + 1;
  float* sQ = smem;              // [kRows][ld]
  float* sKV = sQ + kRows * ld;  // [kSub][ld]
  float* sS = sKV + kSub * ld;   // [kRows][lds] scores, then probabilities
  float* sM = sS + kRows * lds;  // [kRows] running max
  float* sL = sM + kRows;        // [kRows] running sum
  float* sA = sL + kRows;        // [kRows] this tile's rescale alpha

  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int R = G * BQ;          // live rows; row r = g * BQ + i
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;

  {  // Q tile, scaled in f32 as the Pallas kernel scales it
    constexpr int VEC = 16 / sizeof(T);
    const int dv = D / VEC;
    for (int idx = tid; idx < kRows * dv; idx += kThreads) {
      const int r = idx / dv, c = (idx % dv) * VEC;
      const int g = r / BQ, qp = q0 + r % BQ;
      float f[VEC];
      if (r < R && qp < Sq) {
        load16(q + (((size_t)b * Sq + qp) * H + kh * G + g) * D + c, f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sQ[r * ld + c + e] = f[e] * scale;
    }
  }
  if (tid < kRows) {
    sM[tid] = acc_round<BF16ACC>(kNegInf);
    sL[tid] = 0.f;
  }

  // the KV tiles this query tile needs
  const int n_tiles = (Skv + LK - 1) / LK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int j_hi = causal ? min(n_tiles, q_last / LK + 1) : n_tiles;
  const int j_lo = window > 0 ? max(0, q0 - window + 1) / LK : 0;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * LK;
    // 1. masked scores of the tile's keys, kSub keys at a time
    for (int s0 = 0; s0 < LK; s0 += kSub) {
      const int n = min(kSub, LK - s0);
      __syncthreads();                 // readers of sKV / sS are done
      load_kv(k, sKV, ld, b, k0 + s0, n, Skv, KH, kh, D);
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kb[c] = sKV[(tx + 16 * c) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qa[i], kb[c], sc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qp = q0 + r % BQ;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = tx + 16 * c;
          if (key >= n) continue;
          const int kp = k0 + s0 + key;
          float s = sc[i][c];
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && (qp - kp) < window;
          sS[r * lds + s0 + key] = ok ? s : kNegInf;
        }
      }
    }
    __syncthreads();
    // 2. the online-softmax step, one warp per row
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < LK; c += 32) mx = fmaxf(mx, sS[r * lds + c]);
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, acc_round<BF16ACC>(mx));
      float sum = 0.f;
      for (int c = lane; c < LK; c += 32) {
        const float p = expf(sS[r * lds + c] - m_new);
        sS[r * lds + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = acc_round<BF16ACC>(
            expf(acc_round<BF16ACC>(m_old - m_new)));
        sL[r] = acc_round<BF16ACC>(acc_round<BF16ACC>(sL[r] * alpha) +
                                   acc_round<BF16ACC>(sum));
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + P @ V
    float pv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if constexpr (BF16ACC) {
          pv[i][c] = 0.f;
        } else {
          acc[i][c] *= a;
        }
      }
    }
    for (int s0 = 0; s0 < LK; s0 += kSub) {
      const int n = min(kSub, LK - s0);
      __syncthreads();
      load_kv(v, sKV, ld, b, k0 + s0, n, Skv, KH, kh, D);
      __syncthreads();
      for (int key = 0; key < n; ++key) {
        float pa[4], vb[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = sS[(ty + 16 * i) * lds + s0 + key];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx + 16 * c;
          vb[c] = col < D ? sKV[key * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if constexpr (BF16ACC) {
              pv[i][c] = fmaf(pa[i], vb[c], pv[i][c]);
            } else {
              acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
            }
          }
      }
    }
    if constexpr (BF16ACC) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = sA[ty + 16 * i];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] = bf16_round(bf16_round(acc[i][c] * a) +
                                 bf16_round(pv[i][c]));
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int g = r / BQ, qp = q0 + r % BQ;
    if (r >= R || qp >= Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* o = out + (((size_t)b * Sq + qp) * H + kh * G + g) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(o + col, acc[i][c] / l);
    }
  }
}

size_t smem_bytes(int D, int LK) {
  return sizeof(float) * ((size_t)(kRows + kSub) * (D + 1) +
                          (size_t)kRows * (LK + 1) + 3 * kRows);
}

template <typename T, int NC, bool BF16ACC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KH, int D, int BQ, int LK, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NC, BF16ACC>;
  const size_t smem = smem_bytes(D, LK);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, KH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KH, D, BQ,
      LK, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BF16ACC>
int dispatch_nc(int nc, const void* q, const void* k, const void* v,
                void* out, int B, int Sq, int Skv, int H, int KH, int D,
                int BQ, int LK, float scale, int causal, int window,
                float softcap, cudaStream_t s) {
#define FA_LAUNCH(N)                                                        \
  return launch<T, N, BF16ACC>(q, k, v, out, B, Sq, Skv, H, KH, D, BQ, LK,  \
                               scale, causal, window, softcap, s)
  switch (nc) {
    case 1: FA_LAUNCH(1);
    case 2: FA_LAUNCH(2);
    case 4: FA_LAUNCH(4);
    case 8: FA_LAUNCH(8);
    case 16: FA_LAUNCH(16);
    default: return -1;
  }
#undef FA_LAUNCH
}

}  // namespace

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of setting the shared-memory attribute or of the launch.
// `is_bf16` selects the dtype of q/k/v/out (1: bf16, 0: f32); `nc` is the
// head-dim columns per thread (D <= 16 * nc), `bq` the query positions per
// block (G * bq <= 64), `lk` the KV tile; the wrapper picks all three.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int B, int Sq, int Skv, int H, int KH,
                                      int D, int nc, int bq, int lk,
                                      int bf16_acc, float scale, int causal,
                                      int window, float softcap,
                                      void* stream) {
  if (KH <= 0 || H % KH || (H / KH) * bq > kRows || bq <= 0 || lk <= 0 ||
      D > 16 * nc || D % 8 || Sq <= 0 || Skv <= 0 || B <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return bf16_acc
        ? dispatch_nc<__nv_bfloat16, true>(nc, q, k, v, out, B, Sq, Skv, H,
                                           KH, D, bq, lk, scale, causal,
                                           window, softcap, s)
        : dispatch_nc<__nv_bfloat16, false>(nc, q, k, v, out, B, Sq, Skv, H,
                                            KH, D, bq, lk, scale, causal,
                                            window, softcap, s);
  }
  return bf16_acc
      ? dispatch_nc<float, true>(nc, q, k, v, out, B, Sq, Skv, H, KH, D, bq,
                                 lk, scale, causal, window, softcap, s)
      : dispatch_nc<float, false>(nc, q, k, v, out, B, Sq, Skv, H, KH, D, bq,
                                  lk, scale, causal, window, softcap, s);
}
