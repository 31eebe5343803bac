// Paged-attention decode kernel for Hopper (sm_90a), bound through a plain
// C interface (ctypes) by repro_torch/kernels/paged_attention.py.
//
// Replaces the TPU Pallas kernels of repro/kernels/paged_attention.py:
// `paged_attention` (bodies `_pa_kernel`, `_pa_split_kernel`) and its HBM
// lowering `paged_attention_hbm` (`_pa_hbm_kernel`, `_pa_split_hbm_kernel`,
// `_pa_hbm_loop`).  On the TPU the two lowerings differ only in how a page
// reaches VMEM; here pages stay in device memory and are read straight into
// registers, so one kernel serves both.
//
// What it computes: attention of one new token per sequence over that
// sequence's paged context.  q [B,H,D] (bf16 or f32); pools [P,bs,KH,D] bf16;
// block_tables [B,NB] int32 (-1 = unbacked); context_lens [B] int32.  The
// query sits at position ctx-1, so causality holds by construction; an
// optional sliding `window` (<= 0: none) and logit `softcap` (0: none) apply.
// A -1 table entry inside the context is masked (never read as page 0), a row
// with ctx == 0 gives zeros, and an empty split writes the identity partial
// (m = NEG_INF, l = 0, acc = 0).  num_splits == 1 writes the normalised
// output in q's dtype; num_splits > 1 writes f32 partial rows (m, l, acc)
// that the wrapper merges with the log-sum-exp rescale.
//
// Bound: memory.  Every valid K and V row is read once and used for G = H/KH
// query heads (2 flops per byte per head), far below the H100's ~295 flop per
// byte ridge.  The least time is the K+V bytes of the valid context,
// sum_b ctx_b * KH * D * 2 B * 2, over 3.35 TB/s.
//
// Design (simple and correct first): one block of NW warps per
// (split, kv_head, batch row).  The block serves the whole GQA group of query
// heads, so each K/V row is read once per KV head, not once per query head.
// Warps stride over the split's tokens; a lane holds DPL consecutive elements
// of the head dimension (one 16-byte load per row at D = 256) and each warp
// keeps its own online-softmax state (m, l, acc) in registers.  Masked tokens
// (outside the window, or in unbacked pages) are skipped, not read.  At the
// end the warps' states are merged through shared memory in a fixed order,
// so results do not change from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kWarps = 4;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DPL consecutive bf16 values -> f32, with the widest aligned loads
// (DPL * 2 bytes; the wrapper checks the pools are 16-byte aligned and
// D % DPL == 0, so every row offset is DPL-aligned).
template <int DPL>
__device__ __forceinline__ void load_bf16_row(const __nv_bfloat16* p,
                                              float (&out)[DPL]) {
  if constexpr (DPL >= 8) {
#pragma unroll
    for (int c = 0; c < DPL / 8; ++c) {
      uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(h[i]);
        out[c * 8 + 2 * i] = f.x;
        out[c * 8 + 2 * i + 1] = f.y;
      }
    }
  } else if constexpr (DPL == 4) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (DPL == 2) {
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// GMAX: compile-time bound on the GQA group (heads g >= G are idle);
// DPL: head-dim elements per lane (lanes with lane*DPL >= D are idle).
template <typename T, int GMAX, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pages,
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ acc_out,
                       int H, int KH, int D, int P, int bs, int NB, int G,
                       float scale, int window, float softcap, int num_splits) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool lane_on = lane * DPL < D;

  // this split's [lo, hi) slice of the row's valid pages, as in the TPU
  // kernel's _split_bounds; then the token range the slice must read
  const int ctx = max(context_lens[b], 0);
  const int n_valid = min((ctx + bs - 1) / bs, NB);
  const int pps = (n_valid + num_splits - 1) / num_splits;
  const int lo = split * pps;
  const int hi = min(lo + pps, n_valid);
  int t0 = lo * bs;
  const int t1 = min(hi * bs, ctx);
  if (window > 0) t0 = max(t0, ctx - window);

  float qv[GMAX][DPL];
  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[g][i] = 0.f;
      qv[g][i] = 0.f;
      if (g < G && lane_on)
        qv[g][i] = to_float(q[((size_t)b * H + kh * G + g) * D + lane * DPL + i]) * scale;
    }
  }

  const int* bt_row = block_tables + (size_t)b * NB;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int raw = bt_row[t / bs];
    if (raw < 0) continue;                       // unbacked page: masked
    const int page = min(raw, P - 1);
    const size_t row = ((size_t)page * bs + t % bs) * KH + kh;
    float kf[DPL], vf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) { kf[i] = 0.f; vf[i] = 0.f; }
    if (lane_on) {
      load_bf16_row<DPL>(k_pages + row * D + lane * DPL, kf);
      load_bf16_row<DPL>(v_pages + row * D + lane * DPL, vf);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s = fmaf(qv[g][i], kf[i], s);
      s = warp_sum(s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(acc[g][i], alpha, p * vf[i]);
      m[g] = m_new;
    }
  }

  // merge the warps' partial states, one head at a time, in warp order
  __shared__ float sm_m[kWarps][GMAX];
  __shared__ float sm_l[kWarps][GMAX];
  __shared__ float sm_acc[kWarps][32 * DPL];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    float m_star = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_star = fmaxf(m_star, sm_m[w][g]);
    float l_star = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l_star += sm_l[w][g] * expf(sm_m[w][g] - m_star);
    const float mine = expf(m[g] - m_star);
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = acc[g][i] * mine;
    __syncthreads();
    const int h = kh * G + g;
    for (int d = threadIdx.x; d < D; d += kWarps * 32) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d];
      if (num_splits == 1) {
        out[((size_t)b * H + h) * D + d] = from_float<T>(a / fmaxf(l_star, 1e-30f));
      } else {
        acc_out[(((size_t)b * H + h) * num_splits + split) * D + d] = a;
      }
    }
    if (num_splits > 1 && threadIdx.x == 0) {
      m_out[((size_t)b * H + h) * num_splits + split] = m_star;
      l_out[((size_t)b * H + h) * num_splits + split] = l_star;
    }
    __syncthreads();
  }
}

template <typename T, int GMAX, int DPL>
void launch(const void* q, const void* kp, const void* vp, const int* bt,
            const int* ctx, void* out, float* m_out, float* l_out,
            float* acc_out, int B, int H, int KH, int D, int P, int bs, int NB,
            float scale, int window, float softcap, int num_splits,
            cudaStream_t stream) {
  dim3 grid(num_splits, KH, B);
  paged_attention_kernel<T, GMAX, DPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), bt, ctx, static_cast<T*>(out),
      m_out, l_out, acc_out, H, KH, D, P, bs, NB, H / KH, scale, window,
      softcap, num_splits);
}

template <typename T, int GMAX>
int dispatch_dpl(int dpl, const void* q, const void* kp, const void* vp,
                 const int* bt, const int* ctx, void* out, float* m_out,
                 float* l_out, float* acc_out, int B, int H, int KH, int D,
                 int P, int bs, int NB, float scale, int window, float softcap,
                 int num_splits, cudaStream_t stream) {
#define PA_LAUNCH(N)                                                          \
  launch<T, GMAX, N>(q, kp, vp, bt, ctx, out, m_out, l_out, acc_out, B, H,   \
                     KH, D, P, bs, NB, scale, window, softcap, num_splits,    \
                     stream)
  switch (dpl) {
    case 1: PA_LAUNCH(1); break;
    case 2: PA_LAUNCH(2); break;
    case 4: PA_LAUNCH(4); break;
    case 8: PA_LAUNCH(8); break;
    default: return -1;
  }
#undef PA_LAUNCH
  return 0;
}

template <typename T>
int dispatch_g(int gmax, int dpl, const void* q, const void* kp,
               const void* vp, const int* bt, const int* ctx, void* out,
               float* m_out, float* l_out, float* acc_out, int B, int H,
               int KH, int D, int P, int bs, int NB, float scale, int window,
               float softcap, int num_splits, cudaStream_t stream) {
  switch (gmax) {
    case 1: return dispatch_dpl<T, 1>(dpl, q, kp, vp, bt, ctx, out, m_out, l_out, acc_out, B, H, KH, D, P, bs, NB, scale, window, softcap, num_splits, stream);
    case 2: return dispatch_dpl<T, 2>(dpl, q, kp, vp, bt, ctx, out, m_out, l_out, acc_out, B, H, KH, D, P, bs, NB, scale, window, softcap, num_splits, stream);
    case 4: return dispatch_dpl<T, 4>(dpl, q, kp, vp, bt, ctx, out, m_out, l_out, acc_out, B, H, KH, D, P, bs, NB, scale, window, softcap, num_splits, stream);
    case 8: return dispatch_dpl<T, 8>(dpl, q, kp, vp, bt, ctx, out, m_out, l_out, acc_out, B, H, KH, D, P, bs, NB, scale, window, softcap, num_splits, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of the launch.  `q_bf16` selects the q/out dtype (1: bf16,
// 0: f32).  `gmax` and `dpl` are the template bounds the wrapper picked.
extern "C" int paged_attention_launch(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* context_lens, void* out, float* m_out,
    float* l_out, float* acc_out, int B, int H, int KH, int D, int P, int bs,
    int NB, int gmax, int dpl, float scale, int window, float softcap,
    int num_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = q_bf16
      ? dispatch_g<__nv_bfloat16>(gmax, dpl, q, k_pages, v_pages, block_tables,
                                  context_lens, out, m_out, l_out, acc_out, B,
                                  H, KH, D, P, bs, NB, scale, window, softcap,
                                  num_splits, s)
      : dispatch_g<float>(gmax, dpl, q, k_pages, v_pages, block_tables,
                          context_lens, out, m_out, l_out, acc_out, B, H, KH,
                          D, P, bs, NB, scale, window, softcap, num_splits, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
