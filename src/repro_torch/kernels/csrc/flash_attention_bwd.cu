// Flash-attention backward for Hopper (sm_90a) on the CUDA cores, bf16 or
// f32 in and out with f32 sums, bound through a plain C interface (ctypes)
// by repro_torch/kernels/flash_attention.py (`flash_attention_bwd`, the
// backward of `FlashAttentionFn`).
//
// Replaces the gradient of the TPU Pallas kernel `flash_attention` of
// repro/kernels/flash_attention.py:80, which JAX derives from the kernel's
// body under jax.grad; the port has no such derivation, so the backward is
// a kernel of its own.
//
// What it computes, as ref.flash_attention_bwd_plain: from q, out, d_out
// [B,Sq,H,D] and k, v [B,Skv,KH,D] (one dtype), dq [B,Sq,H,D] and dk, dv
// [B,Skv,KH,D] of the forward of csrc/flash_attention_mma.cu and
// csrc/flash_attention.cu: query row i at position i, key j at position j,
// the mask keeping j < Skv, j <= i (causal) and i - j < window (window >
// 0); the score S = scale q.k, capped to cap * tanh(S / cap) when softcap
// > 0; query head h reads KV head h / (H/KH).  With L the row log-sum-exp
// and D_i = dO_i . O_i:
//   P = exp(S - L) (0 where masked), dP = dO V^T, dS = P (dP - D),
//   times 1 - (S / cap)^2 with a softcap (the capped score's chain rule),
//   dV = P^T dO, dQ = scale dS K, dK = scale dS^T Q,
// dK and dV summed over each GQA group's query heads.
//
// Design (simple and deterministic first; speed is later work):
// - Two kernels on the caller's stream, no atomics, so every run gives
//   the same bits.  `fa_bwd_dq`: one block per (query tile of 32 rows,
//   query head, batch row).  Pass 1 streams the KV tiles the mask allows
//   and keeps each row's running max and sum, giving L; D_i comes from dO
//   and O; both go to an f32 scratch [B,H,Sq] each.  Pass 2 streams the
//   tiles again, rebuilds P from L, forms dS and accumulates dQ in
//   registers.  `fa_bwd_dkdv`: one block per (key tile of 32 keys, KV
//   head, batch row); it holds its K and V tiles, loops over the G query
//   heads of its group and over the query tiles the mask allows, rebuilds
//   P from Q, K and the scratch's L, and accumulates dV += P^T dO and
//   dK += dS^T Q in registers.
// - 256 threads a block, 8 to a tile row: in the score tile each thread
//   takes 4 entries of one row (columns lane8 + 8 i) and sums the two dot
//   products of each over D in f32 FFMA; the 8 threads of a row reduce
//   their max and sum through __shfl_xor_sync.  In the accumulation each
//   thread owns columns lane8 + 8 j of one output row (NJ = ceil(D / 8)
//   f32 registers; 32 at D = 256, 64 for dK and dV together).
// - Tiles are staged in shared memory as f32 (bf16 converted on load),
//   rows padded to D + 1 words so the 8 rows a warp reads fall in
//   distinct banks: 4 tiles of 32 x (D + 1), the two 32 x 33 score tiles
//   and L, D of the query tile; 140,288 bytes at D = 256, so the launcher
//   opts in above 48 KB (cudaFuncSetAttribute) and returns its error.
//
// Bound: the 5 products of 2 D operations a kept (query, key) pair and
// query head (S, dP, dV, dQ, dK) at the type's peak, against q, k, v, o,
// dO read once and dq, dk, dv written once.  This design computes S and
// dP twice (once in each kernel), re-reads every operand from shared
// memory for each FFMA (about 1.25 shared loads a FFMA) and skips no
// masked entry inside a kept tile; the tensor-core redesign (mma on bf16
// tiles, as csrc/flash_attention_mma.cu) is queued in ROADMAP.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;                  // query rows a tile
constexpr int kBK = 32;                  // keys a tile
constexpr int kThreads = 256;            // 8 threads a tile row
constexpr int kEnt = kBK / 8;            // score entries a thread (= kBQ / 8)
constexpr int kLdS = kBQ + 1;            // row stride of the score tiles

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;      // [B, H, Sq]
  float* delta;    // [B, H, Sq]
  int B, Sq, Skv, H, KH, D;
  float scale, softcap, inv_cap;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + n) of head `head` of a [B, S, NH, D] tensor into an
// f32 tile of row stride D + 1; rows past S read as zero
template <typename T>
__device__ void load_tile(float* dst, const T* src, int b, int row0, int n,
                          int S, int NH, int head, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int s = row0 + r;
    float x = 0.f;
    if (s < S) x = to_f32(src[(((size_t)b * S + s) * NH + head) * D + c]);
    dst[r * ld + c] = x;
  }
}

__device__ __forceinline__ bool kept(int qp, int kp, const Args& a) {
  return qp < a.Sq && kp < a.Skv && (!a.causal || kp <= qp) &&
         (a.window <= 0 || qp - kp < a.window);
}

// the score of one kept pair from its raw dot product, and the chain-rule
// factor of the softcap (1 without one)
__device__ __forceinline__ float score(float dot, const Args& a,
                                       float* dcap) {
  const float s = dot * a.scale;
  if (a.softcap > 0.f) {
    const float t = tanhf(s * a.inv_cap);
    *dcap = 1.f - t * t;
    return a.softcap * t;
  }
  *dcap = 1.f;
  return s;
}

// sums over the 8 threads of a tile row (consecutive lanes)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return x;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* sQ = smem;
  float* sdO = sQ + kBQ * ld;
  float* sK = sdO + kBQ * ld;
  float* sV = sK + kBK * ld;
  float* sS = sV + kBK * ld;               // dS [kBQ][kLdS]
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int r = threadIdx.x >> 3, lane8 = threadIdx.x & 7;
  const int qp = q0 + r;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* O = static_cast<const T*>(a.o);
  const T* dO = static_cast<const T*>(a.dout);

  load_tile(sQ, Q, b, q0, kBQ, a.Sq, a.H, h, D);
  load_tile(sdO, dO, b, q0, kBQ, a.Sq, a.H, h, D);
  __syncthreads();
  // D_i = dO_i . O_i
  float di = 0.f;
  if (qp < a.Sq) {
    const T* orow = O + (((size_t)b * a.Sq + qp) * a.H + h) * D;
    for (int d = lane8; d < D; d += 8) di += sdO[r * ld + d] * to_f32(orow[d]);
  }
  di = row_sum(di);

  // the KV tiles holding a key the mask keeps for some row of the tile
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(q_last, a.Skv - 1) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;
  const int t0 = k_lo / kBK, t1 = k_hi < k_lo ? t0 - 1 : k_hi / kBK;
  const float* qrow = sQ + r * ld;
  const float* grow = sdO + r * ld;

  // pass 1: the row log-sum-exp
  float m = -INFINITY, l = 0.f;
  for (int t = t0; t <= t1; ++t) {
    __syncthreads();
    load_tile(sK, K, b, t * kBK, kBK, a.Skv, a.KH, kh, D);
    __syncthreads();
    float s[kEnt];
#pragma unroll
    for (int i = 0; i < kEnt; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = qrow[d];
#pragma unroll
      for (int i = 0; i < kEnt; ++i) s[i] += x * sK[(lane8 + 8 * i) * ld + d];
    }
    float tm = -INFINITY;
#pragma unroll
    for (int i = 0; i < kEnt; ++i) {
      float dcap;
      s[i] = kept(qp, t * kBK + lane8 + 8 * i, a) ? score(s[i], a, &dcap)
                                                 : -INFINITY;
      tm = fmaxf(tm, s[i]);
    }
    const float mn = fmaxf(m, row_max(tm));
    float ps = 0.f;
    if (mn > -INFINITY) {
#pragma unroll
      for (int i = 0; i < kEnt; ++i)
        ps += s[i] > -INFINITY ? expf(s[i] - mn) : 0.f;
    }
    ps = row_sum(ps);
    if (mn > -INFINITY) {
      l = l * expf(m - mn) + ps;
      m = mn;
    }
  }
  // a row with no kept key has P = 0 everywhere: L = +inf gives exp(S - L) = 0
  const float L = l > 0.f ? m + logf(l) : INFINITY;
  if (lane8 == 0 && qp < a.Sq) {
    const size_t at = ((size_t)b * a.H + h) * a.Sq + qp;
    a.lse[at] = L;
    a.delta[at] = di;
  }

  // pass 2: dQ
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  for (int t = t0; t <= t1; ++t) {
    __syncthreads();
    load_tile(sK, K, b, t * kBK, kBK, a.Skv, a.KH, kh, D);
    load_tile(sV, V, b, t * kBK, kBK, a.Skv, a.KH, kh, D);
    __syncthreads();
    float s[kEnt], p[kEnt];
#pragma unroll
    for (int i = 0; i < kEnt; ++i) s[i] = p[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = qrow[d], g = grow[d];
#pragma unroll
      for (int i = 0; i < kEnt; ++i) {
        const int at = (lane8 + 8 * i) * ld + d;
        s[i] += x * sK[at];
        p[i] += g * sV[at];
      }
    }
#pragma unroll
    for (int i = 0; i < kEnt; ++i) {
      const int c = lane8 + 8 * i;
      float ds = 0.f;
      if (kept(qp, t * kBK + c, a)) {
        float dcap;
        const float sc = score(s[i], a, &dcap);
        ds = expf(sc - L) * (p[i] - di) * dcap;
      }
      sS[r * kLdS + c] = ds;
    }
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      const float w = sS[r * kLdS + c];
      const float* krow = sK + c * ld;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane8 + 8 * j;
        if (d < D) acc[j] += w * krow[d];
      }
    }
  }
  if (qp < a.Sq) {
    T* out = static_cast<T*>(a.dq) + (((size_t)b * a.Sq + qp) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane8 + 8 * j;
      if (d < D) out[d] = from_f32<T>(acc[j] * a.scale);
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* sK = smem;
  float* sV = sK + kBK * ld;
  float* sQ = sV + kBK * ld;
  float* sdO = sQ + kBQ * ld;
  float* sP = sdO + kBQ * ld;              // P  [kBK][kLdS]
  float* sS = sP + kBK * kLdS;             // dS [kBK][kLdS]
  float* sL = sS + kBK * kLdS;             // L, D of the query tile
  float* sD = sL + kBQ;
  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  const int c = threadIdx.x >> 3, lane8 = threadIdx.x & 7;
  const int kp = k0 + c;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* dO = static_cast<const T*>(a.dout);

  load_tile(sK, K, b, k0, kBK, a.Skv, a.KH, kh, D);
  load_tile(sV, V, b, k0, kBK, a.Skv, a.KH, kh, D);
  // the query tiles holding a row the mask lets see some key of the tile
  const int k_last = min(k0 + kBK, a.Skv) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi =
      a.window > 0 ? min(k_last + a.window - 1, a.Sq - 1) : a.Sq - 1;
  const int t0 = q_lo / kBQ, t1 = q_hi < q_lo ? t0 - 1 : q_hi / kBQ;
  const float* krow = sK + c * ld;
  const float* vrow = sV + c * ld;

  float dk[NJ], dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk[j] = dv[j] = 0.f;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int t = t0; t <= t1; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();
      load_tile(sQ, Q, b, q0, kBQ, a.Sq, a.H, h, D);
      load_tile(sdO, dO, b, q0, kBQ, a.Sq, a.H, h, D);
      if (threadIdx.x < kBQ) {
        const int qp = q0 + threadIdx.x;
        const size_t at = ((size_t)b * a.H + h) * a.Sq + qp;
        sL[threadIdx.x] = qp < a.Sq ? a.lse[at] : INFINITY;
        sD[threadIdx.x] = qp < a.Sq ? a.delta[at] : 0.f;
      }
      __syncthreads();
      float s[kEnt], p[kEnt];
#pragma unroll
      for (int i = 0; i < kEnt; ++i) s[i] = p[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float x = krow[d], y = vrow[d];
#pragma unroll
        for (int i = 0; i < kEnt; ++i) {
          const int at = (lane8 + 8 * i) * ld + d;
          s[i] += x * sQ[at];
          p[i] += y * sdO[at];
        }
      }
#pragma unroll
      for (int i = 0; i < kEnt; ++i) {
        const int r = lane8 + 8 * i;
        float pr = 0.f, ds = 0.f;
        if (kept(q0 + r, kp, a)) {
          float dcap;
          const float sc = score(s[i], a, &dcap);
          pr = expf(sc - sL[r]);
          ds = pr * (p[i] - sD[r]) * dcap;
        }
        sP[c * kLdS + r] = pr;
        sS[c * kLdS + r] = ds;
      }
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        const float pr = sP[c * kLdS + r], ds = sS[c * kLdS + r];
        const float* qr = sQ + r * ld;
        const float* gr = sdO + r * ld;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane8 + 8 * j;
          if (d < D) {
            dv[j] += pr * gr[d];
            dk[j] += ds * qr[d];
          }
        }
      }
    }
  }
  if (kp < a.Skv) {
    const size_t at = (((size_t)b * a.Skv + kp) * a.KH + kh) * D;
    T* ok = static_cast<T*>(a.dk) + at;
    T* ov = static_cast<T*>(a.dv) + at;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane8 + 8 * j;
      if (d < D) {
        ok[d] = from_f32<T>(dk[j] * a.scale);
        ov[d] = from_f32<T>(dv[j]);
      }
    }
  }
}

// dynamic shared memory of either kernel (the larger, dkdv's): four
// 32-row f32 tiles of D + 1 words, the two score tiles, L and D
size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)(2 * kBQ + 2 * kBK) * (D + 1) + 2 * kBK * kLdS + 2 * kBQ);
}

template <typename T, int NJ>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_dkdv<T, NJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dq<T, NJ><<<dim3((a.Sq + kBQ - 1) / kBQ, a.H, a.B), kThreads, smem,
                     stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkdv<T, NJ><<<dim3((a.Skv + kBK - 1) / kBK, a.KH, a.B), kThreads,
                       smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, 2>(a, stream);
  if (a.D <= 32) return launch<T, 4>(a, stream);
  if (a.D <= 64) return launch<T, 8>(a, stream);
  if (a.D <= 128) return launch<T, 16>(a, stream);
  return launch<T, 32>(a, stream);
}

}  // namespace

// dq, dk, dv (the inputs' type) and the f32 scratch `lse_delta` (2 x
// [B, H, Sq]: L, then D) are the caller's; returns 0, -1 for arguments the
// kernels do not take, else the CUDA error of the attribute or a launch
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse_delta,
    int is_bf16, int B, int Sq, int Skv, int H, int KH, int D, float scale,
    int causal, int window, float softcap, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH ||
      H > 65535 || D <= 0 || D > 256 || softcap < 0.f)
    return -1;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = static_cast<float*>(lse_delta);
  a.delta = a.lse + (size_t)B * H * Sq;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KH = KH;
  a.D = D;
  a.scale = scale;
  a.softcap = softcap;
  a.inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dim<__nv_bfloat16>(a, s) : launch_dim<float>(a, s);
}
