// Paged-attention decode kernels for Hopper (sm_90a), bound through a plain
// C interface (ctypes) by repro_torch/kernels/paged_attention.py.
//
// Replaces the TPU Pallas kernels of repro/kernels/paged_attention.py:
// `paged_attention` (bodies `_pa_kernel`, `_pa_split_kernel`) and its HBM
// lowering `paged_attention_hbm` (`_pa_hbm_kernel`, `_pa_split_hbm_kernel`,
// `_pa_hbm_loop`).  On the TPU the two lowerings differ only in how a page
// reaches VMEM; here one design serves both.
//
// What it computes: attention of one new token per sequence over that
// sequence's paged context.  q [B,H,D] (bf16 or f32); pools [P,bs,KH,D] bf16;
// block_tables [B,NB] int32 (-1 = unbacked); context_lens [B] int32.  The
// query sits at position ctx-1, so causality holds by construction; an
// optional sliding `window` (<= 0: none) and logit `softcap` (0: none) apply.
// A -1 table entry inside the context is masked (never read as page 0), a row
// with ctx == 0 gives zeros; accumulation is f32, the output is in q's dtype.
//
// Bound: memory.  Every valid K and V row is read once and used for G = H/KH
// query heads (2 flops per byte per head), far below the H100's ~295 flop per
// byte ridge.  The least time is the K+V bytes of the valid context,
// sum_b ctx_b * KH * D * 2 B * 2, over 3.35 TB/s.  So the design fills the
// card with loads in flight and keeps the math off their path:
//
// 1. Chunks over every SM.  Each row's token range [0, NB*bs) is cut into
//    fixed chunks of CT tokens (32, 64 or 128; CT / bs pages when bs divides
//    it, a page may also span chunks).  One block of 4 warps per
//    (chunk, kv_head, batch row): grid (ceil(NB*bs / CT), KH, B), from
//    host-known shapes only, so a launch reads no device value and can be
//    captured in a CUDA graph.  A block whose chunk lies wholly past ctx or
//    wholly before the window's start exits at once and writes nothing.
// 2. cp.async staging.  The block reads its context length and its tokens'
//    table entries together, then issues every 16-byte copy of its live K
//    rows (one commit group) and V rows (a second) into shared memory before
//    any dependent math; scores run on K while V is still landing.  Rows of
//    unbacked pages are not copied: they are zeroed and masked.  Page
//    indices are clamped to the pool (min(raw, P-1)).  K rows are padded so
//    the threads of one token read distinct banks.
// 3. All of the chunk's scores at once: 128 / CT neighbouring threads per
//    token each dot a slice of the row with the G scaled query heads (in
//    shared memory), and one shuffle tree adds the slices; then softcap,
//    mask, the chunk's max and sum of exponents per head (a warp per head),
//    and P.V with each thread owning G x (2 head-dim elements) f32 sums.
//    The chunk writes its partial (m, l, acc) rows in f32.
// 4. The merge kernel, launched right after on the same stream: one block
//    per (head, batch row) folds that row's live chunks, in chunk order,
//    with the log-sum-exp rescale, and writes the output in q's dtype.  It
//    computes the live chunk range from context_lens on the device, the
//    same way the chunk kernel decides to exit, so skipped chunks are never
//    read.  Nothing is summed with atomics: results do not change from run
//    to run.
//
// The reference's `num_splits` (its split-KV grid axis) does not reach this
// file: the chunking is the kernel's own partition, and the function it
// computes is the same for every split count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The row's live tokens [lo, hi): before ctx and inside the table's n_tok
// slots, and at or after ctx - window when a window is set.  The chunk
// kernel and the merge kernel both decide from this.
__device__ __forceinline__ void live_tokens(int ctx, int window, int n_tok,
                                            int& lo, int& hi) {
  hi = min(max(ctx, 0), n_tok);
  lo = window > 0 ? max(ctx - window, 0) : 0;
}

// Dynamic shared memory of one chunk block, in bytes (layout below).
__host__ __device__ inline size_t chunk_smem_bytes(int CT, int D, int G) {
  const int kstride = D * 2 + 16 * (kThreads / CT);
  return (size_t)CT * kstride + (size_t)CT * D * 2 + (size_t)G * D * 4 +
         (size_t)G * CT * 4 + (size_t)CT * 8;
}

// GMAX: compile-time bound on the GQA group (heads g >= G are idle).
template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads)
paged_attention_chunk_kernel(const T* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pages,
                             const __nv_bfloat16* __restrict__ v_pages,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ context_lens,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ acc_out, int H, int KH, int D,
                             int P, int bs, int NB, int G, int CT, float scale,
                             int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x, tid = threadIdx.x;
  const int n_tok = NB * bs, t0 = c * CT;

  // the table entry of this thread's token, read beside the context length
  const int tt = t0 + tid;
  int raw = -1;
  if (tid < CT && tt < n_tok) raw = block_tables[(size_t)b * NB + tt / bs];
  int lo, hi;
  live_tokens(context_lens[b], window, n_tok, lo, hi);
  lo = max(lo, t0);
  hi = min(hi, t0 + CT);
  if (lo >= hi) return;                 // not live: the merge skips it
  const int j_lo = lo - t0, j_hi = hi - t0;

  // layout: K rows (padded) | V rows | q [G][D] f32 | scores/probs [G][CT]
  // | row offsets [CT]
  const int DV = D / 8;                 // 16-byte vectors in a row
  const int TPT = kThreads / CT;        // threads per token when scoring
  const int kstride = D * 2 + 16 * TPT;
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + (size_t)CT * kstride;
  float* qs = reinterpret_cast<float*>(Vs + (size_t)CT * D * 2);
  float* ps = qs + G * D;
  long long* rowoff = reinterpret_cast<long long*>(ps + G * CT);

  if (tid < CT) {
    long long off = -1;                 // -1: outside [lo, hi) or unbacked
    if (tid >= j_lo && tid < j_hi && raw >= 0) {
      const int page = min(raw, P - 1);
      off = (((long long)page * bs + tt % bs) * KH + kh) * D;
    }
    rowoff[tid] = off;
  }
  __syncthreads();

  // every copy of the chunk, K then V, before any math
  const int n_copy = (j_hi - j_lo) * DV;
  for (int i = tid; i < n_copy; i += kThreads) {
    const int j = j_lo + i / DV, v = i % DV;
    const long long off = rowoff[j];
    unsigned char* dst = Ks + (size_t)j * kstride + v * 16;
    if (off >= 0) cp_async16(dst, k_pages + off + v * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  for (int i = tid; i < n_copy; i += kThreads) {
    const int j = j_lo + i / DV, v = i % DV;
    const long long off = rowoff[j];
    unsigned char* dst = Vs + ((size_t)j * DV + v) * 16;
    if (off >= 0) cp_async16(dst, v_pages + off + v * 8);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  // the group's G query heads are contiguous in q
  const T* qrow = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_float(qrow[i]) * scale;
  cp_async_wait<1>();                   // this thread's K copies landed
  __syncthreads();

  // scores: TPT neighbouring threads per token, each a strided slice of the
  // row's 16-byte vectors, added by one shuffle tree
  {
    const int j = tid / TPT, part = tid % TPT;
    const bool in_range = j >= j_lo && j < j_hi;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (in_range) {
      const unsigned char* krow = Ks + (size_t)j * kstride;
      for (int v = part; v < DV; v += TPT) {
        const uint4 kraw = *reinterpret_cast<const uint4*>(krow + v * 16);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kraw);
        float kf[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(k2[i]);
          kf[2 * i] = f.x;
          kf[2 * i + 1] = f.y;
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          const float4 a = *reinterpret_cast<const float4*>(qs + g * D + v * 8);
          const float4 e = *reinterpret_cast<const float4*>(qs + g * D + v * 8 + 4);
          float acc = s[g];
          acc = fmaf(a.x, kf[0], acc);
          acc = fmaf(a.y, kf[1], acc);
          acc = fmaf(a.z, kf[2], acc);
          acc = fmaf(a.w, kf[3], acc);
          acc = fmaf(e.x, kf[4], acc);
          acc = fmaf(e.y, kf[5], acc);
          acc = fmaf(e.z, kf[6], acc);
          acc = fmaf(e.w, kf[7], acc);
          s[g] = acc;
        }
      }
    }
    for (int off = TPT >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
    if (part == 0) {
      const bool ok = in_range && rowoff[j] >= 0;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float x = s[g];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ps[g * CT + j] = ok ? x : kNegInf;
      }
    }
  }
  __syncthreads();

  // the chunk's max and sum of exponents, a warp per head; ps becomes P
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < G; g += kThreads / 32) {
    float* row = ps + g * CT;
    float m = kNegInf;
    for (int j = lane; j < CT; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < CT; j += 32) {
      const float p = row[j] > 0.5f * kNegInf ? expf(row[j] - m) : 0.f;
      row[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t idx = ((size_t)b * H + (size_t)kh * G + g) * NC + c;
      m_out[idx] = m;
      l_out[idx] = l;
    }
  }
  cp_async_wait<0>();                   // this thread's V copies landed
  __syncthreads();

  // P.V: a thread owns a pair of head-dim elements for every head of the
  // group and walks the chunk's live tokens in order
  const int D2 = D / 2;
  const __nv_bfloat162* V2 = reinterpret_cast<const __nv_bfloat162*>(Vs);
  for (int dp = tid; dp < D2; dp += kThreads) {
    float a0[GMAX], a1[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) { a0[g] = 0.f; a1[g] = 0.f; }
    for (int j = j_lo; j < j_hi; ++j) {
      const float2 vv = __bfloat1622float2(V2[(size_t)j * D2 + dp]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float p = ps[g * CT + j];
        a0[g] = fmaf(p, vv.x, a0[g]);
        a1[g] = fmaf(p, vv.y, a1[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      const size_t row = ((size_t)b * H + (size_t)kh * G + g) * NC + c;
      reinterpret_cast<float2*>(acc_out + row * D)[dp] = make_float2(a0[g], a1[g]);
    }
  }
}

// One block per (head, batch row): fold the row's live chunk partials in
// chunk order (log-sum-exp rescale) into the output, in q's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const int* __restrict__ context_lens,
                             const float* __restrict__ m_in,
                             const float* __restrict__ l_in,
                             const float* __restrict__ acc_in,
                             T* __restrict__ out, int H, int D, int n_tok,
                             int CT, int NC, int window) {
  const int h = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  live_tokens(context_lens[b], window, n_tok, lo, hi);
  int c_lo = 0, c_hi = 0;
  if (lo < hi) {
    c_lo = lo / CT;
    c_hi = (hi + CT - 1) / CT;
  }
  const size_t row = (size_t)b * H + h;
  const float* m = m_in + row * NC;
  const float* l = l_in + row * NC;
  float m_star = kNegInf;
  for (int c = c_lo; c < c_hi; ++c) m_star = fmaxf(m_star, m[c]);
  float l_star = 0.f;
  for (int c = c_lo; c < c_hi; ++c) l_star += l[c] * expf(m[c] - m_star);
  const float denom = fmaxf(l_star, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int c = c_lo; c < c_hi; ++c)
      a += acc_in[(row * NC + c) * D + d] * expf(m[c] - m_star);
    out[row * D + d] = from_float<T>(a / denom);
  }
}

template <typename T, int GMAX>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* ctx, void* out, float* m, float* l, float* acc, int B,
           int H, int KH, int D, int P, int bs, int NB, int CT, float scale,
           int window, float softcap, cudaStream_t stream) {
  const int G = H / KH;
  const int NC = (NB * bs + CT - 1) / CT;
  const size_t smem = chunk_smem_bytes(CT, D, G);
  auto kern = paged_attention_chunk_kernel<T, GMAX>;
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory must be allowed, once
    // per device (an unset attribute refuses the launch)
    static size_t allowed[kMaxDevices] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || allowed[dev] < smem) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) allowed[dev] = smem;
    }
  }
  if (NC > 0) {
    kern<<<dim3(NC, KH, B), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), bt, ctx, m, l, acc, H, KH, D,
        P, bs, NB, G, CT, scale, window, softcap);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_merge_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(
      ctx, m, l, acc, static_cast<T*>(out), H, D, NB * bs, CT, NC, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_g(int gmax, const void* q, const void* kp, const void* vp,
               const int* bt, const int* ctx, void* out, float* m, float* l,
               float* acc, int B, int H, int KH, int D, int P, int bs, int NB,
               int CT, float scale, int window, float softcap,
               cudaStream_t s) {
#define PA_LAUNCH(N)                                                         \
  return launch<T, N>(q, kp, vp, bt, ctx, out, m, l, acc, B, H, KH, D, P, bs, \
                      NB, CT, scale, window, softcap, s)
  switch (gmax) {
    case 1: PA_LAUNCH(1);
    case 2: PA_LAUNCH(2);
    case 4: PA_LAUNCH(4);
    case 8: PA_LAUNCH(8);
    default: return -1;
  }
#undef PA_LAUNCH
}

}  // namespace

// Returns 0 on success, -1 for a shape the kernels do not take, else the
// cudaError_t of a launch.  `q_bf16` selects the q/out dtype (1: bf16,
// 0: f32); `gmax` is the template bound the wrapper picked for the GQA group;
// `chunk` the tokens of a chunk (32, 64 or 128).  `m`, `l` [B,H,NC] and `acc`
// [B,H,NC,D] are f32 scratch, NC = ceil(NB*bs / chunk).
extern "C" int paged_attention_launch(
    const void* q, int q_bf16, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* context_lens, void* out, float* m,
    float* l, float* acc, int B, int H, int KH, int D, int P, int bs, int NB,
    int gmax, int chunk, float scale, int window, float softcap,
    void* stream) {
  if (B <= 0 || KH <= 0 || H % KH || D <= 0 || D > 256 || D % 8 || bs <= 0 ||
      NB < 0 || P < 0 || (chunk != 32 && chunk != 64 && chunk != 128))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16
      ? dispatch_g<__nv_bfloat16>(gmax, q, k_pages, v_pages, block_tables,
                                  context_lens, out, m, l, acc, B, H, KH, D, P,
                                  bs, NB, chunk, scale, window, softcap, s)
      : dispatch_g<float>(gmax, q, k_pages, v_pages, block_tables,
                          context_lens, out, m, l, acc, B, H, KH, D, P, bs, NB,
                          chunk, scale, window, softcap, s);
}
