// Blocked flash-attention forward on the CUDA cores for Hopper (sm_90a),
// bound through a plain C interface (ctypes) by
// repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU Pallas kernel `flash_attention` of
// repro/kernels/flash_attention.py:80 (body `_fa_kernel`) on every route
// the tensor-core kernel (csrc/flash_attention_mma.cu) does not take: f32
// inputs, the bf16 accumulator, and bf16 at D % 16 == 8.
//
// What it computes, as ref.flash_attention_plain: q [B,Sq,H,D], k/v
// [B,Skv,KH,D] (all bf16, or all f32) -> out [B,Sq,H,D] in q's dtype.
// Query row i sits at position i and key j at position j (causal is
// top-left aligned).  Scores are (q * scale) . k in f32; an optional logit
// softcap cap * tanhf(s / cap) applies before the mask; the mask drops keys
// past Skv, keys above the diagonal (causal) and keys with q_pos - k_pos >=
// window (window > 0).  Online softmax over KV tiles; out = acc / max(l,
// 1e-30).  Query head h reads KV head h / (H/KH).  Every product and sum is
// an f32 FFMA or FADD on the CUDA cores: the tensor cores would round f32
// to tf32, and the reduced f32 reference must give the CPU's tokens.  With
// bf16_acc, m, l and acc are rounded to bf16 after every KV tile of `lk`
// keys exactly where the Pallas kernel rounds them.
//
// Bound: at the f32 prefill shape (B=1, Sq=Skv=900, H=8, KH=4, D=256,
// causal) the work is 4*D*H*(valid pairs) = 3.3 GFLOP, 49.6 us at 67
// TFLOP/s (f32 outside the tensor cores), against 22 MB of Q/K/V/O, 6.6 us
// at 3.35 TB/s: bound by operations.  A 64-row x 64-key tile step is 2 x
// 64 x 64 x D FFMA, 8.3 us on one SM at D=256.  The parent kernel lost
// that rate to shared-memory issue (scalar loads, 2 FFMA a word), load
// imbalance under the causal mask (116 blocks, the longest walking 2.2x
// the balanced share) and copies that did not overlap the products.
// What bounds this design (tools/flash_attention_design.py, PERF.md): the
// shared-memory loads that feed the FFMA.  Within 16 warps an SM and 128
// registers a thread both products run at 2.67 FFMA a 32-bit word a
// thread (one LDS.128 takes 4 cycles of the SM's shared-memory pipe, so 4
// FFMA a word break even); a tile step takes about 23,500 cycles in the
// scores and 17,000 in P V, against 12,300 each for their loads alone.
// Probes that change the loads' addresses or drop the copies move the
// time by 4% or less; a quarter of the score FFMA saves 13-17%.  The
// design:
//
// - One block of 16 warps (512 threads) an SM for 64 query rows of one KV
//   head: the GQA group's G heads x BQ = 64 / G positions, so a K/V tile
//   is read once for the group.  Q, scaled in f32, stays in shared memory
//   for the block's life, row-major with a 4-float pad.
// - Register-blocked products with 16-byte shared loads.  S = Q K^T: a
//   thread owns a 4-row x 8-key micro-tile over a quarter of the head dim
//   (16-byte chunks c = ds, ds + 4, ...); per chunk it reads 4 Q and 8 K
//   float4 (12 LDS.128) for 128 FFMA, one chunk a loop trip (unrolled,
//   the hoisted loads spill registers).  A K slab row is 80 floats, so
//   the 8 lanes of a quarter-warp (2 key groups x 4 quarters) read 8
//   bank-disjoint chunks (at 72, two lanes shared a bank group: 11-13%
//   slower).  Two xor shuffles (reduce-scatter) sum the quarters and
//   leave a thread 2 rows x 4 keys.  O += P V: a thread owns 4 rows x 4
//   NC columns; per key it reads one P float4 (P is stored key-major) and
//   NC V float4 for 16 NC FFMA.  No branch sits between the loads and
//   their FFMA (a column chunk past D reads the row's last chunk into
//   accumulators that are never stored): a branch around each V load
//   kept the compiler from issuing a key's loads ahead (11-14% slower).
// - The softmax in registers: the tile's row max and row sum over the 8
//   lanes that share a row take xor shuffles, and the two warps that share
//   a row meet through one float each in shared memory (two barriers a
//   tile).  P goes to shared memory once, key-major, for the P V product.
// - A cp.async ring of kStages slots carries, per tile, K in slabs of 64
//   keys x 64 head-dim columns and V in slabs of 16 keys x D, in the
//   dtype of the inputs (bf16 is widened on read), zero-filled past Skv:
//   slab n + 3 lands while slab n computes; one barrier a slab both
//   publishes the slab that landed and frees the slot it refills.  The
//   slab waits take under 1% of a tile step.
// - The causal triangle over every SM (f32 accumulator only): each query
//   tile's KV range (the tiles that hold a key the mask keeps for one of
//   its rows) is cut into ns = ceil(n / T) items of at most T tiles;
//   `T`, the item count and the grid are functions of the shapes alone
//   (the wrapper's `work_split`, which the launcher checks), so a call
//   reads no device value and can be captured in a CUDA graph.  The grid
//   walks query tiles last-first, the longest under a causal mask.  A
//   tile with one item writes the output; otherwise each item writes its
//   (m, l, acc) in f32 to the wrapper's workspace and a merge kernel on
//   the same stream folds them in item order: weights exp(m_s - m*), so an
//   item whose keys are all masked for a row (m_s = -2e38) weighs exactly
//   0, and a row with no valid key at all folds its items with weight 1,
//   as one unsplit walk would.  The bf16 accumulator rounds after every
//   tile in order from the first, so it is never split.
// - The row log-sum-exp L for the backward (csrc/flash_attention_bwd.cu),
//   into an optional f32 `lse` [B,H,Sq]: m + log l of an unsplit tile's
//   rows, the merge kernel's folded m* + log(sum w l) of a split one, +inf
//   for a row with no kept key.  With the bf16 accumulator l is rounded
//   after every tile, so an f32 sum of the same exponentials, never
//   rounded, is kept beside it for L.  O is the same bits with and
//   without the buffer.
//
// The launcher returns -1 for a shape it does not take, else the
// cudaError_t of the shared-memory attribute or of the launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 512;     // 16 warps, one block an SM
constexpr int kRows = 64;         // query rows a block: G heads x BQ positions
constexpr int kSub = 64;          // keys of one score sub-tile
constexpr int kSlabD = 64;        // head-dim columns of a K slab
constexpr int kSlabV = 16;        // keys of a V slab
constexpr int kStages = 4;        // slots of the cp.async ring
constexpr int kLdK = kSlabD + 16; // a K slab row, in elements
constexpr int kLdP = kRows + 4;   // a P row (one key, every query row), f32
constexpr int kMaxSub = 4;        // bf16 accumulator tiles up to 256 keys
constexpr int kMergeThreads = 256;
constexpr int kMaxDevices = 16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* ws;   // split partials: m, l [items][kRows]; acc [items][kRows][D]
  float* lse;  // the rows' log-sum-exp [B, H, Sq], or null
  int B, Sq, Skv, H, KH, D;
  int BQ, LK, nsub;   // positions a block, keys a KV tile, sub-tiles a tile
  int nq, nt, T, smax;
  float scale;
  int causal, window;
  float softcap;
};

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

// four elements of a shared-memory slab as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the KV tiles [lo, hi) that hold a key the mask keeps for a row of query
// tile i (a mirror of the wrapper's `tile_range`)
__host__ __device__ __forceinline__ void tile_range(const Params& p, int i,
                                                    int& lo, int& hi) {
  const int q0 = i * p.BQ;
  const int q_last = (q0 + p.BQ < p.Sq ? q0 + p.BQ : p.Sq) - 1;
  hi = p.causal ? (q_last / p.LK + 1 < p.nt ? q_last / p.LK + 1 : p.nt)
                : p.nt;
  lo = p.window > 0 ? (q0 - p.window + 1 > 0 ? q0 - p.window + 1 : 0) / p.LK
                    : 0;
  if (hi < lo) hi = lo;
}

__host__ __device__ __forceinline__ int n_items(int n, int T) {
  const int ns = (n + T - 1) / T;
  return ns > 1 ? ns : 1;
}

// elements of one ring slot: a K slab or a V slab, whichever is larger
template <typename T>
__host__ __device__ __forceinline__ int slot_elems(int D) {
  const int v = kSlabV * (D + 16 / (int)sizeof(T));
  return kSub * kLdK > v ? kSub * kLdK : v;
}

template <typename T>
size_t smem_bytes(int D, int nsub) {
  return sizeof(float) * (size_t)kRows * (D + 4) +
         sizeof(T) * (size_t)kStages * slot_elems<T>(D) +
         sizeof(float) * ((size_t)nsub * kSub * kLdP + 7 * kRows);
}

// one K slab's share of a thread's score micro-tile: rows 4 srg + j (qs),
// keys kg + 8 ii (kt), 16-byte head-dim chunks c = ds + 4 t below nch;
// FULL (nch == 16) drops the guard, so no branch splits the loads.  One
// chunk a trip: unrolled, the loads hoisted ahead spill registers
template <bool FULL, typename T>
__device__ __forceinline__ void score_slab(const float* qs, int ldq,
                                           const T* kt, int kg, int ds,
                                           int nch, float (&sacc)[4][8]) {
#pragma unroll 1
  for (int t = 0; t < kSlabD / 16; ++t) {
    const int c = ds + 4 * t;
    if (FULL || c < nch) {
      float4 qa[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) qa[j] = ld4(qs + j * ldq + 4 * c);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const float4 kb = ld4(kt + (kg + 8 * ii) * kLdK + 4 * c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sacc[j][ii];
          a = fmaf(qa[j].x, kb.x, a);
          a = fmaf(qa[j].y, kb.y, a);
          a = fmaf(qa[j].z, kb.z, a);
          sacc[j][ii] = fmaf(qa[j].w, kb.w, a);
        }
      }
    }
  }
}

// NC: 16-byte column chunks of O a thread owns (D <= 128 NC); BF16ACC:
// round m, l and acc to bf16 after every KV tile
template <typename T, int NC, bool BF16ACC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int ldq = D + 4;
  const int ldv = D + 16 / (int)sizeof(T);
  const int slot = slot_elems<T>(D);
  float* sQ = reinterpret_cast<float*>(smem_raw);     // [kRows][ldq]
  T* ring = reinterpret_cast<T*>(sQ + kRows * ldq);   // kStages slots
  float* sP = reinterpret_cast<float*>(ring + kStages * slot);  // [keys][kLdP]
  float* sRedMax = sP + p.nsub * kSub * kLdP;         // [2][kRows]
  float* sRedSum = sRedMax + 2 * kRows;               // [2][kRows]
  float* sAlpha = sRedSum + 2 * kRows;                // [kRows]
  float* sL = sAlpha + kRows;                         // [kRows]
  float* sM = sL + kRows;                             // [kRows]

  // the work item: longest-first query tile i, KV head kh, batch row b,
  // item s of the query tile's ns
  long long x = blockIdx.x;
  const int s = (int)(x % p.smax);
  x /= p.smax;
  const int kh = (int)(x % p.KH);
  x /= p.KH;
  const int b = (int)(x % p.B);
  const int i = p.nq - 1 - (int)(x / p.B);
  int lo, hi;
  tile_range(p, i, lo, hi);
  const int n = hi - lo, ns = n_items(n, p.T);
  if (s >= ns) return;
  const int jb = lo + (int)((long long)s * n / ns);
  const int je = lo + (int)((long long)(s + 1) * n / ns);

  const int G = p.H / p.KH, R = G * p.BQ, q0 = i * p.BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // score layout: rows 4 srg + j, keys kg + 8 i, head-dim quarter ds
  const int ds = lane & 3, ds0 = ds & 1, ds1 = ds >> 1;
  const int kg = (warp & 1) * 4 + ((lane >> 2) & 3);
  const int srg = (warp >> 1) * 2 + (lane >> 4);
  // after the reduce-scatter: rows 4 srg + 2 ds0 + jj, keys kg + 8 (4 ds1 + ii)
  const int srow = 4 * srg + 2 * ds0;
  const bool row_writer = (lane & 0xE) == 0;   // one lane of the 8 a row
  int qpos[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) qpos[jj] = q0 + (srow + jj) % p.BQ;
  // P @ V layout: rows 4 prg + j, columns 4 (cg + 32 u)
  const int cg = (warp & 3) * 8 + (lane & 7);
  const int prg = (warp >> 2) * 4 + ((lane >> 3) & 3);
  // a column chunk past D reads the row's last chunk instead: its FFMAs
  // land in accumulators that are never stored, and no branch splits the
  // P V loads
  bool colok[NC];
  int vcol[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    colok[u] = 4 * (cg + 32 * u) < D;
    vcol[u] = colok[u] ? 4 * (cg + 32 * u) : D - 4;
  }

  const T* qg = static_cast<const T*>(p.q);
  const T* kgl = static_cast<const T*>(p.k);
  const T* vgl = static_cast<const T*>(p.v);

  // the ring: per tile, nsub x nks K slabs, then nvs V slabs
  const int nks = (D + kSlabD - 1) / kSlabD;
  const int nvs = (p.LK + kSlabV - 1) / kSlabV;
  const int per_tile = p.nsub * nks + nvs;
  const int total = (je - jb) * per_tile;
  constexpr int VEC = 16 / sizeof(T);
  auto issue = [&](int m) {
    if (m < total) {
      const int t = m / per_tile, r = m % per_tile;
      const int k0 = (jb + t) * p.LK;
      T* dst = ring + (m % kStages) * slot;
      if (r < p.nsub * nks) {
        const int st = r / nks, d0 = (r % nks) * kSlabD;
        const int dw = min(kSlabD, D - d0) / VEC;     // chunks a key
        for (int idx = tid; idx < kSub * dw; idx += kThreads) {
          const int key = idx / dw, c = (idx - key * dw) * VEC;
          const int kt = st * kSub + key, kp = k0 + kt;
          const bool ok = kt < p.LK && kp < p.Skv;
          const T* src =
              ok ? kgl + (((size_t)b * p.Skv + kp) * p.KH + kh) * D + d0 + c
                 : kgl;
          cp_async16(dst + key * kLdK + c, src, ok);
        }
      } else {
        const int v0 = (r - p.nsub * nks) * kSlabV;
        const int dw = D / VEC;
        for (int idx = tid; idx < kSlabV * dw; idx += kThreads) {
          const int key = idx / dw, c = (idx - key * dw) * VEC;
          const int kt = v0 + key, kp = k0 + kt;
          const bool ok = kt < p.LK && kp < p.Skv;
          const T* src =
              ok ? vgl + (((size_t)b * p.Skv + kp) * p.KH + kh) * D + c : vgl;
          cp_async16(dst + key * ldv + c, src, ok);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int m = 0; m < kStages - 1; ++m) issue(m);

  {  // the Q tile, scaled in f32 as the Pallas kernel scales it
    const int dv = D / VEC;
    for (int idx = tid; idx < kRows * dv; idx += kThreads) {
      const int r = idx / dv, c = (idx - r * dv) * VEC;
      float f[VEC];
      const int g = r / p.BQ, qp = q0 + r % p.BQ;
      if (r < R && qp < p.Sq) {
        load16(qg + (((size_t)b * p.Sq + qp) * p.H + kh * G + g) * D + c, f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        store4(sQ + r * ldq + c + e,
               make_float4(f[e] * p.scale, f[e + 1] * p.scale,
                           f[e + 2] * p.scale, f[e + 3] * p.scale));
    }
  }

  int cur = 0;   // the slab the block computes next
  // wait for slab `cur`, free the slot of slab cur - 1, refill it
  auto next = [&]() -> const T* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(cur + kStages - 1);
    return ring + (cur++ % kStages) * slot;
  };

  float m_run[2], l_run[2];              // score layout rows
  float l32[2];                          // l unrounded (bf16 acc, for L)
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    m_run[jj] = acc_round<BF16ACC>(kNegInf);
    l_run[jj] = l32[jj] = 0.f;
  }
  float acc[4][4 * NC];                  // P @ V layout
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[j][c] = 0.f;

#pragma unroll 1
  for (int jt = jb; jt < je; ++jt) {
    const int k0 = jt * p.LK;
    float tmax[2] = {kNegInf, kNegInf};
    // 1. masked scores of the tile, kSub keys at a time, into sP
#pragma unroll 1
    for (int st = 0; st < p.nsub; ++st) {
      float sacc[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c) sacc[j][c] = 0.f;
#pragma unroll 1
      for (int sl = 0; sl < nks; ++sl) {
        const T* kt = next();
        const int d0 = sl * kSlabD;
        const int nch = min(kSlabD, D - d0) / 4;
        const float* qs = sQ + (4 * srg) * ldq + d0;
        if (nch == kSlabD / 4)
          score_slab<true>(qs, ldq, kt, kg, ds, nch, sacc);
        else
          score_slab<false>(qs, ldq, kt, kg, ds, nch, sacc);
      }
      // sum the four head-dim quarters: rows by ds0, then keys by ds1
      float h[2][8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const float send = ds0 ? sacc[jj][ii] : sacc[2 + jj][ii];
          const float keep = ds0 ? sacc[2 + jj][ii] : sacc[jj][ii];
          h[jj][ii] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
        }
      float sc[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float send = ds1 ? h[jj][ii] : h[jj][4 + ii];
          const float keep = ds1 ? h[jj][4 + ii] : h[jj][ii];
          sc[jj][ii] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int kt = st * kSub + kg + 8 * (4 * ds1 + ii);   // key in tile
        const int kp = k0 + kt;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float sv = sc[jj][ii];
          if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);
          bool ok = kp < p.Skv;
          if (p.causal) ok = ok && kp <= qpos[jj];
          if (p.window > 0) ok = ok && qpos[jj] - kp < p.window;
          sv = ok ? sv : kNegInf;
          if (kt < p.LK) tmax[jj] = fmaxf(tmax[jj], sv);
          sc[jj][ii] = sv;
        }
        *reinterpret_cast<float2*>(&sP[kt * kLdP + srow]) =
            make_float2(sc[0][ii], sc[1][ii]);
      }
    }
    // 2. the online-softmax step: the tile's row max over the 8 lanes and
    // the 2 warps that share a row
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float mx = tmax[jj];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      if (row_writer) sRedMax[(warp & 1) * kRows + srow + jj] = mx;
    }
    __syncthreads();
    float alpha[2], psum[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float mx = fmaxf(sRedMax[srow + jj], sRedMax[kRows + srow + jj]);
      const float m_new = fmaxf(m_run[jj], acc_round<BF16ACC>(mx));
      alpha[jj] = acc_round<BF16ACC>(
          expf(acc_round<BF16ACC>(m_run[jj] - m_new)));
      if constexpr (BF16ACC) l32[jj] *= expf(m_run[jj] - m_new);
      m_run[jj] = m_new;
      psum[jj] = 0.f;
    }
#pragma unroll 1
    for (int st = 0; st < p.nsub; ++st) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int kt = st * kSub + kg + 8 * (4 * ds1 + ii);
        float2* pp = reinterpret_cast<float2*>(&sP[kt * kLdP + srow]);
        const float2 sv = *pp;
        const bool in_tile = kt < p.LK;
        const float p0 = in_tile ? expf(sv.x - m_run[0]) : 0.f;
        const float p1 = in_tile ? expf(sv.y - m_run[1]) : 0.f;
        psum[0] += p0;
        psum[1] += p1;
        *pp = make_float2(p0, p1);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float sm = psum[jj];
      sm += __shfl_xor_sync(0xffffffffu, sm, 2);
      sm += __shfl_xor_sync(0xffffffffu, sm, 4);
      sm += __shfl_xor_sync(0xffffffffu, sm, 8);
      if (row_writer) {
        sRedSum[(warp & 1) * kRows + srow + jj] = sm;
        if ((warp & 1) == 0) sAlpha[srow + jj] = alpha[jj];
      }
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float sm = sRedSum[srow + jj] + sRedSum[kRows + srow + jj];
      l_run[jj] = acc_round<BF16ACC>(acc_round<BF16ACC>(l_run[jj] * alpha[jj]) +
                                     acc_round<BF16ACC>(sm));
      if constexpr (BF16ACC) l32[jj] += sm;
    }
    // 3. acc = acc * alpha + P @ V, V in slabs of kSlabV keys
    const float4 a4 = *reinterpret_cast<const float4*>(&sAlpha[4 * prg]);
    const float al[4] = {a4.x, a4.y, a4.z, a4.w};
    float pv[4][4 * NC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) {
        if constexpr (BF16ACC) {
          pv[j][c] = 0.f;
        } else {
          acc[j][c] *= al[j];
        }
      }
#pragma unroll 1
    for (int vs = 0; vs < nvs; ++vs) {
      const T* vt = next();
      const float* ps = sP + vs * kSlabV * kLdP + 4 * prg;
#pragma unroll
      for (int kk = 0; kk < kSlabV; ++kk) {
        const float4 pr = *reinterpret_cast<const float4*>(ps + kk * kLdP);
        const float pa[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float4 vv = ld4(vt + kk * ldv + vcol[u]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (BF16ACC) {
              pv[j][4 * u] = fmaf(pa[j], vv.x, pv[j][4 * u]);
              pv[j][4 * u + 1] = fmaf(pa[j], vv.y, pv[j][4 * u + 1]);
              pv[j][4 * u + 2] = fmaf(pa[j], vv.z, pv[j][4 * u + 2]);
              pv[j][4 * u + 3] = fmaf(pa[j], vv.w, pv[j][4 * u + 3]);
            } else {
              acc[j][4 * u] = fmaf(pa[j], vv.x, acc[j][4 * u]);
              acc[j][4 * u + 1] = fmaf(pa[j], vv.y, acc[j][4 * u + 1]);
              acc[j][4 * u + 2] = fmaf(pa[j], vv.z, acc[j][4 * u + 2]);
              acc[j][4 * u + 3] = fmaf(pa[j], vv.w, acc[j][4 * u + 3]);
            }
          }
        }
      }
    }
    if constexpr (BF16ACC) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c)
          acc[j][c] = bf16_round(bf16_round(acc[j][c] * al[j]) +
                                 bf16_round(pv[j][c]));
    }
  }

  // the rows' (m, l) to shared memory, for the P @ V layout; an unsplit
  // tile's L
  if (row_writer && (warp & 1) == 0) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      sL[srow + jj] = l_run[jj];
      sM[srow + jj] = m_run[jj];
      const int r = srow + jj, qp = q0 + r % p.BQ;
      if (p.lse && ns == 1 && r < R && qp < p.Sq) {
        const float l = BF16ACC ? l32[jj] : l_run[jj];
        p.lse[((size_t)b * p.H + kh * G + r / p.BQ) * p.Sq + qp] =
            m_run[jj] > acc_round<BF16ACC>(kNegInf) && l > 0.f
                ? m_run[jj] + logf(l)
                : INFINITY;
      }
    }
  }
  __syncthreads();
  if (ns > 1) {   // a partial: (m, l, acc) of this item, in f32
    const size_t items = (size_t)p.B * p.KH * p.nq * p.smax;
    const size_t it = blockIdx.x;
    float* wm = p.ws + it * kRows;
    float* wl = p.ws + (items + it) * kRows;
    float* wacc = p.ws + 2 * items * kRows + it * kRows * (size_t)D;
    if (tid < kRows) {
      wm[tid] = sM[tid];
      wl[tid] = sL[tid];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 4 * prg + j;
#pragma unroll
      for (int u = 0; u < NC; ++u)
        if (colok[u])
          store4(wacc + (size_t)row * D + 4 * (cg + 32 * u),
                 make_float4(acc[j][4 * u], acc[j][4 * u + 1],
                             acc[j][4 * u + 2], acc[j][4 * u + 3]));
    }
    return;
  }
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = 4 * prg + j;
    const int g = row / p.BQ, qp = q0 + row % p.BQ;
    if (row >= R || qp >= p.Sq) continue;
    const float l = fmaxf(sL[row], 1e-30f);
    T* o = og + (((size_t)b * p.Sq + qp) * p.H + kh * G + g) * D;
#pragma unroll
    for (int u = 0; u < NC; ++u)
      if (colok[u])
        store4(o + 4 * (cg + 32 * u),
               make_float4(acc[j][4 * u] / l, acc[j][4 * u + 1] / l,
                           acc[j][4 * u + 2] / l, acc[j][4 * u + 3] / l));
  }
}

// One block a (query tile, KV head, batch row) whose KV range was split:
// fold its items' partials in item order (log-sum-exp rescale) into the
// output, in q's dtype.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_attention_merge_kernel(const Params p) {
  long long x = blockIdx.x;
  const int kh = (int)(x % p.KH);
  x /= p.KH;
  const int b = (int)(x % p.B);
  const int i = (int)(x / p.B);
  int lo, hi;
  tile_range(p, i, lo, hi);
  const int ns = n_items(hi - lo, p.T);
  if (ns <= 1) return;
  const int D = p.D, G = p.H / p.KH, R = G * p.BQ, q0 = i * p.BQ;
  const size_t items = (size_t)p.B * p.KH * p.nq * p.smax;
  const size_t it0 =
      ((((size_t)(p.nq - 1 - i) * p.B + b) * p.KH) + kh) * p.smax;
  const float* wm = p.ws;
  const float* wl = p.ws + items * kRows;
  const float* wacc = p.ws + 2 * items * kRows;
  T* og = static_cast<T*>(p.out);
  const int dv = D / 4;
  for (int idx = threadIdx.x; idx < R * dv; idx += kMergeThreads) {
    const int r = idx / dv, c = (idx - r * dv) * 4;
    const int g = r / p.BQ, qp = q0 + r % p.BQ;
    if (qp >= p.Sq) continue;
    float m_star = kNegInf;
    for (int s = 0; s < ns; ++s)
      m_star = fmaxf(m_star, wm[(it0 + s) * kRows + r]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < ns; ++s) {
      const size_t row = (it0 + s) * kRows + r;
      const float w = expf(wm[row] - m_star);
      l = fmaf(wl[row], w, l);
      const float4 v = *reinterpret_cast<const float4*>(wacc + row * D + c);
      a.x = fmaf(v.x, w, a.x);
      a.y = fmaf(v.y, w, a.y);
      a.z = fmaf(v.z, w, a.z);
      a.w = fmaf(v.w, w, a.w);
    }
    if (p.lse && c == 0)
      p.lse[((size_t)b * p.H + kh * G + g) * p.Sq + qp] =
          m_star > kNegInf && l > 0.f ? m_star + logf(l) : INFINITY;
    l = fmaxf(l, 1e-30f);
    store4(og + (((size_t)b * p.Sq + qp) * p.H + kh * G + g) * D + c,
           make_float4(a.x / l, a.y / l, a.z / l, a.w / l));
  }
}

template <typename T, int NC, bool BF16ACC>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NC, BF16ACC>;
  const size_t smem = smem_bytes<T>(p.D, p.nsub);
  // above 48 KB a block's dynamic shared memory must be allowed, once per
  // device and size (an unset attribute refuses the launch)
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
  const long long blocks = (long long)p.B * p.KH * p.nq * p.smax;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.smax == 1) return static_cast<int>(e);
  flash_attention_merge_kernel<T>
      <<<(unsigned)((long long)p.B * p.KH * p.nq), kMergeThreads, 0,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int nc, int bf16_acc, const Params& p, cudaStream_t s) {
  if (nc == 1) return bf16_acc ? launch<T, 1, true>(p, s)
                               : launch<T, 1, false>(p, s);
  if (nc == 2) return bf16_acc ? launch<T, 2, true>(p, s)
                               : launch<T, 2, false>(p, s);
  return -1;
}

}  // namespace

// Returns 0 on success, -1 for a shape or a split the kernel does not take,
// else the cudaError_t of the shared-memory attribute or of a launch.
// `is_bf16` selects the dtype of q/k/v/out (1: bf16, 0: f32); `nc` the
// 16-byte column chunks of O a thread owns (D <= 128 nc); `bq` the query
// positions a block (G * bq <= 64); `lk` the KV tile (64 with an f32
// accumulator, block_k with bf16_acc, at most 256); `T` the most KV tiles
// a work item walks and `smax` the most items of one query tile: the
// wrapper's `work_split`, which this launcher recomputes and refuses if
// they differ.  `ws` holds B * KH * ceil(Sq / bq) * smax * 64 * (D + 2)
// floats where smax > 1.  `lse`, f32 [B, H, Sq] or null, takes the rows'
// log-sum-exp.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* ws,
    float* lse,
    int is_bf16, int B, int Sq, int Skv, int H, int KH, int D, int nc, int bq,
    int lk, int T, int smax, int bf16_acc, float scale, int causal,
    int window, float softcap, void* stream) {
  if (KH <= 0 || H % KH || bq <= 0 || (H / KH) * bq > kRows || lk <= 0 ||
      lk > kMaxSub * kSub || (!bf16_acc && lk != kSub) || D <= 0 ||
      D > 128 * nc || D % 8 || Sq <= 0 || Skv <= 0 || B <= 0 || T <= 0)
    return -1;
  const int nq = (Sq + bq - 1) / bq;
  const int nsub = (lk + kSub - 1) / kSub, nt = (Skv + lk - 1) / lk;
  Params p{q, k, v, out, ws, lse, B, Sq, Skv, H, KH, D, bq, lk, nsub, nq,
           nt, T, smax, scale, causal, window, softcap};
  int most = 1;
  for (int i = 0; i < nq; ++i) {
    int lo, hi;
    tile_range(p, i, lo, hi);
    const int ns = n_items(hi - lo, T);
    most = ns > most ? ns : most;
  }
  if (most != smax || (bf16_acc && smax != 1) || (smax > 1 && !ws) ||
      (long long)B * KH * nq * smax > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(nc, bf16_acc, p, s)
                 : dispatch<float>(nc, bf16_acc, p, s);
}
