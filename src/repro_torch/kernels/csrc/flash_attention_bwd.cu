// Flash-attention backward for Hopper (sm_90a) on the CUDA cores, bf16 or
// f32 in and out with f32 sums, bound through a plain C interface (ctypes)
// by repro_torch/kernels/flash_attention.py (`flash_attention_bwd`, the
// backward of `FlashAttentionFn`).
//
// Replaces the gradient of the TPU Pallas kernel `flash_attention` of
// repro/kernels/flash_attention.py:80, which JAX derives from the kernel's
// body under jax.grad, on every route the tensor-core backward
// (csrc/flash_attention_bwd_mma.cu) does not take: f32 inputs, the bf16
// accumulator and bf16 at D % 16 == 8.  f32 stays full f32: the tensor
// cores would round it to tf32, and the reduced f32 model trained on the
// card must give the CPU's losses.
//
// What it computes, as ref.flash_attention_bwd_plain with L given: from q,
// out, d_out [B,Sq,H,D], k, v [B,Skv,KH,D] (one dtype) and the forward's
// row log-sum-exp lse [B,H,Sq] (f32, +inf for a row with no kept key;
// csrc/flash_attention.cu writes it beside O), dq [B,Sq,H,D] and dk, dv
// [B,Skv,KH,D]: query row i at position i, key j at position j, the mask
// keeping j < Skv, j <= i (causal) and i - j < window (window > 0); the
// score S = scale q.k, capped to cap * tanh(S / cap) when softcap > 0;
// query head h reads KV head h / (H/KH).  With D_i = dO_i . O_i:
//   P = exp(S - L) (0 where masked), dP = dO V^T, dS = P (dP - D),
//   times 1 - (S / cap)^2 with a softcap (the capped score's chain rule),
//   dV = P^T dO, dQ = scale dS K, dK = scale dS^T Q,
// dK and dV summed over each GQA group's query heads.  Every product and
// sum is an f32 FFMA or FADD.
//
// Bound: the 5 products of 2 D operations a kept (query, key) pair and
// query head at 67 TFLOP/s (f32 outside the tensor cores): at gemma2-2b's
// f32 train shape (B=1, Sq=Skv=512, H=8, KH=4, D=256, causal) 2.69 GFLOP,
// 40.1 us, against 21 MB of q, k, v, o, dO read once and dq, dk, dv
// written once, 6.3 us at 3.35 TB/s: bound by operations.  This design
// computes S and dP in both kernels (7 products a pair, not 5) and whole
// 32 x 32 tile pairs on the causal diagonal (6% more pairs at 512 tokens).
//
// Design (the register blocking and the cp.async ring of
// csrc/flash_attention.cu, its header's micro-tiles):
// - The forward writes L, so no pass recomputes it.  Three kernels on the
//   caller's stream, no atomics, every run the same bits: `fa_bwd_dq`
//   (dQ, and D_i once a row), `fa_bwd_dkdv` (dK, dV) and `fa_bwd_fold`.
// - Tiles of 32 rows everywhere, 256 threads (8 warps) a block.
//   `fa_bwd_dq`'s unit is a 32-row query tile of one head, its steps the
//   key tiles the mask lets it see.  A segment (a run of a unit's steps)
//   loads Q and dO (f32 in shared memory for the segment's life), reads L
//   and computes D_i = dO_i . O_i (8 lanes a row, f32, a fixed order),
//   which the unit's first segment writes to the f32 `delta` buffer for
//   the dk/dv kernel; then for each key tile: S = Q K^T and dP = dO V^T,
//   P and dS in registers, dS^T to shared memory (key-major), dQ += dS K.
//   `fa_bwd_dkdv`'s unit is a 32-key tile of one KV head, its steps the
//   (query head of the GQA group, 32-row query tile) pairs the mask lets
//   see its keys, head-major.  K and V stay in shared memory for the
//   segment; per step S^T = K Q^T, dP^T = V dO^T, P^T and dS^T to shared
//   memory (query-major), dV += P^T dO, dK += dS^T Q.
// - Register-blocked products with 16-byte shared loads.  S (and dP, S^T,
//   dP^T): warp w owns rows 4w .. 4w+3 of the 32 x 32 tile; a thread
//   owns 4 rows x 8 columns (its lane / 8 picks the 8 columns) over an
//   eighth of the head dim (16-byte chunks lane % 8 + 8 m), per chunk 4 +
//   8 float4 loads for 128 FFMA (2.67 FFMA a 32-bit word); the 8 lanes of
//   a quarter-warp read 8 consecutive chunks of one row, so no two share a
//   bank.  Three xor-shuffle rounds (reduce-scatter) sum the eighths and
//   leave a thread 4 rows x 1 column, which it stores as one float4 into
//   the transposed shared tile (rows of 32 + 4 floats: the 8 lanes of a
//   quarter-warp hit 8 distinct bank groups).  dQ += dS K (and dV, dK):
//   a thread owns 4 rows x 8 columns (16-byte chunks c and c + DP / 8) and,
//   below DP = 256, every (256 / DP)-th key (query) of the tile; per key
//   one float4 of the transposed tile (broadcast) and 2 of K for 32 FFMA
//   (2.67 a word); the key classes add by xor shuffles once at the end.
//   Columns past D are zero in shared memory and never stored.
// - A cp.async ring of 2 slots carries the streamed tiles (K and V in
//   `fa_bwd_dq`; Q, dO, L and D in `fa_bwd_dkdv`) in the inputs' dtype,
//   bf16 widened on read, zero-filled past the sequence and past D: tile
//   n + 1 lands while tile n computes.  Two barriers a tile: one publishes
//   the tile that landed and frees the slot it refills, one publishes the
//   transposed P / dS tile.  With f32 inputs the resident tiles load by
//   cp.async too, bf16 ones are widened once.
// - Work on every SM without atomics (stream-K).  The schedule is the
//   wrapper's (`bwd_work`, a function of the shapes alone, copied to the
//   device once a shape, so a call reads no device value and can be
//   captured in a CUDA graph); the kernels only read it.  Each kernel's
//   units in order (`fa_bwd_dq`: query tiles last-first, the longest
//   under a causal mask; `fa_bwd_dkdv`: key tiles first-first; each for
//   every (batch row, head)), their cost cut into nb equal spans, one a
//   block, nb one block an SM (`fa_bwd_dq` two at DP <= 128).  The plan
//   lists each block's segments (a unit's steps in its span): a segment
//   that is the whole unit writes the gradient; the others write f32
//   partials to the workspace, numbered in block order, and `fa_bwd_fold`
//   (16 blocks a shared unit, 4 rows each) adds each shared unit's
//   partials in that order, then scales and rounds.  So no SM idles
//   while another walks a long causal tile.  Equal spans of steps put the
//   many one-step units at the end of the causal order into a few blocks,
//   each paying a prologue a unit (gemma2-2b's dq kernel 116 us against
//   80 with a cost a unit); the costs and the first design (each tile cut
//   into parts of at most T steps, one a block) are compared in PERF.md.
//   Every plan field is int32: the wrapper raises where one would not fit.
// - Shared memory at DP = 256 (f32): the two resident tiles (32 x 260
//   f32 each), 2 slots of two streamed tiles (32 x 260 in the inputs'
//   type), the transposed tiles (32 x 36 f32; two in `fa_bwd_dkdv`) and
//   the row vectors: 204,544 bytes (`fa_bwd_dq`) and 209,408
//   (`fa_bwd_dkdv`), so one 8-warp block an SM: 8 of 64 warp slots
//   (ptxas: 214 and 248 registers, no spill), the FFMA fed by the ILP of
//   32 independent accumulators.  At DP <= 128 `fa_bwd_dq` runs two
//   blocks an SM (106 KB; ptxas held to 128 registers spills 92 bytes at
//   DP = 128, still faster than one block); `fa_bwd_dkdv` holds 64
//   accumulators (dK and dV; 254 registers) and stays at one.
// - What bounds it (tools/flash_attention_bwd_f32_design.py, PERF.md):
//   at gemma2-2b f32 B 1 the kernels take 4.5x the bound.  The 16-byte
//   loads that feed the products: each product costs about its
//   shared-memory pipe time (2.67 FFMA a word, where 4 would break even),
//   S and dP in both kernels (7 products, not 5), and a third of each
//   kernel outside the products (segment prologues, the score
//   reductions' 28 shuffles a product a tile, two barriers a tile).
// - Head dims: D % 8 == 0, D <= 256, instantiated at DP in {32, 64, 128,
//   256}; a D in between runs at the next DP with zero-filled columns.
//
// The launcher returns -1 for arguments it does not take, else the
// cudaError_t of an attribute or a launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // 8 warps
constexpr int kT = 32;                // rows of every tile (queries or keys)
constexpr int kLdS = kT + 4;          // row stride of the transposed tiles
constexpr int kFoldThreads = 256;
constexpr int kFoldRows = 4;          // rows of a unit a fold block adds
constexpr int kMaxDevices = 64;
constexpr int kSegInts = 8;           // a segment of the plan
constexpr int kFoldInts = 5;          // a shared unit of the plan

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // [B, H, Sq], the forward's
  void* dq;
  void* dk;
  void* dv;
  float* delta;       // [B, H, Sq], written by fa_bwd_dq
  float* wsq;         // dQ partials [pq][kT][D]
  float* wsk;         // dK, dV partials [pk][2][kT][D]
  // the plan (the wrapper's BwdTable of each kernel): segments
  // [n][kSegInts], block offsets [nb + 1], shared units [m][kFoldInts]
  const int* segq;
  const int* offq;
  const int* foldq;
  const int* segk;
  const int* offk;
  const int* foldk;
  int B, Sq, Skv, H, KH, D;
  int nbq, nbk;       // the blocks of fa_bwd_dq and of fa_bwd_dkdv
  int nfq, nfk;       // their shared units
  float scale, softcap, inv_cap;
  int causal, window;
};

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

// 4 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// four elements as f32: from shared memory or, read-only, from global
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 y = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(x.x, x.y, y.x, y.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float4 scale4(float4 x, float m) {
  return make_float4(x.x * m, x.y * m, x.z * m, x.w * m);
}

// the row strides of the shared tiles: f32 resident tiles and tiles in the
// inputs' type, both padded by 16 bytes
template <int DP>
struct Ld {
  static constexpr int kF = DP + 4;
};
template <typename T, int DP>
struct Ring {
  static constexpr int kVec = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int kLd = DP + kVec;
  static constexpr int kTile = kT * kLd;            // elements a tile
};

// rows [row0, row0 + kT) of head `head` of a [B, S, NH, D] tensor into a
// shared tile of DP columns (stride Ring<T, DP>::kLd) by cp.async; rows past
// S and columns past D are zero
template <typename T, int DP>
__device__ __forceinline__ void issue_tile(T* dst, const T* src, int b,
                                           int row0, int S, int NH, int head,
                                           int D) {
  constexpr int kVec = Ring<T, DP>::kVec, kLd = Ring<T, DP>::kLd;
  constexpr int kCpr = DP / kVec;                   // chunks a row
#pragma unroll
  for (int it = 0; it < (kT * kCpr + kThreads - 1) / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (kT * kCpr % kThreads == 0 || idx < kT * kCpr) {
      const int r = idx / kCpr, c = (idx % kCpr) * kVec;
      const int s = row0 + r;
      const bool ok = s < S && c < D;
      const T* g = ok ? src + (((size_t)b * S + s) * NH + head) * D + c : src;
      cp_async16(dst + r * kLd + c, g, ok);
    }
  }
}

// the same rows widened to an f32 tile (stride Ld<DP>::kF): f32 by
// cp.async, bf16 by loads the caller's wait does not cover (they complete
// before the next barrier's reads)
template <typename T, int DP>
__device__ __forceinline__ void load_resident(float* dst, const T* src, int b,
                                              int row0, int S, int NH,
                                              int head, int D) {
  if constexpr (sizeof(T) == 4) {
    issue_tile<float, DP>(dst, reinterpret_cast<const float*>(src), b, row0,
                          S, NH, head, D);
  } else {
    constexpr int kCpr = DP / 4, kLd = Ld<DP>::kF;
#pragma unroll
    for (int it = 0; it < (kT * kCpr + kThreads - 1) / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      if (kT * kCpr % kThreads == 0 || idx < kT * kCpr) {
        const int r = idx / kCpr, c = (idx % kCpr) * 4;
        const int s = row0 + r;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s < S && c < D)
          x = ld4(src + (((size_t)b * S + s) * NH + head) * D + c);
        store4(dst + r * kLd + c, x);
      }
    }
  }
}

// acc[j][i] += A[4 rg + j] . Bt[8 cg + i] over this thread's eighth of the
// head dim (16-byte chunks ds + 8 m): A an f32 resident tile, Bt a ring tile
template <typename T, int DP>
__device__ __forceinline__ void score_tile(const float* A, const T* Bt,
                                           int rg, int cg, int ds,
                                           float (&acc)[4][8]) {
  constexpr int kLa = Ld<DP>::kF, kLb = Ring<T, DP>::kLd;
  const float* a = A + 4 * rg * kLa + 4 * ds;
  const T* bt = Bt + 8 * cg * kLb + 4 * ds;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
  // fully unrolled at DP <= 128 (4 chunks or fewer), twice at 256
#pragma unroll (DP <= 128 ? DP / 32 : 2)
  for (int m = 0; m < DP / 32; ++m) {
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = ld4(a + j * kLa + 32 * m);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 y = ld4(bt + i * kLb + 32 * m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[j][i];
        s = fmaf(x[j].x, y.x, s);
        s = fmaf(x[j].y, y.y, s);
        s = fmaf(x[j].z, y.z, s);
        acc[j][i] = fmaf(x[j].w, y.w, s);
      }
    }
  }
}

// sums the 8 eighths (lanes differing in bits 0-2) and leaves this lane
// column ds of its 8: out[j] = row 4 rg + j, column 8 cg + ds
__device__ __forceinline__ void reduce_scatter(const float (&acc)[4][8],
                                               int ds, float (&out)[4]) {
  const bool b2 = ds & 4, b1 = ds & 2, b0 = ds & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float h1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = b2 ? acc[j][i] : acc[j][4 + i];
      const float keep = b2 ? acc[j][4 + i] : acc[j][i];
      h1[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    float h2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = b1 ? h1[i] : h1[2 + i];
      const float keep = b1 ? h1[2 + i] : h1[i];
      h2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
    const float send = b0 ? h2[0] : h2[1];
    const float keep = b0 ? h2[1] : h2[0];
    out[j] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
}

// acc[j][4 u + e] += sum over rows r = ks + KS n of W[r][4 rg + j] *
// Bt[r][4 (cc + DP / 8 u) + e]: W a transposed f32 tile (stride kLdS), Bt
// a ring tile whose rows are the reduction index
template <typename T, int DP>
__device__ __forceinline__ void accum_tile(const float* W, const T* Bt,
                                           int rg, int cc, int ks,
                                           float (&acc)[4][8]) {
  constexpr int kLb = Ring<T, DP>::kLd, kCC = DP / 8, kKS = 32 / kCC;
  const float* w = W + ks * kLdS + 4 * rg;
  const T* bt = Bt + ks * kLb + 4 * cc;
#pragma unroll 4
  for (int n = 0; n < kT / kKS; ++n) {
    const float4 p = ld4(w + n * kKS * kLdS);
    const float pw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 y = ld4(bt + n * kKS * kLb + 4 * kCC * u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][4 * u] = fmaf(pw[j], y.x, acc[j][4 * u]);
        acc[j][4 * u + 1] = fmaf(pw[j], y.y, acc[j][4 * u + 1]);
        acc[j][4 * u + 2] = fmaf(pw[j], y.z, acc[j][4 * u + 2]);
        acc[j][4 * u + 3] = fmaf(pw[j], y.w, acc[j][4 * u + 3]);
      }
    }
  }
}

// the key classes' sums (lanes differing in bits log2(DP / 8) .. 4), the
// same bits in every lane of a class
template <int DP>
__device__ __forceinline__ void reduce_classes(float (&acc)[4][8]) {
#pragma unroll
  for (int off = DP / 8; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], off);
}

__device__ __forceinline__ bool kept(int qp, int kp, const Args& a) {
  return qp < a.Sq && kp < a.Skv && (!a.causal || kp <= qp) &&
         (a.window <= 0 || qp - kp < a.window);
}

// dS of one kept pair from its raw dot products q.k and dO.v, its row's L
// and D; its P through *p
__device__ __forceinline__ float grad_score(float qk, float dov, float L,
                                            float dlt, const Args& a,
                                            float* p) {
  float s = qk * a.scale, dcap = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(s * a.inv_cap);
    dcap = 1.f - t * t;
    s = a.softcap * t;
  }
  *p = expf(s - L);
  return *p * (dov - dlt) * dcap;
}

template <typename T, int DP>
struct DqSmem {
  static constexpr size_t kBytes =
      sizeof(float) * (2 * (size_t)kT * Ld<DP>::kF + kT * kLdS + 2 * kT) +
      sizeof(T) * (size_t)4 * Ring<T, DP>::kTile;
};

template <typename T, int DP>
struct DkdvSmem {
  static constexpr size_t kBytes =
      sizeof(float) * (2 * (size_t)kT * Ld<DP>::kF + 2 * kT * kLdS + 4 * kT) +
      sizeof(T) * (size_t)4 * Ring<T, DP>::kTile;
};

// dQ of query tile i, head h, batch row b over key tiles [jb, je): into
// dq where dest < 0, else the f32 partial into workspace slot dest; D of
// the tile's rows into `delta` where `first` (the unit's first step)
template <typename T, int DP>
__device__ __forceinline__ void dq_segment(const Args& a, unsigned char* smem,
                                           int i, int b, int h, int jb,
                                           int je, bool first, int dest) {
  constexpr int kLf = Ld<DP>::kF, kTile = Ring<T, DP>::kTile;
  constexpr int kCC = DP / 8;
  float* sQ = reinterpret_cast<float*>(smem);          // [kT][kLf]
  float* sdO = sQ + kT * kLf;                          // [kT][kLf]
  float* sdS = sdO + kT * kLf;                         // dS^T [keys][kLdS]
  float* sL = sdS + kT * kLdS;                         // [kT]
  float* sD = sL + kT;                                 // [kT]
  T* ring = reinterpret_cast<T*>(sD + kT);             // 2 x (K, V)
  const int kh = h / (a.H / a.KH), q0 = i * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* dO = static_cast<const T*>(a.dout);

  auto issue = [&](int t, int slot_) {
    T* dst = ring + slot_ * 2 * kTile;
    issue_tile<T, DP>(dst, K, b, t * kT, a.Skv, a.KH, kh, a.D);
    issue_tile<T, DP>(dst + kTile, V, b, t * kT, a.Skv, a.KH, kh, a.D);
  };
  if (jb < je) issue(jb, 0);
  load_resident<T, DP>(sQ, Q, b, q0, a.Sq, a.H, h, a.D);
  load_resident<T, DP>(sdO, dO, b, q0, a.Sq, a.H, h, a.D);
  cp_async_commit();
  if (tid < kT) {
    const int qp = q0 + tid;
    sL[tid] = qp < a.Sq ? a.lse[((size_t)b * a.H + h) * a.Sq + qp] : INFINITY;
  }
  cp_async_wait_all();
  __syncthreads();
  {  // D_i = dO_i . O_i: 8 lanes a row, every 8th chunk, then xor shuffles
    const int r = tid >> 3, l8 = tid & 7, qp = q0 + r;
    float d = 0.f;
    if (qp < a.Sq) {
      const T* orow = static_cast<const T*>(a.o) +
                      (((size_t)b * a.Sq + qp) * a.H + h) * a.D;
      for (int c = 4 * l8; c < a.D; c += 32) {
        const float4 g = ld4(sdO + r * kLf + c), o = ld4(orow + c);
        d = fmaf(g.x, o.x, d);
        d = fmaf(g.y, o.y, d);
        d = fmaf(g.z, o.z, d);
        d = fmaf(g.w, o.w, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (l8 == 0) {
      sD[r] = d;
      if (first && qp < a.Sq) a.delta[((size_t)b * a.H + h) * a.Sq + qp] = d;
    }
  }

  // score layout: rows 4 warp + j, columns (keys) 8 cg + (eighth ds);
  // after the reduction the key 8 cg + ds
  const int ds = lane & 7, cg = lane >> 3;
  // accumulation layout: rows 4 warp + j, chunks cc and cc + DP / 8, keys
  // ks, ks + 32 / (DP / 8), ...
  const int cc = lane % kCC, ks = lane / kCC;
  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

#pragma unroll 1
  for (int t = jb; t < je; ++t) {
    const int rs = (t - jb) & 1;
    // tile t landed (the prologue's wait covers the first); every thread
    // is past tile t - 1, so its slot and sdS are free
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < je) issue(t + 1, rs ^ 1);
    cp_async_commit();
    const T* Kt = ring + rs * 2 * kTile;
    const T* Vt = Kt + kTile;
    float sacc[4][8], sv[4], pv[4];
    score_tile<T, DP>(sQ, Kt, warp, cg, ds, sacc);
    reduce_scatter(sacc, ds, sv);
    score_tile<T, DP>(sdO, Vt, warp, cg, ds, sacc);
    reduce_scatter(sacc, ds, pv);
    const int kc = 8 * cg + ds, kp = t * kT + kc;
    const float4 L4 = ld4(sL + 4 * warp), D4 = ld4(sD + 4 * warp);
    const float Lr[4] = {L4.x, L4.y, L4.z, L4.w};
    const float Dr[4] = {D4.x, D4.y, D4.z, D4.w};
    float dsv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p;
      dsv[j] = kept(q0 + 4 * warp + j, kp, a)
                   ? grad_score(sv[j], pv[j], Lr[j], Dr[j], a, &p)
                   : 0.f;
    }
    store4(sdS + kc * kLdS + 4 * warp,
           make_float4(dsv[0], dsv[1], dsv[2], dsv[3]));
    __syncthreads();
    accum_tile<T, DP>(sdS, Kt, warp, cc, ks, acc);
  }
  reduce_classes<DP>(acc);
  if (ks != 0) return;
  float* w = a.wsq + (size_t)(dest < 0 ? 0 : dest) * kT * a.D;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * warp + j, qp = q0 + r;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 4 * (cc + kCC * u);
      if (c >= a.D) continue;
      const float4 v4 = make_float4(acc[j][4 * u], acc[j][4 * u + 1],
                                    acc[j][4 * u + 2], acc[j][4 * u + 3]);
      if (dest < 0) {
        if (qp < a.Sq)
          store4(static_cast<T*>(a.dq) +
                     (((size_t)b * a.Sq + qp) * a.H + h) * a.D + c,
                 scale4(v4, a.scale));
      } else {
        store4(w + (size_t)r * a.D + c, v4);
      }
    }
  }
}

// dK and dV of key tile j, KV head kh, batch row b over its steps [ub,
// ue) (query head kh G + u / nqt, query tile lo + u % nqt): into dk, dv
// where dest < 0, else the f32 partials into workspace slot dest
template <typename T, int DP>
__device__ __forceinline__ void dkdv_segment(const Args& a,
                                             unsigned char* smem, int j,
                                             int b, int kh, int lo, int nqt,
                                             int ub, int ue, int dest) {
  constexpr int kLf = Ld<DP>::kF, kTile = Ring<T, DP>::kTile;
  constexpr int kCC = DP / 8;
  float* sK = reinterpret_cast<float*>(smem);          // [kT][kLf]
  float* sV = sK + kT * kLf;                           // [kT][kLf]
  float* sP = sV + kT * kLf;                           // P [queries][kLdS]
  float* sdS = sP + kT * kLdS;                         // dS [queries][kLdS]
  float* sLD = sdS + kT * kLdS;                        // 2 x (L, D) [kT]
  T* ring = reinterpret_cast<T*>(sLD + 4 * kT);        // 2 x (Q, dO)
  const int G = a.H / a.KH, k0 = j * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Q = static_cast<const T*>(a.q);
  const T* dO = static_cast<const T*>(a.dout);

  auto issue = [&](int u, int slot_) {
    const int h = kh * G + u / nqt, q0 = (lo + u % nqt) * kT;
    T* dst = ring + slot_ * 2 * kTile;
    issue_tile<T, DP>(dst, Q, b, q0, a.Sq, a.H, h, a.D);
    issue_tile<T, DP>(dst + kTile, dO, b, q0, a.Sq, a.H, h, a.D);
    if (tid < 2 * kT) {
      const int r = tid & (kT - 1), qp = q0 + r;
      const bool ok = qp < a.Sq;
      const size_t at = ok ? ((size_t)b * a.H + h) * a.Sq + qp : 0;
      cp_async4(sLD + slot_ * 2 * kT + tid, (tid < kT ? a.lse : a.delta) + at,
                ok);
    }
  };
  if (ub < ue) issue(ub, 0);
  load_resident<T, DP>(sK, static_cast<const T*>(a.k), b, k0, a.Skv, a.KH,
                       kh, a.D);
  load_resident<T, DP>(sV, static_cast<const T*>(a.v), b, k0, a.Skv, a.KH,
                       kh, a.D);
  cp_async_commit();

  const int ds = lane & 7, cg = lane >> 3;
  const int cc = lane % kCC, ks = lane / kCC;
  float dk[4][8], dv[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[r][c] = dv[r][c] = 0.f;

#pragma unroll 1
  for (int u = ub; u < ue; ++u) {
    const int rs = (u - ub) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (u + 1 < ue) issue(u + 1, rs ^ 1);
    cp_async_commit();
    const T* Qt = ring + rs * 2 * kTile;
    const T* dOt = Qt + kTile;
    const float* Lt = sLD + rs * 2 * kT;
    const int q0 = (lo + u % nqt) * kT;
    float sacc[4][8], sv[4], pv[4];
    score_tile<T, DP>(sK, Qt, warp, cg, ds, sacc);
    reduce_scatter(sacc, ds, sv);
    score_tile<T, DP>(sV, dOt, warp, cg, ds, sacc);
    reduce_scatter(sacc, ds, pv);
    // rows: keys 4 warp + r; column: the query qc
    const int qc = 8 * cg + ds, qp = q0 + qc;
    const float L = Lt[qc], dlt = Lt[kT + qc];
    float pr[4], dsv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pr[r] = dsv[r] = 0.f;
      if (kept(qp, k0 + 4 * warp + r, a))
        dsv[r] = grad_score(sv[r], pv[r], L, dlt, a, &pr[r]);
    }
    store4(sP + qc * kLdS + 4 * warp, make_float4(pr[0], pr[1], pr[2], pr[3]));
    store4(sdS + qc * kLdS + 4 * warp,
           make_float4(dsv[0], dsv[1], dsv[2], dsv[3]));
    __syncthreads();
    accum_tile<T, DP>(sP, dOt, warp, cc, ks, dv);
    accum_tile<T, DP>(sdS, Qt, warp, cc, ks, dk);
  }
  reduce_classes<DP>(dk);
  reduce_classes<DP>(dv);
  if (ks != 0) return;
  float* w = a.wsk + (size_t)(dest < 0 ? 0 : dest) * 2 * kT * a.D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * warp + r, kp = k0 + row;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 4 * (cc + kCC * u);
      if (c >= a.D) continue;
      const float4 k4 = make_float4(dk[r][4 * u], dk[r][4 * u + 1],
                                    dk[r][4 * u + 2], dk[r][4 * u + 3]);
      const float4 v4 = make_float4(dv[r][4 * u], dv[r][4 * u + 1],
                                    dv[r][4 * u + 2], dv[r][4 * u + 3]);
      if (dest < 0) {
        if (kp < a.Skv) {
          const size_t at = (((size_t)b * a.Skv + kp) * a.KH + kh) * a.D + c;
          store4(static_cast<T*>(a.dk) + at, scale4(k4, a.scale));
          store4(static_cast<T*>(a.dv) + at, v4);
        }
      } else {
        store4(w + (size_t)row * a.D + c, k4);
        store4(w + (size_t)(kT + row) * a.D + c, v4);
      }
    }
  }
}

// a plan's segment: (tile, batch row, head, lo, per, first step, end,
// dest), every thread reading the same words
struct Seg {
  int tile, b, head, lo, per, u, ue, dest;
};

__device__ __forceinline__ Seg load_seg(const int* __restrict__ p) {
  return Seg{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
             __ldg(p + 4), __ldg(p + 5), __ldg(p + 6), __ldg(p + 7)};
}

// the segments of this block's span, from the plan: the query tile's key
// tiles lo + [u, ue)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    fa_bwd_dq(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int end = __ldg(a.offq + blockIdx.x + 1);
  for (int i = __ldg(a.offq + blockIdx.x); i < end; ++i) {
    const Seg g = load_seg(a.segq + (size_t)kSegInts * i);
    dq_segment<T, DP>(a, smem_raw, g.tile, g.b, g.head, g.lo + g.u,
                      g.lo + g.ue, g.u == 0, g.dest);
    __syncthreads();   // the next segment reuses the shared tiles
  }
}

// the same for the key tiles: steps [u, ue) of (query head, query tile)
// pairs, per query tiles a head from lo
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int end = __ldg(a.offk + blockIdx.x + 1);
  for (int i = __ldg(a.offk + blockIdx.x); i < end; ++i) {
    const Seg g = load_seg(a.segk + (size_t)kSegInts * i);
    dkdv_segment<T, DP>(a, smem_raw, g.tile, g.b, g.head, g.lo, g.per, g.u,
                        g.ue, g.dest);
    __syncthreads();
  }
}

// shared unit f of the plan: rows [4 rg, 4 rg + 4) of its f32 partials
// added in order (block order), scaled, rounded
template <typename T, bool DQ>
__device__ __forceinline__ void fold_rows(const Args& a, int f, int rg) {
  if (f >= (DQ ? a.nfq : a.nfk)) return;
  const int* d = (DQ ? a.foldq : a.foldk) + kFoldInts * f;
  const int tile = d[0], b = d[1], head = d[2], p0 = d[3], np = d[4];
  const int cpr = a.D / 4, S = DQ ? a.Sq : a.Skv;
  const float* ws = DQ ? a.wsq : a.wsk;
  const int stride = DQ ? 1 : 2;   // tiles a partial: dQ, or dK and dV
  for (int idx = threadIdx.x; idx < kFoldRows * cpr; idx += kFoldThreads) {
    const int r = kFoldRows * rg + idx / cpr, c = (idx % cpr) * 4;
    const int pos = tile * kT + r;
    if (pos >= S) continue;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    for (int p = p0; p < p0 + np; ++p) {
      const float* w = ws + (size_t)p * stride * kT * a.D;
      const float4 x = ld4(w + (size_t)r * a.D + c);
      s0.x += x.x;
      s0.y += x.y;
      s0.z += x.z;
      s0.w += x.w;
      if (!DQ) {
        const float4 y = ld4(w + (size_t)(kT + r) * a.D + c);
        s1.x += y.x;
        s1.y += y.y;
        s1.z += y.z;
        s1.w += y.w;
      }
    }
    if (DQ) {
      store4(static_cast<T*>(a.dq) +
                 (((size_t)b * a.Sq + pos) * a.H + head) * a.D + c,
             scale4(s0, a.scale));
    } else {
      const size_t at = (((size_t)b * a.Skv + pos) * a.KH + head) * a.D + c;
      store4(static_cast<T*>(a.dk) + at, scale4(s0, a.scale));
      store4(static_cast<T*>(a.dv) + at, s1);
    }
  }
}

// block (f, y) folds rows 4 y of the dQ unit f (y < 8), or rows 4 (y - 8)
// of the dK, dV unit f
template <typename T>
__global__ void __launch_bounds__(kFoldThreads) fa_bwd_fold(const Args a) {
  constexpr int kGroups = kT / kFoldRows;
  if ((int)blockIdx.y < kGroups)
    fold_rows<T, true>(a, blockIdx.x, blockIdx.y);
  else
    fold_rows<T, false>(a, blockIdx.x, blockIdx.y - kGroups);
}

// the kernels' dynamic shared memory attributes, set once a device
template <typename T, int DP>
cudaError_t set_smem_attributes() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fa_bwd_dq<T, DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DqSmem<T, DP>::kBytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fa_bwd_dkdv<T, DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DkdvSmem<T, DP>::kBytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <typename T, int DP>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t e = set_smem_attributes<T, DP>();
  if (e != cudaSuccess) return (int)e;
  // fa_bwd_dq writes D, which fa_bwd_dkdv reads: the same stream
  fa_bwd_dq<T, DP><<<a.nbq, kThreads, DqSmem<T, DP>::kBytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkdv<T, DP><<<a.nbk, kThreads, DkdvSmem<T, DP>::kBytes, stream>>>(
      a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nf = a.nfq > a.nfk ? a.nfq : a.nfk;
  if (nf == 0) return 0;
  fa_bwd_fold<T><<<dim3(nf, 2 * kT / kFoldRows), kFoldThreads, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const Args& a, cudaStream_t s) {
  if (a.D <= 32) return launch<T, 32>(a, s);
  if (a.D <= 64) return launch<T, 64>(a, s);
  if (a.D <= 128) return launch<T, 128>(a, s);
  return launch<T, 256>(a, s);
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv in the inputs' type (is_bf16); lse and
// delta f32 [B, H, Sq]; plan the int32 schedule of both kernels (the
// wrapper's BwdWork.plan: fa_bwd_dq's ns_q segments of kSegInts, its
// nbq + 1 block offsets, its nf_q shared units of kFoldInts, then the same
// for fa_bwd_dkdv); ws the f32 partials, pq of 32 x D (dQ) then 2 x 32 x
// D each (dK, dV).  Query or key tiles that no key or query reaches are
// not written: the caller zeroes their rows.  Returns 0, -1 for arguments
// the kernels do not take, else the CUDA error of an attribute or a
// launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* ws, const void* plan, int is_bf16, int B, int Sq,
    int Skv, int H, int KH, int D, int ns_q, int no_q, int nf_q, int ns_k,
    int no_k, int nf_k, int pq, float scale, int causal, int window,
    float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH || D <= 0 ||
      D > 256 || D % 8 || softcap < 0.f || no_q < 2 || no_k < 2 || !lse ||
      !delta || !ws || !plan || ns_q < 0 || nf_q < 0 || ns_k < 0 ||
      nf_k < 0 || pq < 0)
    return -1;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = static_cast<float*>(delta);
  a.wsq = static_cast<float*>(ws);
  a.wsk = a.wsq + (size_t)pq * kT * D;
  a.segq = static_cast<const int*>(plan);
  a.offq = a.segq + (size_t)kSegInts * ns_q;
  a.foldq = a.offq + no_q;
  a.segk = a.foldq + (size_t)kFoldInts * nf_q;
  a.offk = a.segk + (size_t)kSegInts * ns_k;
  a.foldk = a.offk + no_k;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KH = KH;
  a.D = D;
  a.nbq = no_q - 1;
  a.nbk = no_k - 1;
  a.nfq = nf_q;
  a.nfk = nf_k;
  a.scale = scale;
  a.softcap = softcap;
  a.inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dim<__nv_bfloat16>(a, s) : launch_dim<float>(a, s);
}
