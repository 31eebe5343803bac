// Flash-attention forward on the tensor cores for Hopper (sm_90a), bf16 in
// and out with f32 accumulation, bound through a plain C interface
// (ctypes) by repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU Pallas kernel `flash_attention` of
// repro/kernels/flash_attention.py:80 (body `_fa_kernel` at :32) on its
// bf16 path with an f32 accumulator; f32 inputs and the bf16 accumulator
// stay on csrc/flash_attention.cu, which keeps full f32 arithmetic and the
// Pallas kernel's rounding points.
//
// What it computes, as ref.flash_attention_plain with acc_dtype="f32":
// q [B,Sq,H,D], k/v [B,Skv,KH,D] (bf16) -> out [B,Sq,H,D] (bf16).  Query
// row i sits at position i and key j at position j (causal is top-left
// aligned).  The score is scale * (q . k) in f32: the products of bf16
// values are exact in the f32 accumulator, so the unscaled q feeds the
// tensor cores and the scale multiplies the f32 score, whatever the scale.
// An optional logit softcap cap * tanhf(s / cap) (the accurate tanhf; the
// division is a multiplication by 1 / cap, at most 1 ulp apart: an IEEE
// division in the loop, with its slow-path call, made the whole kernel
// slower in a design run) applies before the mask; the mask drops keys
// past Skv, above the diagonal (causal) and with q_pos - k_pos >= window
// (window > 0).  Online softmax over KV tiles; out = acc / max(l, 1e-30).
// Query head h reads KV head h / (H/KH).  With a non-null `lse` [B,H,Sq]
// (f32) it also writes each row's log-sum-exp L = m + log(l) of the merged
// (m, l), +inf for a row with no kept key (the backward's convention: P =
// exp(S - L) = 0 there), for csrc/flash_attention_bwd_mma.cu; O is the
// same bits either way, and the serving path passes null.
//
// Bound: at the serving prefill shape (B=1, Sq=Skv=900, H=8, KH=4, D=256,
// causal) the work is 4*D*H*(valid pairs) = 3.3 GFLOP, 3.36 us at 989
// TFLOP/s (bf16 tensor cores), against 11 MB of Q/K/V/O, 3.3 us at 3.35
// TB/s: bound by operations, so both products run on the tensor cores.
//
// Design (FlashAttention-2's, with each KV tile split over two warps):
// - One block of 8 warps (256 threads) for each tile of 64 query rows of
//   one (query head, batch row).  Warp w takes rows 16 (w % 4) .. +15 and
//   keys 32 (w / 4) .. +31 of every 64-key KV tile, with its own running
//   (m, l, O); the two halves merge once, at the end, through shared
//   memory.  Two warps on each SM sub-partition hide each other's
//   latencies (4 warps of 64 keys each ran slower at the serving shape in
//   a design run).  The grid is (H, B, query tiles) and, under causal
//   masking, walks the query tiles longest-first.  KV tiles wholly above the
//   diagonal or wholly outside the window are skipped (a fully masked
//   tile's contribution is wiped by alpha = 0 as soon as a valid key
//   arrives).  The GQA group's heads are not packed into one block.
// - S = Q K^T with mma.sync.m16n8k16 (bf16 in, f32 accumulators); Q stays
//   in shared memory for the block's life (at D=256 its fragments would
//   take 64 registers a thread beside O's 128); A fragments of Q and B
//   fragments of K come through ldmatrix.
// - The softmax runs on the accumulator fragments in registers: scale,
//   softcap, mask (only on tiles that cross an edge), the row max across
//   the 4 threads that share a row (__shfl_xor_sync), exp, and the
//   rescale of O.  No score goes through shared memory.
// - O += P V with the same mma: P, rounded to bf16, is repacked from the
//   accumulator layout into A fragments in registers (the C fragments of
//   two n8 tiles are the A fragment of one k16 step), and V's B fragments
//   come through ldmatrix.trans.  O is [16, DP] f32 a warp: DP/2 = 128
//   registers a thread at D=256.  ptxas (sm_90a, -O3): 251 registers a
//   thread at DP=256, no spill (182 at 128, 124 at 64, 96 at 32 and 16).
// - K and V stream through one ring of 2 slots of 64 x DP bf16 tiles,
//   filled by cp.async.cg (16 bytes a thread, zero-filled past Skv and
//   past D) in the order K_0, V_0, K_1, V_1, ..., one commit group a tile:
//   V_j loads while S_j multiplies and K_j+1 while P V_j does.  One
//   barrier a tile both publishes the tile that landed and frees the slot
//   the next load fills.  A ring of 4 slots (Q + 2 x (K + V), 168,960
//   bytes) ran no faster in a design run.  Rows are padded by 16 bytes,
//   an odd number of 16-byte chunks a row, so the 8 rows an ldmatrix
//   reads fall in 8 distinct bank groups.
//   Shared memory: 3 tiles of 64 x (DP + 8) bf16, 101,376 bytes at
//   D=256; the launcher sets the dynamic-shared-memory attribute and
//   returns its error.
// - Head dims: D % 16 == 0, D <= 256; the kernel is instantiated at DP in
//   {16, 32, 64, 128, 256} and a D in between runs at the next DP with
//   zero-filled columns.
//
// What bounds it: every warp re-reads its K and V halves from shared
// memory for its 16 rows, and every block streams its K/V tiles from L2
// (120 blocks x 64 KB a tile step at the serving shape).  Next: Hopper's
// own path, wgmma (B read by the tensor cores from shared memory once a
// warpgroup) fed by TMA into an mbarrier ring with a producer warp
// (FlashAttention-3's design), and splitting the longest query tiles'
// KV range over more blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 4;               // warps along the query rows
constexpr int kSplit = 2;                  // warps along a KV tile's keys
constexpr int kThreads = 32 * kRowWarps * kSplit;
constexpr int kBM = 16 * kRowWarps;        // query rows a block
constexpr int kBN = 64;                    // keys a KV tile
constexpr int kKeys = kBN / kSplit;        // keys of a tile a warp takes
constexpr int kSlots = 2;                  // slots of the K/V ring
constexpr float kNegInf = -2.0e38f;

// one 64-row tile of DP columns, each row padded by 8 bf16 (16 bytes)
template <int DP>
struct Tile {
  static constexpr int kLd = DP + 8;
  static constexpr int kElems = 64 * kLd;
  // Q and the ring's slots
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (size_t)kElems * (1 + kSlots);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate (registers only,
// so not volatile: the compiler may schedule it)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows [row0, row0 + 64) of one head of src [S, heads, D] (one batch row)
// into a padded tile; rows past S and columns past D are zero
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int heads, int hd, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  constexpr int kN = 64 * kChunks;
#pragma unroll
  for (int i = 0; i < (kN + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kN % kThreads && idx >= kN) break;
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool ok = row < S && c * 8 < D;
    const __nv_bfloat16* g =
        ok ? src + ((size_t)row * heads + hd) * D + c * 8 : src;
    cp_async16(smem_addr(dst + r * Tile<DP>::kLd + c * 8), g, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int H,
                           int KH, int D, float scale, int causal, int window,
                           float softcap) {
  constexpr int NS = kSlots;
  static_assert(NS >= 2 && (NS & (NS - 1)) == 0, "a ring of 2^n slots");
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kE = Tile<DP>::kElems;
  constexpr int kKSteps = DP / 16;  // k16 steps of Q K^T
  constexpr int kON = DP / 8;       // n8 tiles of O
  constexpr int kSN = kKeys / 8;    // n8 tiles of S a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + kE;            // [NS][kE]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kBM;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % kRowWarps;         // the warp's 16 rows
  const int wk = warp / kRowWarps;         // the warp's half of each tile

  const __nv_bfloat16* qb = q + (size_t)b * Sq * H * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * KH * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * KH * D;

  // the KV tiles this query tile needs
  const int n_kt = (Skv + kBN - 1) / kBN;
  const int q_last = min(q0 + kBM, Sq) - 1;
  const int j_hi = causal ? min(n_kt, q_last / kBN + 1) : n_kt;
  const int j_lo = window > 0 ? max(0, q0 - window + 1) / kBN : 0;
  const int n_items = 2 * max(j_hi - j_lo, 0);

  // item n of the stream: K (n even) or V (n odd) of tile j_lo + n / 2,
  // into slot n % NS; one commit group per item (empty past the end)
  auto fetch = [&](int n) {
    if (n < n_items)
      load_tile<DP>(sKV + (n & (NS - 1)) * kE, n & 1 ? vb : kb,
                    (j_lo + n / 2) * kBN, Skv, KH, kh, D);
    cp_async_commit();
  };
  // prologue: Q with item 0 (one group), then items 1 .. NS-2
  load_tile<DP>(sQ, qb, q0, Sq, H, h, D);
#pragma unroll
  for (int n = 0; n < NS - 1; ++n) fetch(n);

  // this thread's rows (warp-local rows lane/4 and lane/4 + 8) and the
  // column pair it holds in every n8 tile
  const int qp0 = q0 + wr * 16 + (lane >> 2), qp1 = qp0 + 8;
  const int col2 = (lane & 3) * 2;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  float o[kON][4];
#pragma unroll
  for (int t = 0; t < kON; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // ldmatrix row addresses: A (Q) rows lane % 16, column half lane / 16;
  // B of K^T: keys lane % 8 + 8 (lane / 16), column half (lane / 8) & 1;
  // B of V (trans): keys lane % 8 + 8 ((lane / 8) & 1), columns 8 (lane / 16)
  constexpr uint32_t kB = sizeof(__nv_bfloat16);
  const uint32_t aQ =
      smem_addr(sQ + (wr * 16 + (lane & 15)) * kLd + (lane >> 4) * 8);
  const uint32_t aKV = smem_addr(sKV);
  const int offK = (wk * kKeys + (lane & 7) + 8 * (lane >> 4)) * kLd +
                   ((lane >> 3) & 1) * 8;
  const int offV = (wk * kKeys + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                   (lane >> 4) * 8;

  for (int j = j_lo; j < j_hi; ++j) {
    const int n = 2 * (j - j_lo);
    // item n (K_j) has landed for every thread, and every warp is done
    // with item n - 1, whose slot item n + NS - 1 now fills
    cp_async_wait<NS - 2>();
    __syncthreads();
    fetch(n + NS - 1);

    // S = Q K_j^T: 16 rows x 32 keys a warp, 4 n8 tiles
    float s[kSN][4];
#pragma unroll
    for (int t = 0; t < kSN; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    const uint32_t aK = aKV + ((n & (NS - 1)) * kE + offK) * kB;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(aQ + kk * 16 * kB, a);
#pragma unroll
      for (int np = 0; np < kSN / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(aK + (np * 16 * kLd + kk * 16) * kB, bb);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale, softcap, mask; the mask only on tiles that cross an edge
    const int k0 = j * kBN;
    const bool edge = k0 + kBN > Skv || (causal && k0 + kBN - 1 > q0) ||
                      (window > 0 && q_last - k0 >= window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int t = 0; t < kSN; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        if (edge) {
          const int qp = e < 2 ? qp0 : qp1;
          const int kp = k0 + wk * kKeys + t * 8 + col2 + (e & 1);
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && qp - kp < window;
          if (!ok) x = kNegInf;
        }
        s[t][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int t = 0; t < kSN; ++t) {
      s[t][0] = expf(s[t][0] - mn0);
      s[t][1] = expf(s[t][1] - mn0);
      s[t][2] = expf(s[t][2] - mn1);
      s[t][3] = expf(s[t][3] - mn1);
      sum0 += s[t][0] + s[t][1];
      sum1 += s[t][2] + s[t][3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int t = 0; t < kON; ++t) {
      o[t][0] *= al0;
      o[t][1] *= al0;
      o[t][2] *= al1;
      o[t][3] *= al1;
    }

    // item n + 1 (V_j) has landed; item n's slot takes item n + NS
    cp_async_wait<NS - 2>();
    __syncthreads();
    fetch(n + NS);

    // O += P V_j over the warp's keys: P's C fragments of n8 tiles 2kk,
    // 2kk+1 are the A fragment of k16 step kk
    const uint32_t aV = aKV + (((n + 1) & (NS - 1)) * kE + offV) * kB;
#pragma unroll
    for (int kk = 0; kk < kSN / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kON / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(aV + (kk * 16 * kLd + np * 16) * kB, bb);
        mma_bf16(o[2 * np], a, bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // the row sums: the 4 threads of a row hold partial sums
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // merge the two halves' (m, l, O) through shared memory, which the ring
  // no longer needs: warps kRowWarps.. write, warps 0.. read and store
  __syncthreads();
  float* sO = reinterpret_cast<float*>(smem_raw);   // [kRowWarps][kON][4][32]
  float* sML = sO + kRowWarps * kON * 4 * 32;       // [kRowWarps][4][32]
  if (wk == 1) {
#pragma unroll
    for (int t = 0; t < kON; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sO[((wr * kON + t) * 4 + e) * 32 + lane] = o[t][e];
    sML[(wr * 4 + 0) * 32 + lane] = m0;
    sML[(wr * 4 + 1) * 32 + lane] = m1;
    sML[(wr * 4 + 2) * 32 + lane] = l0;
    sML[(wr * 4 + 3) * 32 + lane] = l1;
  }
  __syncthreads();
  if (wk == 1) return;
  const float pm0 = sML[(wr * 4 + 0) * 32 + lane];
  const float pm1 = sML[(wr * 4 + 1) * 32 + lane];
  const float mm0 = fmaxf(m0, pm0), mm1 = fmaxf(m1, pm1);
  const float ca0 = expf(m0 - mm0), cb0 = expf(pm0 - mm0);
  const float ca1 = expf(m1 - mm1), cb1 = expf(pm1 - mm1);
  const float ls0 = l0 * ca0 + sML[(wr * 4 + 2) * 32 + lane] * cb0;
  const float ls1 = l1 * ca1 + sML[(wr * 4 + 3) * 32 + lane] * cb1;
  const float r0 = 1.f / fmaxf(ls0, 1e-30f);
  const float r1 = 1.f / fmaxf(ls1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {
    // a row whose max never left kNegInf kept no key
    float* lb = lse + ((size_t)b * H + h) * Sq;
    if (qp0 < Sq) lb[qp0] = mm0 > kNegInf ? mm0 + logf(ls0) : INFINITY;
    if (qp1 < Sq) lb[qp1] = mm1 > kNegInf ? mm1 + logf(ls1) : INFINITY;
  }
  __nv_bfloat16* o0 = out + (((size_t)b * Sq + qp0) * H + h) * D;
  __nv_bfloat16* o1 = out + (((size_t)b * Sq + qp1) * H + h) * D;
#pragma unroll
  for (int t = 0; t < kON; ++t) {
    const float* po = sO + (wr * kON + t) * 4 * 32 + lane;
    const int c = t * 8 + col2;
    if (c < D) {
      if (qp0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(
            (o[t][0] * ca0 + po[0] * cb0) * r0,
            (o[t][1] * ca0 + po[32] * cb0) * r0);
      if (qp1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(
            (o[t][2] * ca1 + po[64] * cb1) * r1,
            (o[t][3] * ca1 + po[96] * cb1) * r1);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KH, int D,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  auto kern = flash_attention_mma_kernel<DP>;
  const size_t smem = Tile<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Sq, Skv, H, KH, D, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on success, -1 for a shape the kernel does not take, else the
// cudaError_t of setting the shared-memory attribute or of the launch.
// q/k/v/out are bf16; D % 16 == 0 and D <= 256; any GQA group H / KH;
// lse is null or f32 [B, H, Sq].
extern "C" int flash_attention_mma_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int B,
                                          int Sq, int Skv, int H, int KH,
                                          int D, float scale, int causal,
                                          int window, float softcap,
                                          void* stream) {
  if (KH <= 0 || H % KH || D <= 0 || D % 16 || D > 256 || Sq <= 0 ||
      Skv <= 0 || B <= 0 || B > 65535 || (Sq + kBM - 1) / kBM > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_MMA_LAUNCH(DP)                                                  \
  return launch<DP>(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, \
                    KH, D, scale, causal, window, softcap, s)
  if (D <= 16) FA_MMA_LAUNCH(16);
  if (D <= 32) FA_MMA_LAUNCH(32);
  if (D <= 64) FA_MMA_LAUNCH(64);
  if (D <= 128) FA_MMA_LAUNCH(128);
  FA_MMA_LAUNCH(256);
#undef FA_MMA_LAUNCH
}
