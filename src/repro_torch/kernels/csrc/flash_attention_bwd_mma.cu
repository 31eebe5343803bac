// Flash-attention backward on the tensor cores for Hopper (sm_90a), bf16 in
// and out with f32 accumulation, bound through a plain C interface (ctypes)
// by repro_torch/kernels/flash_attention.py (`flash_attention_bwd`, the
// backward of `FlashAttentionFn`).
//
// Replaces the gradient of the TPU Pallas kernel `flash_attention` of
// repro/kernels/flash_attention.py:80 (body `_fa_kernel` at :32), which JAX
// derives from the kernel's body under jax.grad, on the path whose forward
// is csrc/flash_attention_mma.cu (bf16, f32 accumulator, D % 16 == 0,
// D <= 256).  f32 inputs, the bf16 accumulator and bf16 with D % 16 == 8
// stay on csrc/flash_attention_bwd.cu, whose f32 arithmetic the f32 gates
// need (the tensor cores would round f32 to tf32).
//
// What it computes, as ref.flash_attention_bwd_mma_plain: from q, out,
// d_out [B,Sq,H,D], k, v [B,Skv,KH,D] (bf16) and the forward's row
// log-sum-exp lse [B,H,Sq] (f32; +inf for a row with no kept key), dq
// [B,Sq,H,D] and dk, dv [B,Skv,KH,D] (bf16).  Query row i sits at position
// i, key j at position j; the mask keeps j < Skv, j <= i (causal) and
// i - j < window (window > 0).  S = scale q.k in f32 (the products of bf16
// values are exact in the f32 accumulator), capped to cap * tanh(S / cap)
// when softcap > 0; query head h reads KV head h / (H/KH).  With
// D_i = dO_i . O_i (f32, from the bf16 O):
//   P = exp(S - L) (0 where masked), dP = dO V^T, dS = P (dP - D),
//   times 1 - tanh^2 with a softcap (the capped score's chain rule),
//   dV = bf16(P)^T dO, dQ = scale bf16(dS) K, dK = scale bf16(dS)^T Q,
// dK and dV summed over each GQA group's query heads: P and dS are rounded
// to bf16 before the three products that read them (the A operands of
// mma.sync), every sum is f32.
//
// Bound: at gemma2-2b's train shape (B=4, Sq=Skv=512, H=8, KH=4, D=256,
// causal) the 5 products of 2 D operations a kept pair and query head are
// 10.8 GFLOP, 10.9 us at 989 TFLOP/s (bf16 tensor cores), against 50 MB
// of q, k, v, o, dO read once and dq, dk, dv written once, 15.0 us at
// 3.35 TB/s: bound by bytes.  The kernels take 7.7x that (116 us of
// device time in a design run; cuDNN's backward 101 us): mma.sync without
// wgmma (the card's full tensor-core rate needs wgmma), S and dP computed
// in both kernels (7 products a pair, not 5), 1,024 ldmatrix.x4 fragment
// reads from shared memory for a dq tile pair's 1,536 mma, one 8-warp
// block an SM at D=256 (shared memory), and whole 64 x 64 tile pairs on
// the causal diagonal.
//
// Design (FlashAttention-2's backward on mma.sync.m16n8k16, bf16 in, f32
// accumulators; the fragments, ldmatrix address patterns, the repacking
// of accumulators into A fragments and the cp.async.cg ring with rows
// padded by 16 bytes are those of csrc/flash_attention_mma.cu):
// - The forward writes L (csrc/flash_attention_mma.cu's optional lse
//   output), so no pass recomputes it.
// - `fa_bwd_dq_mma`: one block of 8 warps per (64-query tile, query head,
//   batch row), causal query tiles longest-first.  Its prologue computes
//   D_i = dO_i . O_i for its 64 rows (4 threads a row, f32, fixed order;
//   every chunk of O loaded at once while the first tiles land, dO read
//   from its tile), writes them to the f32 `delta` buffer [B,H,Sq] for the
//   dk/dv kernel, and reads L.  Q and dO stay in shared memory; K_j and V_j stream
//   through a ring of 2 slots (one cp.async group a tile: tile j + 1
//   loads while tile j computes; one barrier a tile).  Warp w takes rows
//   16 (w % 4) .. +15 and keys 32 (w / 4) .. +31 of each 64-key tile:
//   S = Q K^T and dP = dO V^T (B fragments of K and V by ldmatrix), P and
//   dS in registers, then dQ += dS K with dS repacked as the A fragment
//   and K through ldmatrix.trans.  dQ is [16, DP] f32 a warp (DP/2
//   registers a thread); the two key halves add once at the end, through
//   shared memory, in a fixed order.  KV tiles wholly masked are skipped
//   and the mask applies only on tiles that cross an edge.
// - `fa_bwd_dkdv_mma`: one block of 8 warps per (64-key tile, part of a
//   GQA group, KV head, batch row), causal key tiles longest-first.  K and
//   V stay in shared memory; Q_i, dO_i, L_i and D_i of every (query head,
//   query tile) pair of the part stream through a ring of 2 slots.  Warp w
//   forms S^T = K Q^T and dP^T = V dO^T for keys 16 (w % 4) .. +15 and
//   queries 32 (w / 4) .. +31, rebuilds P^T and dS^T and writes them in
//   bf16 to shared memory (64 x 72 each); after a barrier every warp
//   reads all 64 queries of its 16 key rows and accumulates dV += P^T dO
//   and dK += dS^T Q over columns DP/2 (w / 4) .. +DP/2 - 1.  So each warp
//   holds 16 rows x DP/2 columns of both dK and dV, DP/2 registers a
//   thread (at D=256 one warp holding 16 full rows of both would need
//   256).  Query tiles wholly masked are skipped.
// - 8 warps, not 16: a design with 16 warps a block (128 registers a
//   thread, dS through shared memory in the dq kernel, each warp a quarter
//   of the columns) ran 1-15% slower in a design run: it reads about 30%
//   more fragments from shared memory, and more warps did not hide more.
//   Its source is not kept.
// - The group split: a block loops over G / ns query heads of its KV
//   head's group (ns from the wrapper, `bwd_split`: the least divisor of G,
//   at most 8, that makes a block for each SM), so a single KV head still
//   fills the card (gemma3-1b: 32 blocks unsplit, 128 split).  With ns > 1 the
//   ns parts of a key tile run as one thread-block cluster: after the loop
//   each block puts its f32 dK, dV partials in its own shared memory, and
//   each adds a share of the ns partials read through distributed shared
//   memory in part order, then rounds to bf16 (an f32 workspace and a
//   reduce kernel, the first design, cost 11 us of 143 at gemma2-2b: the
//   partials' 34 MB out and back).  No atomics anywhere: every run gives
//   the same bits.
// - Shared memory at DP=256: dq 6 tiles of 64 x 264 bf16 (Q, dO, 2 x (K,
//   V)) + L, D = 203,264 bytes; dk/dv 6 tiles (K, V, 2 x (Q, dO)) + P^T,
//   dS^T + 2 x (L, D) = 222,208 bytes; both under the 232,448 a block may
//   use, so one block an SM.  The launcher sets the attributes once a
//   device and returns their error.
// - Head dims: D % 16 == 0, D <= 256, instantiated at DP in {32, 64, 128,
//   256} (a dk/dv warp's DP/2 columns are whole 16-column ldmatrix.x4
//   tiles); a D in between runs at the next DP with zero-filled columns.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kT = 64;          // rows of every tile (queries or keys)
constexpr int kLdP = kT + 8;    // row stride of the P^T and dS^T tiles
constexpr int kMaxCluster = 8;  // the portable cluster size: parts a group

typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;   // [B, H, Sq], the forward's
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* delta;       // [B, H, Sq], written by the dq kernel
  int B, Sq, Skv, H, KH, D, ns;
  float scale, softcap, inv_cap;
  int causal, window;
};

template <int DP>
struct Tile {
  static constexpr int kLd = DP + 8;      // bf16, rows padded by 16 bytes
  static constexpr int kElems = kT * kLd;
  // dq: Q, dO, 2 slots of (K, V); L and D of the query tile
  static constexpr size_t kDq =
      sizeof(bf16) * (size_t)kElems * 6 + sizeof(float) * 2 * kT;
  // dk/dv: K, V, 2 slots of (Q, dO); P^T and dS^T; 2 slots of (L, D)
  static constexpr size_t kDkdv = sizeof(bf16) * (size_t)kElems * 6 +
                                  sizeof(bf16) * 2 * kT * kLdP +
                                  sizeof(float) * 2 * 2 * kT;
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

// 4 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
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
// into a padded tile; rows past S and columns past D are zero.  Thread t
// copies the 16-byte column chunk t % (DP/8) of every (256 / (DP/8))-th
// row from row t / (DP/8): one address computed a tile, one add a chunk
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int S, int heads, int hd,
                                          int D) {
  constexpr int kChunks = DP / 8;            // 16-byte chunks a row
  constexpr int kStep = kThreads / kChunks;  // rows between a thread's chunks
  constexpr int kN = kT / kStep;             // chunks a thread
  const int c = threadIdx.x % kChunks, r = threadIdx.x / kChunks;
  const size_t step = (size_t)kStep * heads * D;
  const bf16* g = src + ((size_t)(row0 + r) * heads + hd) * D + c * 8;
  const uint32_t s = smem_addr(dst + r * Tile<DP>::kLd + c * 8);
  const bool col_ok = c * 8 < D;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const bool ok = col_ok && row0 + r + i * kStep < S;
    cp_async16(s + i * kStep * Tile<DP>::kLd * (uint32_t)sizeof(bf16),
               ok ? g + i * step : src, ok);
  }
}

// the capped score of a raw dot product and its chain-rule factor
__device__ __forceinline__ float capped(float dot, const Args& a,
                                        float* dcap) {
  float x = dot * a.scale;
  *dcap = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(x * a.inv_cap);
    x = a.softcap * t;
    *dcap = 1.f - t * t;
  }
  return x;
}

__device__ __forceinline__ bool kept(int qp, int kp, const Args& a) {
  return qp < a.Sq && kp < a.Skv && (!a.causal || kp <= qp) &&
         (a.window <= 0 || qp - kp < a.window);
}

// whether the tile pair (queries q0.., keys k0..) holds a masked entry
__device__ __forceinline__ bool crosses_edge(int q0, int k0, const Args& a) {
  const int q_last = min(q0 + kT, a.Sq) - 1;
  return q0 + kT > a.Sq || k0 + kT > a.Skv || (a.causal && k0 + kT - 1 > q0) ||
         (a.window > 0 && q_last - k0 >= a.window);
}

// two blocks an SM where both fit (DP <= 128: 2 x 104,960 bytes of shared
// memory at 128 registers a thread, 72 bytes spilled; 10% faster at
// internlm2-20b's D=128 than one block at 182 registers, in a design run)
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    fa_bwd_dq_mma(Args a) {
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kE = Tile<DP>::kElems;
  constexpr int kKSteps = DP / 16;  // k16 steps of S and dP
  constexpr int kON = DP / 8;       // n8 tiles of dQ
  constexpr uint32_t kB = sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kE;
  bf16* sKV = sdO + kE;                               // [2][K, V]
  float* sL = reinterpret_cast<float*>(sKV + 4 * kE);  // [64]
  float* sDl = sL + kT;                               // [64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kT;
  const int kh = h / (a.H / a.KH);
  const int D = a.D, H = a.H, Sq = a.Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3;   // the warp's 16 query rows
  const int wk = warp >> 2;  // the warp's 32 keys of each tile

  const bf16* qb = a.q + (size_t)b * Sq * H * D;
  const bf16* gb = a.dout + (size_t)b * Sq * H * D;
  const bf16* ob = a.o + (size_t)b * Sq * H * D;
  const bf16* kb = a.k + (size_t)b * a.Skv * a.KH * D;
  const bf16* vb = a.v + (size_t)b * a.Skv * a.KH * D;

  // the KV tiles holding a key the mask keeps for some row of the tile
  const int n_kt = (a.Skv + kT - 1) / kT;
  const int q_last = min(q0 + kT, Sq) - 1;
  const int j_hi = a.causal ? min(n_kt, q_last / kT + 1) : n_kt;
  const int j_lo = a.window > 0 ? max(0, q0 - a.window + 1) / kT : 0;

  // K_j and V_j into slot j & 1, one commit group (empty past the end)
  auto fetch = [&](int j) {
    if (j < j_hi) {
      bf16* s = sKV + (j & 1) * 2 * kE;
      load_tile<DP>(s, kb, j * kT, a.Skv, a.KH, kh, D);
      load_tile<DP>(s + kE, vb, j * kT, a.Skv, a.KH, kh, D);
    }
    cp_async_commit();
  };
  load_tile<DP>(sQ, qb, q0, Sq, H, h, D);
  load_tile<DP>(sdO, gb, q0, Sq, H, h, D);
  fetch(j_lo);

  // D_i = dO_i . O_i, 4 threads a row, in a fixed order: every 16-byte
  // chunk of O the thread needs is loaded at once, while the tiles land,
  // and dO is read from its tile
  {
    constexpr int kOC = DP / 32;   // chunks of a row a thread
    const int r = threadIdx.x >> 2, t4 = threadIdx.x & 3;
    const int qp = q0 + r;
    uint4 ov[kOC];
#pragma unroll
    for (int i = 0; i < kOC; ++i) {
      const int c = (t4 + 4 * i) * 8;
      ov[i] = qp < Sq && c < D ? *reinterpret_cast<const uint4*>(
                                     ob + ((size_t)qp * H + h) * D + c)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
    float Lr = INFINITY;
    const size_t at = ((size_t)b * H + h) * Sq + qp;
    if (t4 == 0 && qp < Sq) Lr = a.lse[at];
    cp_async_wait_all();
    __syncthreads();
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < kOC; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(sdO + r * kLd +
                                                      (t4 + 4 * i) * 8);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp =
          reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(xp[e]);
        const float2 fy = __bfloat1622float2(yp[e]);
        d = fmaf(fx.x, fy.x, d);
        d = fmaf(fx.y, fy.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (t4 == 0) {
      sDl[r] = d;
      sL[r] = Lr;
      if (qp < Sq) a.delta[at] = d;
    }
  }
  __syncthreads();

  // this thread's rows (warp-local rows lane/4 and lane/4 + 8) and the
  // column pair it holds in every n8 tile
  const int rl0 = wr * 16 + (lane >> 2);
  const int qp0 = q0 + rl0, qp1 = qp0 + 8;
  const float L0 = sL[rl0], L1 = sL[rl0 + 8];
  const float d0 = sDl[rl0], d1 = sDl[rl0 + 8];
  const int col2 = (lane & 3) * 2;

  float dq[kON][4];
#pragma unroll
  for (int t = 0; t < kON; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[t][e] = 0.f;

  // ldmatrix row addresses: A (Q, dO) rows lane % 16, column half lane / 16;
  // B of K^T, V^T: keys lane % 8 + 8 (lane / 16), column half (lane / 8) & 1;
  // B of K (trans): keys lane % 8 + 8 ((lane / 8) & 1), columns 8 (lane / 16)
  const uint32_t aQ =
      smem_addr(sQ + (wr * 16 + (lane & 15)) * kLd + (lane >> 4) * 8);
  const uint32_t adO = aQ + kE * kB;
  const uint32_t aKV = smem_addr(sKV);
  const int offB = (wk * 32 + (lane & 7) + 8 * (lane >> 4)) * kLd +
                   ((lane >> 3) & 1) * 8;
  const int offT = (wk * 32 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                   (lane >> 4) * 8;

  for (int j = j_lo; j < j_hi; ++j) {
    // tile j has landed for every thread, and every warp is done with
    // tile j - 1, whose slot tile j + 1 now fills
    cp_async_wait_all();
    __syncthreads();
    fetch(j + 1);

    const uint32_t aK = aKV + (j & 1) * 2 * kE * kB;
    const uint32_t aV = aK + kE * kB;
    // S = Q K_j^T and dP = dO V_j^T: 16 rows x 32 keys a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t aq[4], ag[4];
      ldmatrix_x4(aQ + kk * 16 * kB, aq);
      ldmatrix_x4(adO + kk * 16 * kB, ag);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const uint32_t o = (offB + np * 16 * kLd + kk * 16) * kB;
        uint32_t bb[4];
        ldmatrix_x4(aK + o, bb);
        mma_bf16(s[2 * np], aq, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], aq, bb[2], bb[3]);
        ldmatrix_x4(aV + o, bb);
        mma_bf16(dp[2 * np], ag, bb[0], bb[1]);
        mma_bf16(dp[2 * np + 1], ag, bb[2], bb[3]);
      }
    }

    // P = exp(S - L), dS = P (dP - D) dcap, in place of S; the mask only
    // on tiles that cross an edge
    const int k0 = j * kT;
    const bool edge = crosses_edge(q0, k0, a);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float dc;
        const float x = capped(s[t][e], a, &dc);
        float p = expf(x - (hi ? L1 : L0));
        if (edge && !kept(hi ? qp1 : qp0, k0 + wk * 32 + t * 8 + col2 + (e & 1),
                          a))
          p = 0.f;
        s[t][e] = p * (dp[t][e] - (hi ? d1 : d0)) * dc;
      }
    }

    // dQ += dS K_j over the warp's 32 keys: dS's C fragments of n8 tiles
    // 2kk, 2kk+1 are the A fragment of k16 step kk
    const uint32_t aKt = aKV + ((j & 1) * 2 * kE + offT) * kB;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kON / 2; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(aKt + (kk * 16 * kLd + np * 16) * kB, bb);
        mma_bf16(dq[2 * np], af, bb[0], bb[1]);
        mma_bf16(dq[2 * np + 1], af, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait_all();

  // add the two key halves through shared memory, which the tiles no
  // longer need: warps 4.. write, warps 0.. add theirs first and store
  __syncthreads();
  float* sO = reinterpret_cast<float*>(smem_raw);  // [4][kON][4][32]
  if (wk == 1) {
#pragma unroll
    for (int t = 0; t < kON; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sO[((wr * kON + t) * 4 + e) * 32 + lane] = dq[t][e];
  }
  __syncthreads();
  if (wk == 1) return;
  bf16* o0 = a.dq + (((size_t)b * Sq + qp0) * H + h) * D;
  bf16* o1 = a.dq + (((size_t)b * Sq + qp1) * H + h) * D;
#pragma unroll
  for (int t = 0; t < kON; ++t) {
    const float* po = sO + (wr * kON + t) * 4 * 32 + lane;
    const int c = t * 8 + col2;
    if (c < D) {
      if (qp0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) = __floats2bfloat162_rn(
            (dq[t][0] + po[0]) * a.scale, (dq[t][1] + po[32]) * a.scale);
      if (qp1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(
            (dq[t][2] + po[64]) * a.scale, (dq[t][3] + po[96]) * a.scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv_mma(Args a) {
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kE = Tile<DP>::kElems;
  constexpr int kKSteps = DP / 16;  // k16 steps of S^T and dP^T
  constexpr int kCN = DP / 16;      // n8 tiles of a warp's DP/2 columns
  constexpr uint32_t kB = sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kE;
  bf16* sQd = sV + kE;                     // [2][Q, dO]
  bf16* sP = sQd + 4 * kE;                 // P^T  [64 keys][kLdP]
  bf16* sS = sP + kT * kLdP;               // dS^T [64 keys][kLdP]
  float* sLD = reinterpret_cast<float*>(sS + kT * kLdP);  // [2][L 64, D 64]

  const int G = a.H / a.KH, gp = G / a.ns;  // query heads a part
  const int kh = blockIdx.x / a.ns, part = blockIdx.x % a.ns;
  const int b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * kT;
  const int D = a.D, H = a.H, Sq = a.Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3;   // the warp's 16 keys
  const int wq = warp >> 2;  // its 32 queries of S^T, its DP/2 columns

  const bf16* qb = a.q + (size_t)b * Sq * H * D;
  const bf16* gb = a.dout + (size_t)b * Sq * H * D;
  const bf16* kb = a.k + (size_t)b * a.Skv * a.KH * D;
  const bf16* vb = a.v + (size_t)b * a.Skv * a.KH * D;

  // the query tiles holding a row the mask lets see some key of the tile
  const int nq = (Sq + kT - 1) / kT;
  const int k_last = min(k0 + kT, a.Skv) - 1;
  const int i_lo = a.causal ? k0 / kT : 0;
  const int i_hi =
      a.window > 0 ? min(nq, min(k_last + a.window - 1, Sq - 1) / kT + 1) : nq;
  const int n_qt = max(i_hi - i_lo, 0);
  const int n_items = gp * n_qt;   // (query head, query tile) pairs
  const int h0 = kh * G + part * gp;

  // item n: Q_i, dO_i, L_i and D_i of head h0 + n / n_qt, tile
  // i_lo + n % n_qt, into slot n & 1, one commit group (empty past the end)
  auto fetch = [&](int n) {
    if (n < n_items) {
      const int h = h0 + n / n_qt, i = i_lo + n % n_qt;
      bf16* s = sQd + (n & 1) * 2 * kE;
      load_tile<DP>(s, qb, i * kT, Sq, H, h, D);
      load_tile<DP>(s + kE, gb, i * kT, Sq, H, h, D);
      if (threadIdx.x < 2 * kT) {
        const int r = threadIdx.x & (kT - 1), qp = i * kT + r;
        const float* src = threadIdx.x < kT ? a.lse : a.delta;
        const bool ok = qp < Sq;
        cp_async4(smem_addr(sLD + (n & 1) * 2 * kT + threadIdx.x),
                  ok ? src + ((size_t)b * H + h) * Sq + qp : src, ok);
      }
    }
    cp_async_commit();
  };
  load_tile<DP>(sK, kb, k0, a.Skv, a.KH, kh, D);
  load_tile<DP>(sV, vb, k0, a.Skv, a.KH, kh, D);
  fetch(0);

  float dk[kCN][4], dv[kCN][4];
#pragma unroll
  for (int t = 0; t < kCN; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  const int rl0 = wr * 16 + (lane >> 2);   // this thread's key rows rl0, +8
  const int kp0 = k0 + rl0, kp1 = kp0 + 8;
  const int col2 = (lane & 3) * 2;
  // A of K, V, P^T, dS^T: rows lane % 16, column half lane / 16; B of Q^T,
  // dO^T: queries lane % 8 + 8 (lane / 16), column half (lane / 8) & 1; B
  // of dO, Q (trans): queries lane % 8 + 8 ((lane / 8) & 1), columns
  // 8 (lane / 16) of the warp's DP/2
  const uint32_t aK =
      smem_addr(sK + (wr * 16 + (lane & 15)) * kLd + (lane >> 4) * 8);
  const uint32_t aV = aK + kE * kB;
  const uint32_t aP =
      smem_addr(sP + (wr * 16 + (lane & 15)) * kLdP + (lane >> 4) * 8);
  const uint32_t aS = aP + kT * kLdP * kB;
  const uint32_t aQd = smem_addr(sQd);
  const int offB = (wq * 32 + (lane & 7) + 8 * (lane >> 4)) * kLd +
                   ((lane >> 3) & 1) * 8;
  const int offT = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                   (lane >> 4) * 8 + wq * (DP / 2);

  for (int n = 0; n < n_items; ++n) {
    // item n has landed for every thread; every warp is done with item
    // n - 1 (its slot, P^T and dS^T), whose slot item n + 1 now fills
    cp_async_wait_all();
    __syncthreads();
    fetch(n + 1);

    const int q0 = (i_lo + n % n_qt) * kT;
    const uint32_t aQ = aQd + (n & 1) * 2 * kE * kB;
    const uint32_t adO = aQ + kE * kB;
    const float* sl = sLD + (n & 1) * 2 * kT;

    // S^T = K Q_i^T and dP^T = V dO_i^T: 16 keys x 32 queries a warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(aK + kk * 16 * kB, ak);
      ldmatrix_x4(aV + kk * 16 * kB, av);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const uint32_t o = (offB + np * 16 * kLd + kk * 16) * kB;
        uint32_t bb[4];
        ldmatrix_x4(aQ + o, bb);
        mma_bf16(st[2 * np], ak, bb[0], bb[1]);
        mma_bf16(st[2 * np + 1], ak, bb[2], bb[3]);
        ldmatrix_x4(adO + o, bb);
        mma_bf16(dpt[2 * np], av, bb[0], bb[1]);
        mma_bf16(dpt[2 * np + 1], av, bb[2], bb[3]);
      }
    }

    // P^T and dS^T, rounded to bf16 into shared memory; the mask only on
    // tile pairs that cross an edge
    const bool edge = crosses_edge(q0, k0, a);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int qc = wq * 32 + t * 8 + col2;   // this thread's query columns
      const float Lc[2] = {sl[qc], sl[qc + 1]};
      const float Dc[2] = {sl[kT + qc], sl[kT + qc + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dc;
        const float x = capped(st[t][e], a, &dc);
        float p = expf(x - Lc[e & 1]);
        if (edge && !kept(q0 + qc + (e & 1), e < 2 ? kp0 : kp1, a)) p = 0.f;
        dpt[t][e] = p * (dpt[t][e] - Dc[e & 1]) * dc;
        st[t][e] = p;
      }
      *reinterpret_cast<__nv_bfloat162*>(sP + rl0 * kLdP + qc) =
          __floats2bfloat162_rn(st[t][0], st[t][1]);
      *reinterpret_cast<__nv_bfloat162*>(sP + (rl0 + 8) * kLdP + qc) =
          __floats2bfloat162_rn(st[t][2], st[t][3]);
      *reinterpret_cast<__nv_bfloat162*>(sS + rl0 * kLdP + qc) =
          __floats2bfloat162_rn(dpt[t][0], dpt[t][1]);
      *reinterpret_cast<__nv_bfloat162*>(sS + (rl0 + 8) * kLdP + qc) =
          __floats2bfloat162_rn(dpt[t][2], dpt[t][3]);
    }
    __syncthreads();

    // dV += P^T dO_i and dK += dS^T Q_i over the 64 queries, the warp's 16
    // keys x DP/2 columns
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t ap[4], as[4];
      ldmatrix_x4(aP + kk * 16 * kB, ap);
      ldmatrix_x4(aS + kk * 16 * kB, as);
#pragma unroll
      for (int np = 0; np < kCN / 2; ++np) {
        const uint32_t o = (offT + kk * 16 * kLd + np * 16) * kB;
        uint32_t bb[4];
        ldmatrix_x4_trans(adO + o, bb);
        mma_bf16(dv[2 * np], ap, bb[0], bb[1]);
        mma_bf16(dv[2 * np + 1], ap, bb[2], bb[3]);
        ldmatrix_x4_trans(aQ + o, bb);
        mma_bf16(dk[2 * np], as, bb[0], bb[1]);
        mma_bf16(dk[2 * np + 1], as, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait_all();

  if (a.ns == 1) {   // this warp's 16 keys x DP/2 columns, in bf16
#pragma unroll
    for (int t = 0; t < kCN; ++t) {
      const int c = wq * (DP / 2) + t * 8 + col2;
      if (c >= D) continue;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int kp = hi ? kp1 : kp0;
        if (kp >= a.Skv) continue;
        const size_t at = (((size_t)b * a.Skv + kp) * a.KH + kh) * D + c;
        *reinterpret_cast<__nv_bfloat162*>(a.dk + at) = __floats2bfloat162_rn(
            dk[t][2 * hi] * a.scale, dk[t][2 * hi + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + at) =
            __floats2bfloat162_rn(dv[t][2 * hi], dv[t][2 * hi + 1]);
      }
    }
    return;
  }

  // ns > 1: the cluster's ns blocks are the parts of this KV head's group
  // at this key tile; each puts its f32 partials in its own shared memory,
  // which the tiles no longer need, and adds a share of all ns partials,
  // read through distributed shared memory in part order
  constexpr int kLdA = DP + 4;                        // f32 row stride
  float* sA = reinterpret_cast<float*>(smem_raw);     // [2][64][kLdA]
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kCN; ++t) {
    const int c = wq * (DP / 2) + t * 8 + col2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = rl0 + 8 * hi;
      *reinterpret_cast<float2*>(sA + r * kLdA + c) =
          make_float2(dk[t][2 * hi], dk[t][2 * hi + 1]);
      *reinterpret_cast<float2*>(sA + (kT + r) * kLdA + c) =
          make_float2(dv[t][2 * hi], dv[t][2 * hi + 1]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every part's partials are in place
  constexpr int kRow4 = DP / 4;               // float4s of a row
  constexpr int kAll4 = 2 * kT * kRow4;       // of both partials
  for (int i = (int)cluster.block_rank() * kThreads + threadIdx.x; i < kAll4;
       i += a.ns * kThreads) {
    const int rr = i / kRow4, c = (i - rr * kRow4) * 4;   // rr: dK rows, dV
    const int off = rr * kLdA + c;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(sA, 0) + off);
    for (int p = 1; p < a.ns; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sA, p) + off);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const bool is_v = rr >= kT;
    const int kp = k0 + (is_v ? rr - kT : rr);
    if (kp < a.Skv && c < D) {
      const float m = is_v ? 1.f : a.scale;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          (is_v ? a.dv : a.dk) + (((size_t)b * a.Skv + kp) * a.KH + kh) * D +
          c);
      dst[0] = __floats2bfloat162_rn(sum.x * m, sum.y * m);
      dst[1] = __floats2bfloat162_rn(sum.z * m, sum.w * m);
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

// the kernels' dynamic shared memory attributes, set once a device (two
// CUDA API calls on every backward would add to its host cost)
template <int DP>
cudaError_t set_smem_attributes() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fa_bwd_dq_mma<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Tile<DP>::kDq);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fa_bwd_dkdv_mma<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Tile<DP>::kDkdv);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <int DP>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t e = set_smem_attributes<DP>();
  if (e != cudaSuccess) return (int)e;
  // the dq kernel writes D, which the dk/dv kernel reads: the same stream
  fa_bwd_dq_mma<DP><<<dim3(a.H, a.B, (a.Sq + kT - 1) / kT), kThreads,
                      Tile<DP>::kDq, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.KH * a.ns, a.B, (a.Skv + kT - 1) / kT);
  if (a.ns == 1) {
    fa_bwd_dkdv_mma<DP><<<grid, kThreads, Tile<DP>::kDkdv, stream>>>(a);
    return (int)cudaGetLastError();
  }
  // the ns parts of a group at one key tile: one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<DP>::kDkdv;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fa_bwd_dkdv_mma<DP>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv are bf16; lse and delta f32 [B, H, Sq];
// ns (1 to 8) divides the GQA group H / KH.  Returns 0, -1 for arguments
// the kernels do not take, else the CUDA error of an attribute or a
// launch.
extern "C" int flash_attention_bwd_mma_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int Sq, int Skv, int H, int KH, int D, int ns,
    float scale, int causal, int window, float softcap, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH ||
      D <= 0 || D % 16 || D > 256 || ns <= 0 || ns > kMaxCluster ||
      (H / KH) % ns || softcap < 0.f ||
      (Sq + kT - 1) / kT > 65535 || (Skv + kT - 1) / kT > 65535 ||
      (long long)KH * ns > 2147483647LL)
    return -1;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.delta = static_cast<float*>(delta);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KH = KH;
  a.D = D;
  a.ns = ns;
  a.scale = scale;
  a.softcap = softcap;
  a.inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<32>(a, s);
  if (D <= 64) return launch<64>(a, s);
  if (D <= 128) return launch<128>(a, s);
  return launch<256>(a, s);
}
