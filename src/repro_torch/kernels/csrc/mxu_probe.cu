// Tensor-core probe for Hopper (sm_90a): mma.sync (HMMA, the instruction
// the paper's WMMA study measures) on operands staged in shared memory,
// bound through a plain C interface (ctypes) by
// repro_torch/kernels/mxu_probe.py.
//
// Replaces the TPU Pallas kernel `mxu_probe` (`_probe_kernel`) of
// repro/kernels/mxu_probe.py:26: the paper's Table III / Fig. 5 experiment.
// It computes, per (bm, bn) output tile, the dependent chain
//   C <- (A_tile @ C) * 0.001, rounded to the input dtype, `chain` times,
// from C = B[:, tile columns], with f32 accumulation: a [M,K], b [K,N] ->
// out [M,N].  With chain > 1 the reference needs bm == K == M (C <- A @ C),
// so a block owns the whole [K, bn] column panel.  One block of 8 warps per
// tile: the tile is the measured quantity and is never re-tiled.
//
// Instruction: bf16 runs mma.sync.m16n8k16 (bf16 in, f32 accumulators); f32
// runs as tf32, mma.sync.m16n8k8 on inputs rounded to tf32 (cvt.rna, as
// WMMA's __float_to_tf32), f32 accumulators.  wgmma would change the
// instruction the calibration names.
//
// What bounds it: a chain step is 2*bm*bn*K operations on one SM, bound by
// that SM's mma.sync issue rate and the shared memory that feeds it; a lone
// chain-1 tile adds its operands' trip from L2 into that one SM (128 KB for
// bf16 256x128x128); a grid of independent tiles re-reads its operands for
// every product, so below K ~ 300 it is bound by the bytes it moves, not
// by the card's dense tensor-core rate (989 TFLOP/s bf16, 495 tf32).  The
// first port (WMMA) loaded every A fragment from device memory and kept
// one accumulator a warp, so every HMMA waited for its own loads (43,269
// cycles a bf16 128^3 step).  This design:
// - Stages A and C in shared memory, every tile laid out as a row of
//   128-byte column panels with 16-byte chunk c of row r at c ^ (r % 8):
//   the layout the TMA unit writes under its 128-byte swizzle, in which
//   the 8 rows an ldmatrix reads fall in 8 distinct bank groups.
// - Where the A tile [bm, K] and B's panel [K, bn] (two panels at chain >
//   1, the double buffer) fit a block, all of it is requested at once, in
//   units of one column panel of A (64 bf16 or 32 f32 values of k) and the
//   rows of B they meet, each unit counted on its own mbarrier; the warps
//   multiply each unit as it lands, and later steps read shared memory
//   alone.  The TMA unit loads them (2-D tensor maps, one box a column
//   panel, issued by lane 0 of each warp in turn), where K and bn fill
//   whole panels and bm <= 256; cp.async from every thread otherwise.  A
//   lone SM takes 2-D TMA boxes at several times the rate of 16-byte
//   cp.async, and a thread that issues cp.async stalls until the memory
//   system takes them, so cp.async from the multiplying warps delayed the
//   first HMMA by the whole transfer (tools/mxu_probe_design.py measures
//   both).
// - Otherwise A streams through a ring of kStages 128-byte k-slabs (at
//   chain 1 with the slab's rows of B's panel columns), loaded the same
//   way (TMA from thread 0, counted on the slot's mbarrier, after a
//   fence.proxy.async; or cp.async), two slabs ahead of the HMMAs.
// - Tiles a block's output over its 8 warps as a 2-D warp grid of 32 x WN
//   warp tiles (WN = 64 in bf16, 32 in f32, 16 where bn needs it): each
//   warp holds 2 x WN/8 m16n8 accumulators (16 at WN = 64), so 16
//   independent HMMAs a k-step are in flight, each A fragment is reused
//   across WN/8 of them and each B fragment across 2.  A tile larger than
//   the warp grid's (128 x 128 at WN = 64 and bn >= 128; 256 x 64 at bn =
//   64) runs in passes.  f32 stops at WN = 32: its scalar B loads and tf32
//   conversions at WN = 64 need more than 255 registers.
// - Fragments come from shared memory through ldmatrix (A; bf16 B through
//   ldmatrix.trans); tf32 B, which ldmatrix.trans cannot split, is read as
//   scalars.  The swizzle's XOR and chunk offsets are lane constants, and
//   whole column panels run their k-steps without a branch.
// - The epilogue scales by 0.001 and rounds to the dtype in registers
//   (__floats2bfloat162_rn on accumulator pairs) and writes the next
//   step's panel: one __syncthreads a step where staged.  The last step's
//   tile goes through a free shared buffer and then out in 16-byte rows
//   (stored from the fragments, each warp instruction would write 16 bytes
//   of 8 rows).  The reference's rounding points are kept.
// - The dynamic-shared-memory limit is set once per kernel instance and
//   device, and the last 8 tensor maps are kept, not made on every launch.
//
// Thread 0 of block (0, 0) writes the chain's clock64() cycles and
// %globaltimer ns (`timing[0]`, `timing[1]`), from the kernel's start
// (before the first load) to the end of the output's store.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;                 // slots of the k-slab ring
constexpr int kMaxUnits = 8;               // mbarriers of a staged load
                                           // (then kStages of the ring)
constexpr long long kSmemMax = 232448;     // 227 KB a block
constexpr int kHead = 2048;  // the mbarriers and 1 KB alignment slack
constexpr int kMaxDevices = 64;
// 0 builds the kernel without its TMA path (cp.async for every shape), to
// compare the two load paths on one card
#ifndef MXU_PROBE_TMA
#define MXU_PROBE_TMA 1
#endif

// per dtype: the elements of one 128-byte row segment (a column panel's
// width)
template <typename T>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kW = 64;
};
template <>
struct Traits<float> {
  static constexpr int kW = 32;
};

// How a launch lays out its block; computed on the host alone (the same
// arithmetic as mxu_probe.py `plan`) and passed to the kernel.  Every
// shared tile is a row of 128-byte column panels, [rows, 128 bytes] each,
// with 16-byte chunk c of row r stored at chunk c ^ (r % 8): the layout the
// TMA unit writes under its 128-byte swizzle, in which the 8 rows an
// ldmatrix reads fall in 8 distinct bank groups.
struct Plan {
  int ni;           // n8 fragments a warp (warp tile 32 x 8 ni)
  int wgm, wgn;     // the warp grid; a pass covers pm x pn of the tile
  int pm, pn;
  int rows_a;       // A rows a ring slot holds (min(pm, bm))
  int cols_b;       // B columns a ring slot holds at chain 1 (min(pn, bn))
  int pan_a;        // 128-byte column panels of A [bm, K] (ceil(K / W))
  int pan_b;        // ... of B's panel [K, bn] (ceil(bn / W))
  int pan_bs;       // ... of a ring slot's B slab [W, cols_b]
  int staged;       // A [bm, K] and the panel(s) resident for the launch
  int tma;          // loaded by the TMA unit (else by cp.async)
  long long smem;   // dynamic shared memory, bytes
};

Plan make_plan(int is_bf16, int K, int bm, int bn, int chain) {
  Plan p;
  const int W = is_bf16 ? 64 : 32;
  // f32 caps the warp tile at 32 x 32: at 32 x 64 its scalar B loads and
  // tf32 conversions need more than 255 registers a thread
  p.ni = bn % 64 == 0 && is_bf16 ? 8 : (bn % 32 == 0 ? 4 : 2);
  const int wn = 8 * p.ni;
  p.wgn = bn >= 2 * wn ? 2 : 1;
  p.wgm = kWarps / p.wgn;
  p.pm = 32 * p.wgm;
  p.pn = wn * p.wgn;
  p.rows_a = p.pm < bm ? p.pm : bm;
  p.cols_b = p.pn < bn ? p.pn : bn;
  p.pan_a = (K + W - 1) / W;
  p.pan_b = (bn + W - 1) / W;
  p.pan_bs = (p.cols_b + W - 1) / W;
  const long long panel = 128LL * K * p.pan_b;
  const long long staged = (chain > 1 ? 2 : 1) * panel + 128LL * bm * p.pan_a;
  p.staged = kHead + staged <= kSmemMax && p.pan_a <= kMaxUnits;
  p.tma = MXU_PROBE_TMA && K % W == 0 && bn % W == 0 &&
          (!p.staged || bm <= 256);
  const long long slot =
      128LL * p.rows_a + (chain == 1 ? 128LL * W * p.pan_bs : 0);
  p.smem = kHead + (p.staged ? staged
                             : (chain > 1 ? 2 * panel : 0) + kStages * slot);
  return p;
}

// a swizzled shared tile: its byte address and the rows of each panel
struct View {
  uint32_t base;
  int rows;
};

// the shared address of 16-byte chunk c of row r
__device__ __forceinline__ uint32_t chunk(View v, int r, int c) {
  return v.base + (c >> 3) * v.rows * 128 + r * 128 + (((c ^ r) & 7) << 4);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the barrier counts one arrival of this thread once every cp.async it
// issued so far has landed (the arrival is in the barrier's count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// one arrival that also expects `bytes` from the TMA unit
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait for the barrier's phase `parity` to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// a box of a 2-D tensor map at (x, y) into shared memory by the TMA unit,
// its bytes counted on `bar` as they land
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(x), "r"(y), "r"(bar)
      : "memory");
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

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16x8] += a[16x8] b[8x8], tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(uint32_t bits) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(bits)));
  return r;
}

// The k-steps of one 128-byte column panel of a warp's 32 x 8NI tile: A
// fragments at a0 (+ 2048 bytes a 16-row fragment, + swa[t] at k-step t),
// B at b0 (+ the step's rows, + swb/bofs by column).  Tail: only the first
// klen values of k are there (the last, partial panel), tested step by
// step; else the panel is whole and its steps run without a branch, so
// the compiler can load the next step's fragments under this step's
// HMMAs.  Full: the whole warp tile lies inside the block's tile; else only
// its first mv m16 and nv n8 fragments do.
template <int NI, bool Full, bool Tail>
__device__ __forceinline__ void panel_steps(float (&acc)[2][NI][4],
                                            __nv_bfloat16*, uint32_t a0,
                                            uint32_t b0,
                                            const uint32_t (&swa)[4],
                                            const uint32_t (&swb)[NI],
                                            int klen, int mv, int nv) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (Tail && 16 * t >= klen) break;
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      if (Full || mi < mv) ldmatrix_x4(a0 + 2048 * mi + swa[t], af[mi]);
#pragma unroll
    for (int np = 0; np < NI / 2; ++np) {
      if (!Full && 2 * np >= nv) break;
      uint32_t bf[4];
      ldmatrix_x4_trans(b0 + 2048 * t + swb[np], bf);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (Full || mi < mv) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
    }
  }
}

template <int NI, bool Full, bool Tail>
__device__ __forceinline__ void panel_steps(float (&acc)[2][NI][4], float*,
                                            uint32_t a0, uint32_t b0,
                                            const uint32_t (&swa)[4],
                                            const uint32_t (&bofs)[NI],
                                            int klen, int mv, int nv) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (Tail && 8 * t >= klen) break;
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      if (Full || mi < mv) {
        ldmatrix_x4(a0 + 2048 * mi + swa[t], af[mi]);
#pragma unroll
        for (int i = 0; i < 4; ++i) af[mi][i] = to_tf32(af[mi][i]);
      }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (!Full && ni >= nv) break;
      // b0 at (k = .. + lane % 4, n = nb + 8 ni + lane / 4); b1 four rows
      // on, where the swizzle flips bit 2 of the chunk (byte offset ^ 64)
      const uint32_t bt = b0 + 1024 * t;
      const uint32_t v0 = to_tf32(lds32(bt + bofs[ni]));
      const uint32_t v1 = to_tf32(lds32(bt + 512 + (bofs[ni] ^ 64)));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (Full || mi < mv) mma_tf32(acc[mi][ni], af[mi], v0, v1);
    }
  }
}

// k in [0, klen) of a warp's 32 x 8NI tile: A rows [ra, ra + 32) of view
// A from k = ka, B rows from k = kb and columns [nb, nb + 8NI) of view B;
// ka and kb start a 128-byte column panel, and only the last panel may be
// partial.  Every row an ldmatrix lane addresses is 8-aligned plus
// (lane & 7), so the swizzle's XOR and the chunk offsets are lane
// constants, computed once.
template <typename T, int NI, bool Full>
__device__ __forceinline__ void k_range(float (&acc)[2][NI][4], View A,
                                        int ra, int ka, View B, int kb,
                                        int nb, int klen, int mv, int nv,
                                        int lane) {
  constexpr int W = Traits<T>::kW;
  constexpr bool bf16 = sizeof(T) == 2;
  const int x = lane & 7, hi = lane >> 4;
  uint32_t swa[4], swb[NI];
#pragma unroll
  for (int t = 0; t < 4; ++t) swa[t] = ((2 * t + hi) ^ x) << 4;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (bf16) {
      // ldmatrix.trans of n16 pair i: chunk (nb / 8 + 2 i + hi), rows
      // kb + (lane & 15)
      swb[i] = i < NI / 2
                   ? ((((nb >> 3) & 7) + 2 * i + hi) ^ x) << 4
                   : 0;
    } else {
      // scalar b0 of n8 fragment i at row .. + lane % 4
      const int n = nb + 8 * i + (lane >> 2);
      swb[i] = (n / W) * B.rows * 128 + ((((n >> 2) & 7) ^ (lane & 3)) << 4) +
               4 * (n & 3);
    }
  }
  uint32_t a0 = A.base + (ka / W) * A.rows * 128 + (ra + (lane & 15)) * 128;
  uint32_t b0 = B.base + (kb + (bf16 ? (lane & 15) : (lane & 3))) * 128 +
                (bf16 ? (nb / W) * B.rows * 128 : 0);
  int p = 0;
#pragma unroll 1
  for (; p + W <= klen; p += W) {
    panel_steps<NI, Full, false>(acc, static_cast<T*>(nullptr), a0, b0, swa,
                                 swb, W, mv, nv);
    a0 += A.rows * 128;
    b0 += W * 128;
  }
  if (p < klen)
    panel_steps<NI, Full, true>(acc, static_cast<T*>(nullptr), a0, b0, swa,
                                swb, klen - p, mv, nv);
}

template <typename T, int NI>
__device__ __forceinline__ void k_range_any(float (&acc)[2][NI][4], View A,
                                            int ra, int ka, View B, int kb,
                                            int nb, int klen, int mv, int nv,
                                            int lane) {
  if (mv == 2 && nv == NI)
    k_range<T, NI, true>(acc, A, ra, ka, B, kb, nb, klen, mv, nv, lane);
  else if (mv > 0 && nv > 0)
    k_range<T, NI, false>(acc, A, ra, ka, B, kb, nb, klen, mv, nv, lane);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// a pair (x, y) of output elements rounded to T: into shared memory at addr
__device__ __forceinline__ void sts2(__nv_bfloat16* tag, uint32_t addr,
                                     float x, float y) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pack2(tag, x, y))
               : "memory");
}
__device__ __forceinline__ void sts2(float*, uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}
// ... or into device memory at p
__device__ __forceinline__ void stg2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void stg2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// 0.001 * acc rounded to T, for the warp tile at rows rw, columns cw: into
// the swizzled view P (the next step's panel or the output's staging), or,
// with P.rows == 0, into device memory at g (row stride ldg).  A lane's
// rows are 8-aligned plus lane / 4, so its swizzle XOR is a constant too.
template <typename T, int NI, bool Full>
__device__ __forceinline__ void store_tile(const float (&acc)[2][NI][4],
                                           View P, T* g, size_t ldg, int rw,
                                           int cw, int mv, int nv, int lane) {
  constexpr int E = 16 / sizeof(T), W = Traits<T>::kW;
  const int g4 = lane >> 2, t2 = 2 * (lane & 3);
  const uint32_t row = P.base + (rw + g4) * 128;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    if (!Full && ni >= nv) break;
    const int n = cw + 8 * ni + t2;
    const uint32_t col = (n / W) * P.rows * 128 +
                         ((((n / E) & 7) ^ g4) << 4) +
                         (n % E) * static_cast<int>(sizeof(T));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!Full && mi >= mv) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = acc[mi][ni][2 * h] * 0.001f;
        const float y = acc[mi][ni][2 * h + 1] * 0.001f;
        if (P.rows > 0)
          sts2(static_cast<T*>(nullptr), row + (16 * mi + 8 * h) * 128 + col,
               x, y);
        else
          stg2(g + (rw + 16 * mi + 8 * h + g4) * ldg + n, x, y);
      }
    }
  }
}

// rows x cols of T from global (row stride ldg) into view v at row r0 and
// chunk c0, by 16-byte cp.async spread over NT threads (tid < NT); cols *
// sizeof(T) is a multiple of 16
template <int NT, typename T>
__device__ __forceinline__ void copy_in(View v, int r0, int c0, const T* g,
                                        int ldg, int rows, int cols, int tid) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = cols / E;  // 16-byte chunks a row
  if (NT % cpr == 0) {
    // a fixed chunk column a thread, rows NT / cpr apart
    const int rr = tid / cpr, c = tid - rr * cpr;
    for (int r = rr; r < rows; r += NT / cpr)
      cp_async16(chunk(v, r0 + r, c0 + c),
                 g + static_cast<size_t>(r) * ldg + c * E);
  } else {
    for (int i = tid; i < rows * cpr; i += NT) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(chunk(v, r0 + r, c0 + c),
                 g + static_cast<size_t>(r) * ldg + c * E);
    }
  }
}

// rows x cols of T from view v to global (row stride ldg), 16 bytes a
// multiplying thread, neighbouring threads on neighbouring addresses
template <typename T>
__device__ __forceinline__ void copy_out(T* g, int ldg, View v, int rows,
                                         int cols) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = cols / E;
  for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
    const int r = i / cpr, c = i - r * cpr;
    uint4 x;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                 : "r"(chunk(v, r, c)));
    *reinterpret_cast<uint4*>(g + static_cast<size_t>(r) * ldg + c * E) = x;
  }
}

template <typename T, int NI>
__global__ void __launch_bounds__(kThreads, 1)
    mxu_probe_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ out, int N, int K, int bm, int bn,
                     int chain, Plan p, long long* __restrict__ timing,
                     const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b) {
  constexpr int W = Traits<T>::kW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t bars = raw;  // kMaxUnits mbarriers
  // the tiles from the first 1 KB boundary after the mbarriers: the
  // panels (two at chain > 1, one staged at chain 1), then A, staged
  // whole or as the ring's slots
  const uint32_t base = (raw + kHead - 1024 + 1023) & ~1023u;
  const uint32_t panel_bytes = 128u * K * p.pan_b;
  const View panel0{base, K}, panel1{base + panel_bytes, K};
  const int npanel = chain > 1 ? 2 : (p.staged ? 1 : 0);
  const uint32_t abuf = base + npanel * panel_bytes;
  const uint32_t slot = 128u * p.rows_a + (chain == 1 ? 128u * W * p.pan_bs
                                                      : 0u);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % p.wgm, wn = warp / p.wgm;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  const T* a_rows = a + static_cast<size_t>(row0) * K;
  const bool clocked = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;
  unsigned long long g0 = 0;
  long long t0 = 0;
  if (clocked) {
    g0 = globaltimer();
    t0 = clock64();
  }
  if (p.tma && threadIdx.x == 0) {
    // fetch the tensor maps while the barriers are set up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_a) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&map_b) : "memory");
  }
  if (p.staged) {
    // A [bm, K] and B's panel in units of one 128-byte column panel of A
    // (W values of k) and the W rows of B's panel they meet, each counted
    // on its own mbarrier, all requested at once, and the warps start on
    // each unit as it lands.  By the TMA unit: one box a column panel,
    // issued by lane 0 of each warp in turn, unit by unit; else by
    // cp.async from every thread.
    if (threadIdx.x < p.pan_a)
      mbar_init(bars + 8 * threadIdx.x, p.tma ? 1 + p.pan_b : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    if (p.tma) {
      // box i of unit u: A's (v == 0) or B's column panel v - 1; each
      // issuing lane arrives on the unit's barrier with its box's bytes
      if (lane == 0)
        for (int i = warp; i < p.pan_a * (1 + p.pan_b); i += kWarps) {
          const int u = i / (1 + p.pan_b), v = i - u * (1 + p.pan_b);
          const uint32_t bar = bars + 8 * u;
          mbar_expect_tx(bar, 128 * (v == 0 ? bm : W));
          if (v == 0)
            tma_load(abuf + 128u * bm * u, &map_a, u * W, row0, bar);
          else
            tma_load(panel0.base + 128u * (K * (v - 1) + u * W), &map_b,
                     col0 + (v - 1) * W, u * W, bar);
        }
    } else {
#pragma unroll 1
      for (int u = 0; u < p.pan_a; ++u) {
        const int k0 = u * W, kw = min(W, K - k0);
        copy_in<kThreads>(View{abuf, bm}, 0, k0 / (16 / sizeof(T)),
                          a_rows + k0, K, bm, kw, threadIdx.x);
        copy_in<kThreads>(panel0, k0, 0,
                          b + static_cast<size_t>(k0) * N + col0, N, kw, bn,
                          threadIdx.x);
        cp_async_mbar_arrive(bars + 8 * u);
      }
    }
  } else {
    // the ring's slot barriers, each completing once a use
    if (p.tma && threadIdx.x < kStages)
      mbar_init(bars + 8 * (kMaxUnits + threadIdx.x), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (chain > 1) {
      copy_in<kThreads>(panel0, 0, 0, b + col0, N, K, bn, threadIdx.x);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
  }
  int ring_n = 0;  // ring slabs used so far: slab u in slot u % kStages
  // The last step's tile goes through shared memory, then out in 16-byte
  // rows, where a buffer is free for it: at chain > 1 the panel the step
  // does not read; at chain 1 staged in one pass, B's panel once every
  // warp is done with it (bm <= K).  Else the epilogue stores it directly.
  T* const out_tile = out + static_cast<size_t>(row0) * N + col0;
  const bool one_pass = bm <= p.pm && bn <= p.pn;
  const View none{0, 0};
  const View stage = chain > 1 ? (((chain - 1) & 1) ? panel0 : panel1)
                     : (p.staged && one_pass && bm <= K ? panel0 : none);
  const int nslab = (K + W - 1) / W;  // the ring's slabs; the last may be
                                      // narrower
  for (int step = 0; step < chain; ++step) {
    const View src = (step & 1) ? panel1 : panel0;
    const bool last = step == chain - 1;
    const View dst = !last ? ((step & 1) ? panel0 : panel1) : stage;
    for (int pm0 = 0; pm0 < bm; pm0 += p.pm) {
      for (int pn0 = 0; pn0 < bn; pn0 += p.pn) {
        // this warp's 32 x 8NI tile, relative to the block's tile
        const int rw = pm0 + 32 * wm, cw = pn0 + 8 * NI * wn;
        const int mv = rw < bm ? min(2, (bm - rw) / 16) : 0;
        const int nv = cw < bn ? min(NI, (bn - cw) / 8) : 0;
        float acc[2][NI][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
        // the pass's k-chunks: on the first pass of a staged launch the
        // load's units as they land, on later ones the whole of K from
        // shared memory; else the ring's slabs, where A rows [pm0, pm0 +
        // rows) and, at chain 1, B columns [pn0, pn0 + cols) of slab j (k
        // in [j W, + kw)) go to slot j % kStages
        const bool first = step == 0 && pm0 == 0 && pn0 == 0;
        const int rows = min(p.pm, bm - pm0), cols = min(p.pn, bn - pn0);
        // slab j by cp.async from every thread, or by the TMA unit (one
        // box of A and one a column panel of B, from thread 0, counted on
        // the slot's barrier, after a proxy fence: the slot's last reads,
        // by ldmatrix in this pass or the one before, come before the TMA
        // unit's writes)
        auto load = [&](int j) {
          const int u = ring_n + j;
          const uint32_t sa = abuf + (u % kStages) * slot;
          if (p.tma) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            const uint32_t bar = bars + 8 * (kMaxUnits + u % kStages);
            mbar_expect_tx(bar, 128 * (p.rows_a + (chain == 1 ? W * p.pan_bs
                                                               : 0)));
            tma_load(sa, &map_a, j * W, row0 + pm0, bar);
            if (chain == 1)
              for (int v = 0; v < p.pan_bs; ++v)
                tma_load(sa + 128u * (p.rows_a + W * v), &map_b,
                         col0 + pn0 + v * W, j * W, bar);
            return;
          }
          const int kw = min(W, K - j * W);
          copy_in<kThreads>(View{sa, p.rows_a}, 0, 0,
                            a_rows + static_cast<size_t>(pm0) * K + j * W, K,
                            rows, kw, threadIdx.x);
          if (chain == 1)
            copy_in<kThreads>(View{sa + 128u * p.rows_a, W}, 0, 0,
                              b + static_cast<size_t>(j * W) * N + col0 + pn0,
                              N, kw, cols, threadIdx.x);
        };
        if (!p.staged) {
#pragma unroll 1
          for (int j = 0; j < kStages - 1; ++j) {
            if (j < nslab && (!p.tma || threadIdx.x == 0)) load(j);
            cp_async_commit();
          }
        }
        const int nchunk = p.staged ? (first ? p.pan_a : 1) : nslab;
#pragma unroll 1
        for (int j = 0; j < nchunk; ++j) {
          if (p.staged) {
            const int k0 = first ? j * W : 0;
            const int kw = first ? min(W, K - k0) : K;
            if (first) mbar_wait(bars + 8 * j, 0);
            k_range_any<T, NI>(acc, View{abuf, bm}, rw, k0, src, k0, cw, kw,
                               mv, nv, lane);
          } else {
            const int u = ring_n + j;
            if (!p.tma) cp_async_wait<kStages - 2>();
            __syncthreads();  // slab j - 1's slot is free (and, by
                              // cp.async, slab j landed)
            if (j + kStages - 1 < nslab && (!p.tma || threadIdx.x == 0))
              load(j + kStages - 1);
            cp_async_commit();
            if (p.tma)
              mbar_wait(bars + 8 * (kMaxUnits + u % kStages),
                        (u / kStages) & 1);
            const uint32_t sa = abuf + (u % kStages) * slot;
            const int kw = min(W, K - j * W);
            if (chain == 1)
              k_range_any<T, NI>(acc, View{sa, p.rows_a}, rw - pm0, 0,
                                 View{sa + 128u * p.rows_a, W}, 0, cw - pn0,
                                 kw, mv, nv, lane);
            else
              k_range_any<T, NI>(acc, View{sa, p.rows_a}, rw - pm0, 0, src,
                                 j * W, cw, kw, mv, nv, lane);
          }
        }
        if (!p.staged) {
          ring_n += nslab;
          __syncthreads();  // the ring's slots are free again
        }
        // scale, round to T in registers, write the next panel or the
        // output tile
        if (last && chain == 1 && stage.rows > 0)
          __syncthreads();  // B's panel is read by every warp: now free
        if (mv == 2 && nv == NI)
          store_tile<T, NI, true>(acc, dst, out_tile, N, rw, cw, mv, nv,
                                  lane);
        else if (mv > 0 && nv > 0)
          store_tile<T, NI, false>(acc, dst, out_tile, N, rw, cw, mv, nv,
                                   lane);
      }
    }
    __syncthreads();  // the step's panel is written and its source free
  }
  if (stage.rows > 0) copy_out(out_tile, N, stage, bm, bn);
  if (clocked && timing != nullptr) {
    const long long t1 = clock64();
    const unsigned long long g1 = globaltimer();
    timing[0] = t1 - t0;
    timing[1] = static_cast<long long>(g1 - g0);
  }
}

// the dynamic-shared-memory limit, set once per kernel instance and device
template <typename T, int NI>
cudaError_t prepare() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(mxu_probe_kernel<T, NI>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemMax));
  if (e == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return e;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kMapCache = 8;
struct MapKey {
  const void* ptr;
  int rows, cols, ld, box_rows, elem;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && ld == o.ld &&
           box_rows == o.box_rows && elem == o.elem;
  }
};

// a 2-D tensor map over rows x cols of T (row stride ld elements), boxes of
// box_rows x 128 bytes under the 128-byte swizzle; 0 or an error code
template <typename T>
int encode_new(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
               int box_rows) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&fn),
                                cudaEnableDefault, &q) != cudaSuccess ||
        fn == nullptr)
      return -3;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Traits<T>::kW),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(
      map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// encode_new's map, of the last kMapCache kept (a map holds addresses and
// shapes alone), so a caller that launches again on the same tensors
// encodes nothing (the wrappers call from one host thread)
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
           int box_rows) {
  static MapKey keys[kMapCache] = {};
  static CUtensorMap maps[kMapCache];
  static int next = 0;
  const MapKey key{ptr, rows, cols, ld, box_rows, static_cast<int>(sizeof(T))};
  for (int i = 0; i < kMapCache; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return 0;
    }
  const int rc = encode_new<T>(map, ptr, rows, cols, ld, box_rows);
  if (rc == 0) {
    keys[next] = key;
    maps[next] = *map;
    next = (next + 1) % kMapCache;
  }
  return rc;
}

template <typename T, int NI>
int launch_ni(const void* a, const void* b, void* out, int M, int N, int K,
              int bm, int bn, int chain, const Plan& p, long long* timing,
              cudaStream_t s) {
  cudaError_t e = prepare<T, NI>();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map_a{}, map_b{};
  if (p.tma) {
    int rc = encode<T>(&map_a, a, M, K, K, p.staged ? bm : p.rows_a);
    if (rc == 0) rc = encode<T>(&map_b, b, K, N, N, Traits<T>::kW);
    if (rc != 0) return rc;
  }
  dim3 grid(N / bn, M / bm);
  mxu_probe_kernel<T, NI><<<grid, kThreads, p.smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      N, K, bm, bn, chain, p, timing, map_a, map_b);
  return static_cast<int>(cudaGetLastError());
}

// the instances: NI 8, 4, 2 in bf16; 4, 2 in f32 (make_plan's cap)
template <typename T>
int launch(const void* a, const void* b, void* out, int M, int N, int K,
           int bm, int bn, int chain, const Plan& p, long long* timing,
           cudaStream_t s) {
  if constexpr (sizeof(T) == 2)
    if (p.ni == 8)
      return launch_ni<T, 8>(a, b, out, M, N, K, bm, bn, chain, p, timing,
                             s);
  if (p.ni == 4)
    return launch_ni<T, 4>(a, b, out, M, N, K, bm, bn, chain, p, timing, s);
  return launch_ni<T, 2>(a, b, out, M, N, K, bm, bn, chain, p, timing, s);
}

template <typename T, int NI>
int occupancy_ni(size_t smem) {
  if (prepare<T, NI>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mxu_probe_kernel<T, NI>, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

template <typename T>
int occupancy(const Plan& p) {
  const size_t smem = static_cast<size_t>(p.smem);
  if constexpr (sizeof(T) == 2)
    if (p.ni == 8) return occupancy_ni<T, 8>(smem);
  return p.ni == 4 ? occupancy_ni<T, 4>(smem) : occupancy_ni<T, 2>(smem);
}

bool bad_shape(int M, int N, int K, int bm, int bn, int chain) {
  return M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || chain <= 0 ||
         M % 16 || N % 16 || K % 16 || bm % 16 || bn % 16 || M % bm ||
         N % bn || (chain > 1 && (bm != K || M != K));
}

}  // namespace

// The dynamic shared memory a launch needs: 2 KB of mbarriers and
// alignment, then, staged where it fits, B's panel [K, bn] (two at chain >
// 1, the double buffer) and the A tile [bm, K], each in 128-byte column
// panels (the last padded).  Else the ring: 3 slots of a 128-byte k-slab
// of min(pm, bm) A rows and, at chain 1, of the slab's rows of min(pn, bn)
// B columns; at chain > 1 beside the two panels.
extern "C" long long mxu_probe_smem_bytes(int is_bf16, int K, int bm, int bn,
                                          int chain) {
  return make_plan(is_bf16, K, bm, bn, chain).smem;
}

// Blocks of a launch that fit on one SM at once (the occupancy the CUDA
// runtime reports for the kernel instance and its shared memory); -1 on an
// error.
extern "C" int mxu_probe_blocks_per_sm(int is_bf16, int K, int bm, int bn,
                                       int chain) {
  if (K <= 0 || bm <= 0 || bn <= 0 || chain <= 0 || K % 16 || bm % 16 ||
      bn % 16 || (chain > 1 && bm != K))
    return -1;
  const Plan p = make_plan(is_bf16, K, bm, bn, chain);
  if (p.smem > kSmemMax) return 0;
  return is_bf16 ? occupancy<__nv_bfloat16>(p) : occupancy<float>(p);
}

// is_bf16: 1 bf16, 0 f32 (tf32 tensor cores).  M, N, K, bm, bn multiples of
// 16; bm | M, bn | N; chain > 1 needs bm == K == M.  timing: NULL or
// 2 int64 (cycles, ns).  Returns 0 or a CUDA error code (-1: bad arguments,
// -2: more shared memory than a block has, -3: no cuTensorMapEncodeTiled,
// 1000 + r: cuTensorMapEncodeTiled returned r).
extern "C" int mxu_probe_launch(int is_bf16, const void* a, const void* b,
                                void* out, int M, int N, int K, int bm, int bn,
                                int chain, long long* timing, void* stream) {
  if (bad_shape(M, N, K, bm, bn, chain)) return -1;
  const Plan p = make_plan(is_bf16, K, bm, bn, chain);
  if (p.smem > kSmemMax) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, b, out, M, N, K, bm, bn, chain,
                                         p, timing, s)
                 : launch<float>(a, b, out, M, N, K, bm, bn, chain, p, timing,
                                 s);
}
