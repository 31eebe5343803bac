// A variant of csrc/flash_attention.cu for the design tool
// (tools/flash_attention_design.py, part `split_warps`), not part of the
// package: the same function, the same C interface, the same work split
// and merge kernel, with the block's 16 warps split into two groups.
//
// - 8 score warps: a warp owns 8 query rows and all 64 keys of a tile;
//   a thread an 8-row x 8-key micro-tile over a quarter of the head dim
//   (8 Q and 8 K float4 for 256 FFMA a chunk: 4 FFMA a word a thread),
//   so a row's max and sum take warp shuffles alone.  They write P and
//   each row's rescale into one of two P buffers (one when a bf16
//   accumulator tile spans several 64-key sub-tiles).
// - 8 P V warps: a thread owns 8 rows x 4 NC columns of O (2 P and NC V
//   float4 for 32 NC FFMA a key: 4 FFMA a word at NC = 2).
// - Each group streams its own operand through its own 2-slot cp.async
//   ring (K slabs, V slabs) behind its own named barrier; named barriers
//   "full" and "empty" per P buffer hand a tile's P from the score warps
//   to the P V warps, so the scores of tile j + 1 run beside P V of tile
//   j.
//
// Measured against the kernel in the design tool's runs (PERF.md): no
// faster at f32 D=256, slower with the bf16 accumulator, so the package
// ships the single-group design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 512;     // 16 warps, one block an SM
constexpr int kGroup = 256;       // the score warps, then the P V warps
constexpr int kRows = 64;         // query rows a block: G heads x BQ positions
constexpr int kSub = 64;          // keys of one score sub-tile
constexpr int kSlabD = 64;        // head-dim columns of a K slab
constexpr int kSlabV = 16;        // keys of a V slab
constexpr int kStages = 2;        // slots of each cp.async ring
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

// named barriers: 0 is __syncthreads; the score warps' ring, the P V
// warps' ring, and per P buffer b "full" (scores -> P V) and "empty"
// (P V -> scores), each over both groups
constexpr int kBarS = 1, kBarV = 2, kBarFull = 3, kBarEmpty = 5;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// one K slab's share of a score thread's micro-tile: rows j of qs (8
// rows), keys kg + 8 ii of kt, 16-byte head-dim chunks c = ds + 4 t below
// nch; FULL (nch == 16) drops the guard, so no branch splits the loads.
// One chunk a trip: unrolled, the loads hoisted ahead spill registers
template <bool FULL, typename T>
__device__ __forceinline__ void score_slab(const float* qs, int ldq,
                                           const T* kt, int kg, int ds,
                                           int nch, float (&sacc)[8][8]) {
#pragma unroll 1
  for (int t = 0; t < kSlabD / 16; ++t) {
    const int c = ds + 4 * t;
    if (FULL || c < nch) {
      float4 qa[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) qa[j] = ld4(qs + j * ldq + 4 * c);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const float4 kb = ld4(kt + (kg + 8 * ii) * kLdK + 4 * c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
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

// the shared-memory layout of one block (a mirror of the wrapper's
// `smem_bytes`)
template <typename T>
struct Smem {
  float* q;       // [kRows][D + 4]: the scaled Q tile
  T* kring;       // [kStages][kSub][kLdK]: K slabs
  T* vring;       // [kStages][kSlabV][D + 16 / sizeof(T)]: V slabs
  float* p;       // [npbuf][nsub * kSub][kLdP]: scores, then P, key-major
  float* alpha;   // [npbuf][kRows]: each tile's rescale
  float* l;       // [kRows]
  float* m;       // [kRows]
  __device__ Smem(unsigned char* raw, int D, int nsub, int npbuf) {
    q = reinterpret_cast<float*>(raw);
    kring = reinterpret_cast<T*>(q + kRows * (D + 4));
    vring = kring + kStages * kSub * kLdK;
    p = reinterpret_cast<float*>(vring +
                                 kStages * kSlabV * (D + 16 / (int)sizeof(T)));
    alpha = p + npbuf * nsub * kSub * kLdP;
    l = alpha + npbuf * kRows;
    m = l + kRows;
  }
};

template <typename T>
size_t smem_bytes(int D, int nsub) {
  const int npbuf = nsub == 1 ? 2 : 1;
  return sizeof(float) * (size_t)kRows * (D + 4) +
         sizeof(T) * (size_t)kStages *
             (kSub * kLdK + kSlabV * (D + 16 / (int)sizeof(T))) +
         sizeof(float) * ((size_t)npbuf * (nsub * kSub * kLdP + kRows) +
                          2 * kRows);
}

// NC: 16-byte column chunks of O a P V thread owns (D <= 128 NC);
// BF16ACC: round m, l and acc to bf16 after every KV tile.  Threads 0-255
// are the score warps, 256-511 the P V warps.
template <typename T, int NC, bool BF16ACC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int ldq = D + 4;
  const int ldv = D + 16 / (int)sizeof(T);
  const int npbuf = p.nsub == 1 ? 2 : 1;   // P buffers: S runs a tile ahead
  const Smem<T> sm(smem_raw, D, p.nsub, npbuf);

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
  const int ntiles = lo + (int)((long long)(s + 1) * n / ns) - jb;

  const int G = p.H / p.KH, R = G * p.BQ, q0 = i * p.BQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nks = (D + kSlabD - 1) / kSlabD;   // K slabs a score sub-tile
  const int nvs = (p.LK + kSlabV - 1) / kSlabV;  // V slabs a tile
  constexpr int VEC = 16 / sizeof(T);
  const int pstride = p.nsub * kSub * kLdP;    // floats a P buffer

  if (tid < kGroup) {
    // ---- the score warps: warp w owns rows 8 w .. 8 w + 7 -------------
    const int w = tid >> 5;
    const int ds = lane & 3, ds0 = ds & 1, ds1 = ds >> 1, kg = lane >> 2;
    // after the reduce-scatter: rows srow + jj, keys kg + 8 (4 ds1 + ii)
    const int srow = 8 * w + 4 * ds0;
    const bool row_writer = (lane >> 1) == 0;   // one lane of the 16 a row
    int qpos[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) qpos[jj] = q0 + (srow + jj) % p.BQ;
    const T* kgl = static_cast<const T*>(p.k);
    const int per_tile = p.nsub * nks;
    const int total = ntiles * per_tile;
    auto issue = [&](int m) {
      if (m < total) {
        const int t = m / per_tile, r = m % per_tile;
        const int k0 = (jb + t) * p.LK;
        const int st = r / nks, d0 = (r % nks) * kSlabD;
        const int dw = min(kSlabD, D - d0) / VEC;     // chunks a key
        T* dst = sm.kring + (m % kStages) * kSub * kLdK;
        for (int idx = tid; idx < kSub * dw; idx += kGroup) {
          const int key = idx / dw, c = (idx - key * dw) * VEC;
          const int kt = st * kSub + key, kp = k0 + kt;
          const bool ok = kt < p.LK && kp < p.Skv;
          const T* src =
              ok ? kgl + (((size_t)b * p.Skv + kp) * p.KH + kh) * D + d0 + c
                 : kgl;
          cp_async16(dst + key * kLdK + c, src, ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll 1
    for (int m = 0; m < kStages - 1; ++m) issue(m);
    {  // the Q tile, scaled in f32 as the Pallas kernel scales it
      const T* qg = static_cast<const T*>(p.q);
      const int dv = D / VEC;
      for (int idx = tid; idx < kRows * dv; idx += kGroup) {
        const int r = idx / dv, c = (idx - r * dv) * VEC;
        float f[VEC];
        const int g = r / p.BQ, qp = q0 + r % p.BQ;
        if (r < R && qp < p.Sq) {
          load16(qg + (((size_t)b * p.Sq + qp) * p.H + kh * G + g) * D + c,
                 f);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          store4(sm.q + r * ldq + c + e,
                 make_float4(f[e] * p.scale, f[e + 1] * p.scale,
                             f[e + 2] * p.scale, f[e + 3] * p.scale));
      }
    }
    int cur = 0;   // the K slab this group computes next
    // wait for slab `cur`, free the slot of slab cur - 1, refill it
    auto next = [&]() -> const T* {
      cp_async_wait<kStages - 2>();
      bar_sync(kBarS, kGroup);
      issue(cur + kStages - 1);
      return sm.kring + (cur++ % kStages) * kSub * kLdK;
    };

    float m_run[4], l_run[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      m_run[jj] = acc_round<BF16ACC>(kNegInf);
      l_run[jj] = 0.f;
    }
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = (jb + t) * p.LK, pb = t % npbuf;
      float* P = sm.p + pb * pstride;
      if (t >= npbuf) bar_sync(kBarEmpty + pb, kThreads);  // P V read it
      float tmax[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
      // 1. masked scores of the tile, kSub keys at a time, into P
#pragma unroll 1
      for (int st = 0; st < p.nsub; ++st) {
        float sacc[8][8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[j][c] = 0.f;
#pragma unroll 1
        for (int sl = 0; sl < nks; ++sl) {
          const T* kt = next();
          const int d0 = sl * kSlabD;
          const int nch = min(kSlabD, D - d0) / 4;
          const float* qs = sm.q + (8 * w) * ldq + d0;
          if (nch == kSlabD / 4)
            score_slab<true>(qs, ldq, kt, kg, ds, nch, sacc);
          else
            score_slab<false>(qs, ldq, kt, kg, ds, nch, sacc);
        }
        // sum the four head-dim quarters: rows by ds0, then keys by ds1
        float h[4][8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            const float send = ds0 ? sacc[jj][ii] : sacc[4 + jj][ii];
            const float keep = ds0 ? sacc[4 + jj][ii] : sacc[jj][ii];
            h[jj][ii] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
          }
        float sc[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float send = ds1 ? h[jj][ii] : h[jj][4 + ii];
            const float keep = ds1 ? h[jj][4 + ii] : h[jj][ii];
            sc[jj][ii] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
          }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int kt = st * kSub + kg + 8 * (4 * ds1 + ii);  // key in tile
          const int kp = k0 + kt;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float sv = sc[jj][ii];
            if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);
            bool ok = kp < p.Skv;
            if (p.causal) ok = ok && kp <= qpos[jj];
            if (p.window > 0) ok = ok && qpos[jj] - kp < p.window;
            sv = ok ? sv : kNegInf;
            if (kt < p.LK) tmax[jj] = fmaxf(tmax[jj], sv);
            sc[jj][ii] = sv;
          }
          store4(P + kt * kLdP + srow,
                 make_float4(sc[0][ii], sc[1][ii], sc[2][ii], sc[3][ii]));
        }
      }
      // 2. the online-softmax step: a row's 16 lanes are one warp's
      float alpha[4], psum[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float mx = tmax[jj];
#pragma unroll
        for (int off = 2; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[jj], acc_round<BF16ACC>(mx));
        alpha[jj] = acc_round<BF16ACC>(
            expf(acc_round<BF16ACC>(m_run[jj] - m_new)));
        m_run[jj] = m_new;
        psum[jj] = 0.f;
      }
#pragma unroll 1
      for (int st = 0; st < p.nsub; ++st) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int kt = st * kSub + kg + 8 * (4 * ds1 + ii);
          float* pp = P + kt * kLdP + srow;
          const float4 sv = ld4(pp);
          const float sv4[4] = {sv.x, sv.y, sv.z, sv.w};
          float pr[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            pr[jj] = kt < p.LK ? expf(sv4[jj] - m_run[jj]) : 0.f;
            psum[jj] += pr[jj];
          }
          store4(pp, make_float4(pr[0], pr[1], pr[2], pr[3]));
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float sm_ = psum[jj];
#pragma unroll
        for (int off = 2; off < 32; off <<= 1)
          sm_ += __shfl_xor_sync(0xffffffffu, sm_, off);
        l_run[jj] = acc_round<BF16ACC>(
            acc_round<BF16ACC>(l_run[jj] * alpha[jj]) +
            acc_round<BF16ACC>(sm_));
      }
      if (row_writer)
        store4(sm.alpha + pb * kRows + srow,
               make_float4(alpha[0], alpha[1], alpha[2], alpha[3]));
      bar_arrive(kBarFull + pb, kThreads);   // P and alpha of tile t
    }
    if (row_writer) {
      store4(sm.l + srow, make_float4(l_run[0], l_run[1], l_run[2],
                                      l_run[3]));
      store4(sm.m + srow, make_float4(m_run[0], m_run[1], m_run[2],
                                      m_run[3]));
    }
    __syncthreads();   // (m, l) to the P V warps
    if (ns > 1 && tid < kRows) {   // this item's partial (m, l)
      const size_t items = (size_t)p.B * p.KH * p.nq * p.smax;
      p.ws[(size_t)blockIdx.x * kRows + tid] = sm.m[tid];
      p.ws[(items + blockIdx.x) * kRows + tid] = sm.l[tid];
    }
    return;
  }

  // ---- the P V warps: rows 8 prg + j, columns 4 (cg + 32 u) -------------
  const int ptid = tid - kGroup, pw = ptid >> 5;
  const int cg = (pw & 3) * 8 + (lane & 7);
  const int prg = (pw >> 2) * 4 + (lane >> 3);
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
  const T* vgl = static_cast<const T*>(p.v);
  const int total = ntiles * nvs;
  auto issue = [&](int m) {
    if (m < total) {
      const int t = m / nvs, v0 = (m % nvs) * kSlabV;
      const int k0 = (jb + t) * p.LK;
      const int dw = D / VEC;
      T* dst = sm.vring + (m % kStages) * kSlabV * ldv;
      for (int idx = ptid; idx < kSlabV * dw; idx += kGroup) {
        const int key = idx / dw, c = (idx - key * dw) * VEC;
        const int kt = v0 + key, kp = k0 + kt;
        const bool ok = kt < p.LK && kp < p.Skv;
        const T* src =
            ok ? vgl + (((size_t)b * p.Skv + kp) * p.KH + kh) * D + c : vgl;
        cp_async16(dst + key * ldv + c, src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int m = 0; m < kStages - 1; ++m) issue(m);
  int cur = 0;   // the V slab this group computes next
  auto next = [&]() -> const T* {
    cp_async_wait<kStages - 2>();
    bar_sync(kBarV, kGroup);
    issue(cur + kStages - 1);
    return sm.vring + (cur++ % kStages) * kSlabV * ldv;
  };

  float acc[8][4 * NC];      // f32: O; bf16 accumulator: this tile's P V
  uint32_t accb[8][2 * NC];  // bf16 accumulator: O, two bf16 a word
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NC; ++c) accb[j][c] = 0u;
  }
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int pb = t % npbuf;
    const float* P = sm.p + pb * pstride + 8 * prg;
    bar_sync(kBarFull + pb, kThreads);      // P and alpha of tile t
    float al[8];
    {
      const float4 a0 = ld4(sm.alpha + pb * kRows + 8 * prg);
      const float4 a1 = ld4(sm.alpha + pb * kRows + 8 * prg + 4);
      al[0] = a0.x; al[1] = a0.y; al[2] = a0.z; al[3] = a0.w;
      al[4] = a1.x; al[5] = a1.y; al[6] = a1.z; al[7] = a1.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c)
        acc[j][c] = BF16ACC ? 0.f : acc[j][c] * al[j];
#pragma unroll 1
    for (int vs = 0; vs < nvs; ++vs) {
      const T* vt = next();
      const float* ps = P + vs * kSlabV * kLdP;
#pragma unroll
      for (int kk = 0; kk < kSlabV; ++kk) {
        const float4 p0 = ld4(ps + kk * kLdP);
        const float4 p1 = ld4(ps + kk * kLdP + 4);
        const float pa[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float4 vv = ld4(vt + kk * ldv + vcol[u]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[j][4 * u] = fmaf(pa[j], vv.x, acc[j][4 * u]);
            acc[j][4 * u + 1] = fmaf(pa[j], vv.y, acc[j][4 * u + 1]);
            acc[j][4 * u + 2] = fmaf(pa[j], vv.z, acc[j][4 * u + 2]);
            acc[j][4 * u + 3] = fmaf(pa[j], vv.w, acc[j][4 * u + 3]);
          }
        }
      }
    }
    if (t + npbuf < ntiles) bar_arrive(kBarEmpty + pb, kThreads);
    if constexpr (BF16ACC) {   // acc = bf16(bf16(acc alpha) + bf16(P V))
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2 * NC; ++c) {
          __nv_bfloat162 o = *reinterpret_cast<__nv_bfloat162*>(&accb[j][c]);
          const float2 f = __bfloat1622float2(o);
          o = __floats2bfloat162_rn(
              bf16_round(bf16_round(f.x * al[j]) +
                         bf16_round(acc[j][2 * c])),
              bf16_round(bf16_round(f.y * al[j]) +
                         bf16_round(acc[j][2 * c + 1])));
          accb[j][c] = *reinterpret_cast<uint32_t*>(&o);
        }
    }
  }
  if constexpr (BF16ACC) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2 * NC; ++c) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<__nv_bfloat162*>(&accb[j][c]));
        acc[j][2 * c] = f.x;
        acc[j][2 * c + 1] = f.y;
      }
  }
  __syncthreads();   // the rows' (m, l) from the score warps
  if (ns > 1) {      // this item's partial acc, in f32
    const size_t items = (size_t)p.B * p.KH * p.nq * p.smax;
    float* wacc = p.ws + 2 * items * kRows + blockIdx.x * (size_t)kRows * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = 8 * prg + j;
#pragma unroll
      for (int u = 0; u < NC; ++u)
        if (colok[u])
          store4(wacc + (size_t)row * D + vcol[u],
                 make_float4(acc[j][4 * u], acc[j][4 * u + 1],
                             acc[j][4 * u + 2], acc[j][4 * u + 3]));
    }
    return;
  }
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = 8 * prg + j;
    const int g = row / p.BQ, qp = q0 + row % p.BQ;
    if (row >= R || qp >= p.Sq) continue;
    const float l = fmaxf(sm.l[row], 1e-30f);
    T* o = og + (((size_t)b * p.Sq + qp) * p.H + kh * G + g) * D;
#pragma unroll
    for (int u = 0; u < NC; ++u)
      if (colok[u])
        store4(o + vcol[u],
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
// floats where smax > 1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* ws,
    int is_bf16, int B, int Sq, int Skv, int H, int KH, int D, int nc, int bq,
    int lk, int T, int smax, int bf16_acc, float scale, int causal,
    int window, float softcap, void* stream) {
  if (KH <= 0 || H % KH || bq <= 0 || (H / KH) * bq > kRows || lk <= 0 ||
      lk > kMaxSub * kSub || (!bf16_acc && lk != kSub) || D <= 0 ||
      D > 128 * nc || D % 8 || Sq <= 0 || Skv <= 0 || B <= 0 || T <= 0)
    return -1;
  const int nq = (Sq + bq - 1) / bq;
  const int nsub = (lk + kSub - 1) / kSub, nt = (Skv + lk - 1) / lk;
  Params p{q, k, v, out, ws, B, Sq, Skv, H, KH, D, bq, lk, nsub, nq, nt, T,
           smax, scale, causal, window, softcap};
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
