// ALU-chain probe for Hopper (sm_90a), bound through a plain C interface
// (ctypes) by repro_torch/kernels/alu_chain.py.
//
// Replaces the TPU Pallas kernel `alu_chain` (`_alu_kernel`) of
// repro/kernels/microbench_alu.py: the paper's Fig. 1 / Tables I-II body
// (clock; op; op; ...; clock).  It computes, on one (8,128) tile with one
// element per thread, a `length`-long chain of one elementwise op with a
// scalar `c`:
//   dependent:   y <- f(y, c), `length` times, from y = x (latency);
//   independent: out = f(x + 0, c); out <- out + f(x + i, c) * 0 for
//                i = 1..length-1 (throughput; the `out + y*0` tail of the
//                reference stays, so every f stays live).
// Ops: the harness's 21 (`repro.core.microbench.harness.OPS`), in f32, bf16
// and int32 where the harness runs them.  `length` is a run-time argument:
// an unrolled chain of 8 inside a counted loop, so one build serves every
// length.  Thread 0 writes the chain's clock64() cycles and %globaltimer ns
// (`timing[0]`, `timing[1]`); the host regresses cycles over lengths, which
// is the paper's clock-overhead subtraction.  The tile's 1024 threads run
// as 32 blocks of one warp, which the card spreads over its SMs: a warp
// alone on its SM sees the op's latency, as the paper's single-warp timing
// does, where 32 warps on one SM would queue at its 4 schedulers.
//
// What is timed, per op (f32): add/sub/mul -> FADD/FMUL (`.rn`, never
// contracted); fma -> one FFMA (the reference rounds y*c and +c apart: a
// last-bit difference); max/min/abs/select -> FMNMX/FADD|.|/FSETP+FSEL;
// div -> the IEEE div.rn.f32 sequence; rem -> fmodf with jnp's floor-mod
// sign fix.  The MUFU-class ops use the instructions the paper times, each
// an approximation: exp -> ex2.approx (of y*0.001*log2 e), log -> lg2.approx
// (times ln 2), sin -> sin.approx, tanh -> tanh.approx (relative error
// 2^-11), rsqrt -> rsqrt.approx, sqrt -> sqrt.approx, sigmoid -> ex2.approx
// and rcp.approx.  bf16: add/sub/mul/fma/max/min run natively (HADD2/HMUL2/
// HFMA2/HMNMX2 .BF16); the other ops compute in f32 and round to bf16 where
// PyTorch does: after every op, and inside rsqrt/exp/log after their first
// step (|y| + 1e-6, y * 0.001, |y| + 1).  int32: IADD3/IMAD/IMNMX/LOP3/POPC/FLO/...
//
// Against folding: `c` comes from memory in two registers that alternate
// along the chain (an idempotent op such as max(max(y,c),c) cannot collapse),
// the zero of `y*0` and `c*0` comes from memory too, and an empty
// `asm volatile` on y after every op stops the compiler from reassociating
// or hoisting the chain past the clock reads.  ptxas still fuses two
// dependent integer adds or bitwise ops into one three-input IADD3/LOP3
// (and collapses an and/xor chain over two constants to one LOP3); so a
// dependent chain also folds every intermediate into a side word with an
// op of another class (xor, or add for the bitwise ops), which each
// intermediate must then exist for.  The side word is off the chain and
// costs an issue slot, not latency.  The independent chain's `x + i` uses
// a float counter (one FADD), not an I2F conversion per op.
//
// Bound: operations.  1024 elements x `length` ops; the bytes (x read once,
// the output written once: 8 KB in f32) are a few ns at 3.35 TB/s, so the
// least time is the op count over the card's scalar rate (67 TFLOP/s f32).
// The chain runs one warp per SM by design: it measures latency, not rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// op ids: the order of repro_torch/kernels/alu_chain.py's OP_IDS
enum Op {
  ADD, SUB, MUL, FMA, MAX, MIN, ABS, AND, XOR, POPC, CLZ, DIV, REM, RSQRT,
  SQRT, EXP, LOG, SIN, TANH, SIGMOID, SELECT
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void keep(float& y) { asm volatile("" : "+f"(y)); }
__device__ __forceinline__ void keep(int& y) { asm volatile("" : "+r"(y)); }
__device__ __forceinline__ void keep(bf16& y) {
  unsigned short u = __bfloat16_as_ushort(y);
  asm volatile("" : "+h"(u));
  y = __ushort_as_bfloat16(u);
}

__device__ __forceinline__ float ex2(float a) {
  float r;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float lg2(float a) {
  float r;
  asm volatile("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float sin_approx(float a) {
  float r;
  asm volatile("sin.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float tanh_approx(float a) {
  float r;
  asm volatile("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float rsqrt_approx(float a) {
  float r;
  asm volatile("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float sqrt_approx(float a) {
  float r;
  asm volatile("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// one op in f32; `z` is a zero read from memory
template <int OP>
__device__ __forceinline__ float apply_f32(float y, float c, float z) {
  switch (OP) {
    case ADD: return __fadd_rn(y, c);
    case SUB: return __fsub_rn(y, c);
    case MUL: return __fmul_rn(y, c);
    case FMA: return __fmaf_rn(y, c, c);
    case MAX: return fmaxf(y, c);
    case MIN: return fminf(y, c);
    case ABS: return __fadd_rn(fabsf(y), __fmul_rn(c, z));
    case DIV: return __fdiv_rn(y, c);
    case REM: {
      float m = fmodf(y, c);
      return (m != 0.f && ((m < 0.f) != (c < 0.f))) ? m + c : m;
    }
    case RSQRT:
      return rsqrt_approx(__fadd_rn(__fadd_rn(fabsf(y), __fmul_rn(c, z)),
                                    1e-6f));
    case SQRT: return __fadd_rn(sqrt_approx(fabsf(y)), __fmul_rn(c, z));
    case EXP:
      return __fadd_rn(ex2(__fmul_rn(__fmul_rn(y, 0.001f), kLog2e)),
                       __fmul_rn(c, z));
    case LOG:
      return __fadd_rn(__fmul_rn(lg2(__fadd_rn(fabsf(y), 1.f)), kLn2),
                       __fmul_rn(c, z));
    case SIN: return __fadd_rn(sin_approx(y), __fmul_rn(c, z));
    case TANH: return __fadd_rn(tanh_approx(y), __fmul_rn(c, z));
    case SIGMOID:
      return __fadd_rn(rcp_approx(__fadd_rn(1.f, ex2(__fmul_rn(-y, kLog2e)))),
                       __fmul_rn(c, z));
    case SELECT: return y > c ? y : c;
    default: return y;
  }
}

template <int OP>
__device__ __forceinline__ int apply_i32(int y, int c, int z) {
  switch (OP) {
    case ADD: return y + c;
    case SUB: return y - c;
    case MUL: return y * c;
    case MAX: return max(y, c);
    case MIN: return min(y, c);
    case ABS: return abs(y) + c * z;
    case AND: return y & c;
    case XOR: return y ^ c;
    case POPC: return __popc(y) + c * z;
    case CLZ: return __clz(y) + c * z;
    case REM: {
      int m = y % c;
      return (m != 0 && ((m < 0) != (c < 0))) ? m + c : m;
    }
    case SELECT: return y > c ? y : c;
    default: return y;
  }
}

// round an f32 value to bf16 and back: where PyTorch (and jnp) round a
// bf16 op's intermediate result
__device__ __forceinline__ float rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int OP>
__device__ __forceinline__ bf16 apply_bf16(bf16 y, bf16 c, bf16 z) {
  const float yf = __bfloat162float(y);
  switch (OP) {
    case ADD: return __hadd(y, c);
    case SUB: return __hsub(y, c);
    case MUL: return __hmul(y, c);
    case FMA: return __hfma(y, c, c);
    case MAX: return __hmax(y, c);
    case MIN: return __hmin(y, c);
    case SELECT: return __hgt(y, c) ? y : c;
    // the composite ops round their inner step as the plain version does
    // (`+ c*0` adds an exact zero)
    case RSQRT:
      return __float2bfloat16_rn(rsqrt_approx(rn(fabsf(yf) + 1e-6f)));
    case EXP:
      return __float2bfloat16_rn(ex2(__fmul_rn(rn(yf * 0.001f), kLog2e)));
    case LOG:
      return __float2bfloat16_rn(__fmul_rn(lg2(rn(fabsf(yf) + 1.f)), kLn2));
    default:
      return __float2bfloat16_rn(
          apply_f32<OP>(yf, __bfloat162float(c), __bfloat162float(z)));
  }
}

template <typename T>
struct Ops;
template <>
struct Ops<float> {
  typedef float Count;
  template <int OP>
  static __device__ __forceinline__ float f(float y, float c, float z) {
    return apply_f32<OP>(y, c, z);
  }
  static __device__ __forceinline__ unsigned bits(float y) {
    return __float_as_uint(y);
  }
  static __device__ __forceinline__ float plus(float x, float i) {
    return __fadd_rn(x, i);
  }
  static __device__ __forceinline__ float tail(float out, float y, float z) {
    return __fadd_rn(out, __fmul_rn(y, z));
  }
};
template <>
struct Ops<int> {
  typedef int Count;
  template <int OP>
  static __device__ __forceinline__ int f(int y, int c, int z) {
    return apply_i32<OP>(y, c, z);
  }
  static __device__ __forceinline__ unsigned bits(int y) {
    return static_cast<unsigned>(y);
  }
  static __device__ __forceinline__ int plus(int x, int i) { return x + i; }
  static __device__ __forceinline__ int tail(int out, int y, int z) {
    return out + y * z;
  }
};
template <>
struct Ops<bf16> {
  typedef float Count;
  template <int OP>
  static __device__ __forceinline__ bf16 f(bf16 y, bf16 c, bf16 z) {
    return apply_bf16<OP>(y, c, z);
  }
  static __device__ __forceinline__ unsigned bits(bf16 y) {
    return __bfloat16_as_ushort(y);
  }
  static __device__ __forceinline__ bf16 plus(bf16 x, float i) {
    return __float2bfloat16_rn(__bfloat162float(x) + i);
  }
  static __device__ __forceinline__ bf16 tail(bf16 out, bf16 y, bf16 z) {
    return __hadd(out, __hmul(y, z));
  }
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int kUnroll = 8;

// the side word's op: of another instruction class than the chain's op
template <int OP>
__device__ __forceinline__ unsigned side_op(unsigned side, unsigned b) {
  return (OP == AND || OP == XOR) ? side + b : side ^ b;
}

// cbuf = {c, c, 0} in T: two copies of c that alternate, and a zero
constexpr int kWarps = 32;   // the (8,128) tile: one warp per block

template <typename T, int OP>
__global__ void __launch_bounds__(32)
    alu_chain_kernel(const T* __restrict__ x, const T* __restrict__ cbuf,
                     T* __restrict__ out, int length, int dependent,
                     long long* __restrict__ timing) {
  const int t = blockIdx.x * 32 + threadIdx.x;
  const T c0 = cbuf[0], c1 = cbuf[1], z = cbuf[2];
  const T xv = x[t];
  T res;
  __syncwarp();
  const unsigned long long g0 = globaltimer();
  const long long t0 = clock64();
  unsigned side = 0;
  if (dependent) {
    T y = xv;
    keep(y);
    int k = 0;
    for (; k + kUnroll <= length; k += kUnroll) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        y = Ops<T>::template f<OP>(y, (j & 1) ? c1 : c0, z);
        keep(y);
        side = side_op<OP>(side, Ops<T>::bits(y));
      }
    }
#pragma unroll 1
    for (; k < length; ++k) {
      y = Ops<T>::template f<OP>(y, c0, z);
      keep(y);
      side = side_op<OP>(side, Ops<T>::bits(y));
    }
    res = y;
  } else {
    typedef typename Ops<T>::Count Count;
    T acc = Ops<T>::template f<OP>(Ops<T>::plus(xv, Count(0)), c0, z);
    keep(acc);
    Count ci = Count(1);
    int i = 1;
    for (; i + kUnroll <= length; i += kUnroll) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        T y = Ops<T>::template f<OP>(Ops<T>::plus(xv, ci), (j & 1) ? c1 : c0,
                                      z);
        ci = ci + Count(1);
        acc = Ops<T>::tail(acc, y, z);
      }
      keep(acc);
    }
#pragma unroll 1
    for (; i < length; ++i) {
      T y = Ops<T>::template f<OP>(Ops<T>::plus(xv, ci), c0, z);
      ci = ci + Count(1);
      acc = Ops<T>::tail(acc, y, z);
      keep(acc);
    }
    res = acc;
  }
  const long long t1 = clock64();
  const unsigned long long g1 = globaltimer();
  // the side word must exist: it lands in `timing` only for length < 0,
  // which the host refuses
  if (length < 0 && timing != nullptr) timing[2] = side;
  out[t] = res;
  if (t == 0 && timing != nullptr) {  // block 0, lane 0
    timing[0] = t1 - t0;
    timing[1] = static_cast<long long>(g1 - g0);
  }
}

template <typename T, int OP>
int launch(const void* x, const void* cbuf, void* out, int length,
           int dependent, long long* timing, cudaStream_t s) {
  alu_chain_kernel<T, OP><<<kWarps, 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(cbuf),
      static_cast<T*>(out), length, dependent, timing);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_float(int op, const void* x, const void* c, void* out, int n,
                   int dep, long long* tm, cudaStream_t s) {
  switch (op) {
    case ADD: return launch<T, ADD>(x, c, out, n, dep, tm, s);
    case SUB: return launch<T, SUB>(x, c, out, n, dep, tm, s);
    case MUL: return launch<T, MUL>(x, c, out, n, dep, tm, s);
    case FMA: return launch<T, FMA>(x, c, out, n, dep, tm, s);
    case MAX: return launch<T, MAX>(x, c, out, n, dep, tm, s);
    case MIN: return launch<T, MIN>(x, c, out, n, dep, tm, s);
    case ABS: return launch<T, ABS>(x, c, out, n, dep, tm, s);
    case DIV: return launch<T, DIV>(x, c, out, n, dep, tm, s);
    case REM: return launch<T, REM>(x, c, out, n, dep, tm, s);
    case RSQRT: return launch<T, RSQRT>(x, c, out, n, dep, tm, s);
    case SQRT: return launch<T, SQRT>(x, c, out, n, dep, tm, s);
    case EXP: return launch<T, EXP>(x, c, out, n, dep, tm, s);
    case LOG: return launch<T, LOG>(x, c, out, n, dep, tm, s);
    case SIN: return launch<T, SIN>(x, c, out, n, dep, tm, s);
    case TANH: return launch<T, TANH>(x, c, out, n, dep, tm, s);
    case SIGMOID: return launch<T, SIGMOID>(x, c, out, n, dep, tm, s);
    case SELECT: return launch<T, SELECT>(x, c, out, n, dep, tm, s);
    default: return -2;
  }
}

int dispatch_int(int op, const void* x, const void* c, void* out, int n,
                 int dep, long long* tm, cudaStream_t s) {
  switch (op) {
    case ADD: return launch<int, ADD>(x, c, out, n, dep, tm, s);
    case SUB: return launch<int, SUB>(x, c, out, n, dep, tm, s);
    case MUL: return launch<int, MUL>(x, c, out, n, dep, tm, s);
    case MAX: return launch<int, MAX>(x, c, out, n, dep, tm, s);
    case MIN: return launch<int, MIN>(x, c, out, n, dep, tm, s);
    case ABS: return launch<int, ABS>(x, c, out, n, dep, tm, s);
    case AND: return launch<int, AND>(x, c, out, n, dep, tm, s);
    case XOR: return launch<int, XOR>(x, c, out, n, dep, tm, s);
    case POPC: return launch<int, POPC>(x, c, out, n, dep, tm, s);
    case CLZ: return launch<int, CLZ>(x, c, out, n, dep, tm, s);
    case REM: return launch<int, REM>(x, c, out, n, dep, tm, s);
    case SELECT: return launch<int, SELECT>(x, c, out, n, dep, tm, s);
    default: return -2;
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 int32.  x, out: 1024 elements; cbuf: {c, c, 0}.
// timing: NULL or 2 int64 (cycles, ns).  Returns 0 or a CUDA error code
// (-1: bad arguments, -2: op not defined for the dtype).
extern "C" int alu_chain_launch(int op, int dtype, int dependent,
                                const void* x, const void* cbuf, void* out,
                                int length, long long* timing, void* stream) {
  if (length <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_float<float>(op, x, cbuf, out, length, dependent,
                                         timing, s);
    case 1: return dispatch_float<bf16>(op, x, cbuf, out, length, dependent,
                                        timing, s);
    case 2: return dispatch_int(op, x, cbuf, out, length, dependent, timing,
                                s);
    default: return -1;
  }
}
