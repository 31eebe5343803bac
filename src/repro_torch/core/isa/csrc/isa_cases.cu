// The isa_mapping experiment's cases (the paper's Table V): one kernel per
// op class of the reference's ISA_CASES, each computing the same function
// over a 64 x 64 f32 input x (row-major), plus the plain copy y = x, the
// scaffold every case shares (its index, guard, load and store), whose
// SASS the experiment subtracts to read what each op became.
//
// Built twice from this one text with the same flags: ``nvcc -ptx`` (the
// PTX the experiment counts as the source side) and the shared library
// whose ``cuobjdump -sass`` is the optimized side.  No --use_fast_math:
// every case keeps the IEEE or documented-ulp form of its op.
//
// Each kernel has an extern "C" launcher, launch_isa_<case>(x, y, stream),
// returning the launch's cudaError_t, for a value check through ctypes.
#include <cuda_runtime.h>

#define N 64

// ---- the scaffold: one thread an element --------------------------------
extern "C" __global__ void isa_copy(const float* __restrict__ x,
                                    float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = x[i];
}

// ---- one op an element -----------------------------------------------------
extern "C" __global__ void isa_add_f32(const float* __restrict__ x,
                                       float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = x[i] + 1.0f;  // case add.f32
}

extern "C" __global__ void isa_mul_f32(const float* __restrict__ x,
                                       float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = x[i] * 1.5f;  // case mul.f32
}

extern "C" __global__ void isa_fma_f32(const float* __restrict__ x,
                                       float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = x[i] * 1.5f + 2.0f;  // case fma.f32
}

extern "C" __global__ void isa_div_f32(const float* __restrict__ x,
                                       float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = x[i] / 1.5f;  // case div.f32
}

extern "C" __global__ void isa_rsqrt_f32(const float* __restrict__ x,
                                         float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = rsqrtf(fabsf(x[i]) + 1e-3f);  // case rsqrt.f32
}

extern "C" __global__ void isa_exp_f32(const float* __restrict__ x,
                                       float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = expf(x[i] * 1e-3f);  // case exp.f32
}

extern "C" __global__ void isa_tanh_f32(const float* __restrict__ x,
                                        float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N * N) y[i] = tanhf(x[i]);  // case tanh.f32
}

// ---- eight dependent multiplies an element (lax.scan of c * 1.01) -------
extern "C" __global__ void isa_scan8(const float* __restrict__ x,
                                     float* __restrict__ y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N * N) return;
    float c = x[i];
#pragma unroll
    for (int s = 0; s < 8; ++s) c = c * 1.01f;
    y[i] = c;
}

// ---- one thread a row ------------------------------------------------------
extern "C" __global__ void isa_softmax_f32(const float* __restrict__ x,
                                           float* __restrict__ y) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= N) return;
    const float* row = x + r * N;
    float m = row[0];
    for (int c = 1; c < N; ++c) m = fmaxf(m, row[c]);
    float s = 0.0f;
    for (int c = 0; c < N; ++c) s += expf(row[c] - m);
    for (int c = 0; c < N; ++c) y[r * N + c] = expf(row[c] - m) / s;
}

extern "C" __global__ void isa_reduce_f32(const float* __restrict__ x,
                                          float* __restrict__ y) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= N) return;
    float s = 0.0f;
    for (int c = 0; c < N; ++c) s += x[r * N + c];
    y[r] = s;
}

// ---- one thread an output element ----------------------------------------
// y = x @ x.T: y[i, j] = sum_k x[i, k] * x[j, k]
extern "C" __global__ void isa_matmul_f32(const float* __restrict__ x,
                                          float* __restrict__ y) {
    int o = blockIdx.x * blockDim.x + threadIdx.x;
    if (o >= N * N) return;
    int i = o / N, j = o % N;
    float s = 0.0f;
    for (int k = 0; k < N; ++k) s = fmaf(x[i * N + k], x[j * N + k], s);
    y[o] = s;
}

// y = x[arange(8) % 64]: an [8, 64] gather of rows
extern "C" __global__ void isa_gather(const float* __restrict__ x,
                                      float* __restrict__ y) {
    int o = blockIdx.x * blockDim.x + threadIdx.x;
    if (o >= 8 * N) return;
    int r = (o / N) % N, c = o % N;
    y[o] = x[r * N + c];
}

// ---- launchers --------------------------------------------------------------
#define LAUNCHER(name, threads)                                              \
    extern "C" int launch_##name(const float* x, float* y, void* stream) {   \
        int n = (threads);                                                   \
        name<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y);       \
        return (int)cudaGetLastError();                                      \
    }

LAUNCHER(isa_copy, N * N)
LAUNCHER(isa_add_f32, N * N)
LAUNCHER(isa_mul_f32, N * N)
LAUNCHER(isa_fma_f32, N * N)
LAUNCHER(isa_div_f32, N * N)
LAUNCHER(isa_rsqrt_f32, N * N)
LAUNCHER(isa_exp_f32, N * N)
LAUNCHER(isa_tanh_f32, N * N)
LAUNCHER(isa_scan8, N * N)
LAUNCHER(isa_softmax_f32, N)
LAUNCHER(isa_reduce_f32, N)
LAUNCHER(isa_matmul_f32, N * N)
LAUNCHER(isa_gather, 8 * N)
