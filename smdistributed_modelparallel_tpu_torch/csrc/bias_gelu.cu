// Fused bias + tanh-GELU, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_gelu.py
//   _fwd_kernel :54 -> bias_gelu_fwd_kernel
//   _bwd_kernel :59 -> bias_gelu_bwd_kernel
// launched by _call_rowwise (pl.pallas_call at :82) from bias_gelu's forward
// and its custom_vjp backward _bg_bwd (:112); the MLP's fc epilogue
// (nn/transformer.py, fused_bias_gelu). Python wrappers and plain PyTorch
// versions: smdistributed_modelparallel_tpu_torch/ops/bias_gelu.py.
//
// What they compute, for x [N, F] (fp32, fp16 or bf16), an fp32 bias b [F]
// and, in the backward, g [N, F] in x's dtype, with u = float(x) + b:
//   forward:  y = 0.5 u (1 + tanh(s (u + c u^3))) in x's dtype;
//   backward: dpre = g * (0.5 (1 + t) + 0.5 u (1 - t^2) s (1 + 3c u^2)) in
//             fp32, t = tanh(s (u + c u^3)),
// s = sqrt(2 / pi), c = 0.044715, evaluated in the TPU kernel's order
// (pallas_gelu._gelu_tanh / _dgelu_tanh, left to right). Every product and
// sum is __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs the
// reference does not do; tanhf may differ from the CPU's tanh by an ulp or
// two. dpre stays fp32 (as _bwd_kernel's jnp.float32 output): the caller sums
// it over rows for db before anything is rounded.
//
// Bound on an H100 (GPT-2 124M's MLP: N = 2048, F = 3072, bf16): an
// elementwise pass with ~10 (forward) and ~20 (backward) fp32 operations per
// element, far below the card's rate; it is bound by bytes: the forward reads
// x and writes y (25.2 MB, 7.5 us at 3.35 TB/s), the backward reads x and g
// and writes fp32 dpre (50.3 MB, 15.0 us).
//
// Design: a grid-stride pass, one element per thread per step; blockIdx.y
// walks rows and the threads of a block walk neighbouring columns, so loads
// and stores are coalesced and the bias column needs no division. The TPU's
// 256-row blocks do not carry over: no tile is staged. Not yet used: 16-byte
// vector loads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr float S2PI = (float)0.7978845608028654;    // sqrt(2 / pi), a double cast as Python's
constexpr float COEFF = (float)0.044715;
constexpr float COEFF3 = (float)(3.0 * 0.044715);    // 3.0 * _COEFF, folded in double as in Python

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// s * (u + c * u * u * u)
__device__ __forceinline__ float inner_of(float u) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(COEFF, u), u), u);
  return __fmul_rn(S2PI, __fadd_rn(u, cube));
}

template <typename E>
__global__ void __launch_bounds__(NT)
bias_gelu_fwd_kernel(const E* __restrict__ x, const float* __restrict__ b, E* __restrict__ y, int N,
                     int F) {
  for (long long r = blockIdx.y; r < N; r += gridDim.y) {
    for (int c = blockIdx.x * NT + threadIdx.x; c < F; c += gridDim.x * NT) {
      const long long e = r * F + c;
      const float u = __fadd_rn(to_f<E>(x[e]), b[c]);
      // 0.5 * u * (1 + tanh(inner))
      y[e] = from_f<E>(__fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, tanhf(inner_of(u)))));
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(NT)
bias_gelu_bwd_kernel(const E* __restrict__ x, const float* __restrict__ b, const E* __restrict__ g,
                     float* __restrict__ dpre, int N, int F) {
  for (long long r = blockIdx.y; r < N; r += gridDim.y) {
    for (int c = blockIdx.x * NT + threadIdx.x; c < F; c += gridDim.x * NT) {
      const long long e = r * F + c;
      const float u = __fadd_rn(to_f<E>(x[e]), b[c]);
      const float t = tanhf(inner_of(u));
      const float sech2 = __fsub_rn(1.f, __fmul_rn(t, t));
      // s * (1 + 3c * u * u)
      const float dinner = __fmul_rn(S2PI, __fadd_rn(1.f, __fmul_rn(__fmul_rn(COEFF3, u), u)));
      // 0.5 * (1 + t) + 0.5 * u * sech2 * dinner
      const float left = __fmul_rn(0.5f, __fadd_rn(1.f, t));
      const float right = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, u), sech2), dinner);
      dpre[e] = __fmul_rn(to_f<E>(g[e]), __fadd_rn(left, right));
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

dim3 grid_of(int N, int F) {
  const int cols = ceil_div(F, NT);
  return dim3(cols < 1024 ? cols : 1024, N < 65535 ? N : 65535);
}

template <typename E>
cudaError_t launch(int bwd, const void* x, const float* b, const void* g, void* out, int N, int F,
                   cudaStream_t s) {
  const dim3 grid = grid_of(N, F);
  if (bwd)
    bias_gelu_bwd_kernel<E><<<grid, NT, 0, s>>>(static_cast<const E*>(x), b, static_cast<const E*>(g),
                                                static_cast<float*>(out), N, F);
  else
    bias_gelu_fwd_kernel<E><<<grid, NT, 0, s>>>(static_cast<const E*>(x), b, static_cast<E*>(out), N, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 fp16, 2 bf16, of x (and g, and the forward's out). x [N, F],
// g [N, F] and out [N, F] are contiguous row-major; b is fp32 [F].
// bwd = 0: out = gelu(x + b) in x's dtype (g unused, may be null);
// bwd = 1: out = g * gelu'(x + b) in fp32. Returns a cudaError_t (0 = launched).
int smp_bias_gelu(int dtype, int bwd, const void* x, const float* b, const void* g, void* out, int N,
                  int F, void* stream) {
  if (N < 0 || F < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(bwd, x, b, g, out, N, F, s);
    case 1: return (int)launch<__half>(bwd, x, b, g, out, N, F, s);
    case 2: return (int)launch<__nv_bfloat16>(bwd, x, b, g, out, N, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
