// Matrix product with the bias in the epilogue, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_qkv.py
//   _mm_bias_kernel :54 -> matmul_bias_kernel
// launched by _matmul_bias_impl (:78, pl.pallas_call at :109), the forward of
// matmul_bias's custom_vjp; the attention layers' fused QKV projection
// (nn/transformer.py, fused_qkv). Python wrapper and plain PyTorch version:
// smdistributed_modelparallel_tpu_torch/ops/matmul_bias.py.
//
// What it computes, for x [N, D] and w [F, D] (one dtype: fp32, fp16 or bf16)
// and an optional fp32 bias b [F]:
//   y[r, c] = round_to_E( sum_d float(x[r, d]) * float(w[c, d])  +  b[c] )
// an fp32 sum, the bias added in fp32 once the sum is complete (__fadd_rn, so
// nvcc cannot fold it into the last FMA), one rounding to x's dtype. That is
// the TPU kernel's arithmetic: operands cast to fp32, an fp32 dot, the bias
// added in fp32, one cast. Products of bf16/fp16 values are exact in fp32, so
// y matches it up to the summation order. fp32 stays fp32: no TF32.
//
// Layout: w is the port's parameter as it holds it, an nn.Linear-style [F, D]
// weight (the JAX kernel's w [D, F] transposed), so this is an "NT" product:
// both operands are contiguous along D.
//
// Bound on an H100 (the fused QKV of GPT-2 124M: N = 2048, D = 768, F = 2304,
// bf16): 2 N D F = 7.25 GFLOP, 7.3 us at 989 TFLOP/s; it moves 16.1 MB (4.8 us
// at 3.35 TB/s), so it is operation-bound.
//
// Design, in its simplest right form (CUDA-core FMA, as csrc/fused_ce.cu's
// logit tiles): one CTA of 256 threads (16 x 16) per 64 x 64 output tile; each
// thread owns rows ty + 16i and columns tx + 16j (i, j < 4). D streams through
// shared memory 32 columns at a time, staged as fp32, so every D runs; rows
// >= N, columns >= F and d >= D load as 0 and are not stored. The TPU's
// (256, 512) blocks and 12 MiB VMEM budget do not carry over: any D runs here.
// Not yet used: mma.sync / wgmma, TMA, cp.async pipelining. This kernel runs
// on the CUDA cores, far from its bound; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per CTA (16 x 16)
constexpr int BT = 64;       // output tile: 64 rows x 64 columns
constexpr int KC = 32;       // D columns per step
constexpr int LDK = KC + 4;  // row stride of the operand tiles (floats)

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

// Grid (row tiles, column tiles).
template <typename E>
__global__ void __launch_bounds__(NT)
matmul_bias_kernel(const E* __restrict__ x, const E* __restrict__ w, const float* __restrict__ b,
                   E* __restrict__ y, int N, int D, int F) {
  __shared__ __align__(16) float sA[BT * LDK];
  __shared__ __align__(16) float sB[BT * LDK];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BT, c0 = blockIdx.y * BT;

  float z[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the previous operand tiles are no longer read
    for (int e = threadIdx.x; e < BT * KC; e += NT) {
      const int rr = e / KC, kk = e % KC, k = k0 + kk;
      const int r = r0 + rr, c = c0 + rr;
      sA[rr * LDK + kk] = (r < N && k < D) ? to_f<E>(x[(long long)r * D + k]) : 0.f;
      sB[rr * LDK + kk] = (c < F && k < D) ? to_f<E>(w[(long long)c * D + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&sA[(ty + 16 * i) * LDK + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = *reinterpret_cast<const float4*>(&sB[(tx + 16 * j) * LDK + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[i][j] = fmaf(a[i].x, bb[j].x, z[i][j]);
          z[i][j] = fmaf(a[i].y, bb[j].y, z[i][j]);
          z[i][j] = fmaf(a[i].z, bb[j].z, z[i][j]);
          z[i][j] = fmaf(a[i].w, bb[j].w, z[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= F) continue;
      const float v = b ? __fadd_rn(z[i][j], b[c]) : z[i][j];
      y[(long long)r * F + c] = from_f<E>(v);
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename E>
cudaError_t launch(const void* x, const void* w, const float* b, void* y, int N, int D, int F,
                   cudaStream_t s) {
  const dim3 grid(ceil_div(N, BT), ceil_div(F, BT));
  matmul_bias_kernel<E><<<grid, NT, 0, s>>>(static_cast<const E*>(x), static_cast<const E*>(w), b,
                                            static_cast<E*>(y), N, D, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 fp16, 2 bf16, shared by x, w and y. x [N, D], w [F, D] and
// y [N, F] are contiguous row-major; b is an fp32 [F] bias or null. Returns a
// cudaError_t (0 = launched).
int smp_matmul_bias(int dtype, const void* x, const void* w, const float* b, void* y, int N, int D,
                    int F, void* stream) {
  if (N < 0 || D < 0 || F < 0 || ceil_div(F, BT) > 65535) return (int)cudaErrorInvalidValue;
  if (N == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, w, b, y, N, D, F, s);
    case 1: return (int)launch<__half>(x, w, b, y, N, D, F, s);
    case 2: return (int)launch<__nv_bfloat16>(x, w, b, y, N, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
