// Matrix product of two fp8 (e4m3) operands into fp32, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_qkv.py
//   _mm_fp8_kernel :162 -> matmul_fp8_kernel
// launched by matmul_bias_fp8 (:171, pl.pallas_call at :194), the fp8 rung of
// the fused QKV projection under matmul_precision: fp8 (quant._fp8_mm2d with
// use_pallas=True, called from nn/transformer.py's fused QKV). Python wrapper
// and plain PyTorch version:
// smdistributed_modelparallel_tpu_torch/ops/matmul_fp8.py.
//
// What it computes, for x8 [N, D] and w8 [F, D], both float8_e4m3fn:
//   y[r, c] = sum_d float(x8[r, d]) * float(w8[c, d])        (fp32, [N, F])
// No scale and no bias: the delayed-scaling dequant multiply and the bias stay
// in the caller's epilogue (quant._fp8_mm2d), as they stay in XLA's on the TPU.
// Every e4m3 value is exact in fp32 and so is the product of two of them (4 +
// 4 significant bits), so the kernel differs from its plain version only by
// the order of the fp32 sums. fp32 FMA only: no TF32, no fp8 tensor-core
// accumulation (which keeps fewer bits than fp32).
//
// Layout: w8 is the port's parameter as it holds it, an nn.Linear-style
// [F, D] weight (the JAX kernel's w8 [D, F] transposed); both operands are
// contiguous along D (K-major), the one layout fp8 wgmma accepts, so a later
// tensor-core version keeps this contract.
//
// Bound on an H100 (the fused QKV of GPT-2 124M: N = 2048, D = 768, F =
// 2304): 2 N D F = 7.25 GFLOP, 3.7 us at 1,979 TFLOP/s fp8; it moves 1.57 MB
// of x8, 1.77 MB of w8 and 18.9 MB of fp32 y, 22.2 MB or 6.6 us at 3.35 TB/s,
// so it is bound by bytes (the fp32 output).
//
// Design, in its simplest right form (csrc/matmul_bias.cu's, CUDA-core FMA):
// one CTA of 256 threads (16 x 16) per 64 x 64 output tile; each thread owns
// rows ty + 16i and columns tx + 16j (i, j < 4). D streams through shared
// memory 64 bytes at a time: each thread loads one 16-byte segment of x8 and
// one of w8 (a plain byte loop where D is not a multiple of 16 or a pointer is
// not 16-byte aligned), widens the 16 e4m3 values exactly to fp32 (e4m3 ->
// half -> float, cuda_fp8.h) and stores them, so each value is converted once
// per tile and not once per use. Rows >= N, columns >= F and d >= D load as 0
// and are not stored, so any N, D and F run. Not yet used: mma.sync / wgmma
// e4m3 with partial sums promoted into fp32 registers, TMA, cp.async.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per CTA (16 x 16)
constexpr int BT = 64;       // output tile: 64 rows x 64 columns
constexpr int KC = 64;       // D columns (bytes) per step
constexpr int LDK = KC + 4;  // row stride of the staged tiles (floats)

// Two e4m3 bytes -> two floats, exactly.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint16_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(v), __NV_E4M3);
  return __half22float2(__half2(h));
}

// Widen 16 e4m3 bytes (four 32-bit words) into dst[0..15].
__device__ __forceinline__ void widen16(const uint32_t (&u)[4], float* dst) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 lo = e4m3x2_to_float2(static_cast<uint16_t>(u[q] & 0xffffu));
    const float2 hi = e4m3x2_to_float2(static_cast<uint16_t>(u[q] >> 16));
    *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

// The 16 bytes of row r at columns k .. k + 15 (zero where r >= rows or
// column >= D). VEC: D % 16 == 0 and the base is 16-byte aligned, so a
// segment is either wholly inside the row or wholly past its end.
template <bool VEC>
__device__ __forceinline__ void load16(const uint8_t* __restrict__ a, int r, int rows, int k, int D,
                                       uint32_t (&u)[4]) {
  if (VEC) {
    if (r < rows && k < D) {
      const uint4 v = *reinterpret_cast<const uint4*>(a + (long long)r * D + k);
      u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
    } else {
      u[0] = u[1] = u[2] = u[3] = 0u;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k + 4 * q + e;
      const uint32_t byte = (r < rows && kk < D) ? a[(long long)r * D + kk] : 0u;
      word |= byte << (8 * e);
    }
    u[q] = word;
  }
}

// Grid (row tiles, column tiles).
template <bool VEC>
__global__ void __launch_bounds__(NT)
matmul_fp8_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w, float* __restrict__ y, int N,
                  int D, int F) {
  __shared__ __align__(16) float sA[BT * LDK];
  __shared__ __align__(16) float sB[BT * LDK];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BT, c0 = blockIdx.y * BT;
  // This thread's staging segment: tile row srow, columns sseg*16 .. +15.
  const int srow = threadIdx.x >> 2, sseg = threadIdx.x & 3;

  float z[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KC) {
    uint32_t ua[4], ub[4];
    load16<VEC>(x, r0 + srow, N, k0 + 16 * sseg, D, ua);
    load16<VEC>(w, c0 + srow, F, k0 + 16 * sseg, D, ub);
    __syncthreads();  // the previous tiles are no longer read
    widen16(ua, &sA[srow * LDK + 16 * sseg]);
    widen16(ub, &sB[srow * LDK + 16 * sseg]);
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
      if (c < F) y[(long long)r * F + c] = z[i][j];
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// x8 [N, D] and w8 [F, D] are contiguous row-major float8_e4m3fn (one byte
// each), y [N, F] contiguous fp32. Returns a cudaError_t (0 = launched).
int smp_matmul_fp8(const void* x8, const void* w8, float* y, int N, int D, int F, void* stream) {
  if (N < 0 || D < 0 || F < 0 || ceil_div(F, BT) > 65535) return (int)cudaErrorInvalidValue;
  if (N == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ceil_div(N, BT), ceil_div(F, BT));
  const bool vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(x8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w8) % 16 == 0;
  const uint8_t* x = static_cast<const uint8_t*>(x8);
  const uint8_t* w = static_cast<const uint8_t*>(w8);
  if (vec) {
    matmul_fp8_kernel<true><<<grid, NT, 0, s>>>(x, w, y, N, D, F);
  } else {
    matmul_fp8_kernel<false><<<grid, NT, 0, s>>>(x, w, y, N, D, F);
  }
  return (int)cudaGetLastError();
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
