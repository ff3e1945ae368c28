// Matrix product with the bias in the epilogue, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_qkv.py
//   _mm_bias_kernel :54 -> matmul_bias_wgmma_kernel (bf16, fp16) and
//                          matmul_bias_kernel (the CUDA-core route)
// launched by _matmul_bias_impl (:78, pl.pallas_call at :109), the forward of
// matmul_bias's custom_vjp; the attention layers' fused QKV projection
// (nn/transformer.py, fused_qkv). Python wrapper and plain PyTorch version:
// smdistributed_modelparallel_tpu_torch/ops/matmul_bias.py, whose _route picks
// the kernel by the operands alone: bf16 and fp16 operands with 16-byte rows
// and bases take the tensor cores, the rest (fp32, or a D or pointer that TMA
// cannot take) the CUDA cores. Neither route stands in for the other.
//
// What it computes, for x [N, D] and w [F, D] (one dtype: fp32, fp16 or bf16)
// and an optional bias b [F] (fp32 or x's dtype, read as it is and widened to
// fp32 exactly, so the wrapper casts nothing per call):
//   y[r, c] = round_to_E( sum_d float(x[r, d]) * float(w[c, d])  +  b[c] )
// an fp32 sum, the bias added in fp32 once the sum is complete (__fadd_rn, so
// nvcc cannot fold it into the last FMA), one rounding to x's dtype. That is
// the TPU kernel's arithmetic: operands cast to fp32, an fp32 dot, the bias
// added in fp32, one cast. Products of bf16/fp16 values are exact in fp32, so
// y matches it up to the summation order. fp32 stays fp32: no TF32 (which is
// why fp32 operands keep the CUDA-core kernel).
//
// Layout: w is the port's parameter as it holds it, an nn.Linear-style [F, D]
// weight (the JAX kernel's w [D, F] transposed), so this is an "NT" product:
// both operands are contiguous along D, the K-major layout wgmma reads.
//
// Bound on an H100 (the fused QKV of GPT-2 124M: N = 2048, D = 768, F = 2304,
// bf16): 2 N D F = 7.25 GFLOP, 7.3 us at 989 TFLOP/s; it moves 16.1 MB (4.8 us
// at 3.35 TB/s), so it is operation-bound.
//
// Tensor-core route (matmul_bias_wgmma_kernel, csrc/tma_wgmma.cuh's shape):
// a persistent grid over 128 x 288 output tiles (two wgmma n = 144 blocks; the
// fused QKV's output is 128 tiles, one round over 132 SMs), one producer
// thread keeping 3 stages of TMA loads (x [128, 64] and w [2 x 144, 64],
// 128-byte swizzle) in flight, two consumer warpgroups issuing wgmma
// m64n144k16 with fp32 accumulators; the epilogue adds the bias, rounds once,
// stages the tile in shared memory and writes 16-byte stores while the
// producer loads the next tile. Rows >= N, columns >= F and d >= D arrive from
// TMA as zeros and are not stored, so any N and F run. At the fused QKV's
// shape the CTAs read ~82 MB of operands through L2 (each x row block 8 times,
// each w row block 16 times); TMA multicast across a cluster would read each
// w tile once per cluster.
//
// CUDA-core route (matmul_bias_kernel, the simplest right form): one CTA of
// 256 threads (16 x 16) per 64 x 64 output tile; each thread owns rows ty +
// 16i and columns tx + 16j (i, j < 4). D streams through shared memory 32
// columns at a time, staged as fp32, so every D runs; rows >= N, columns >= F
// and d >= D load as 0 and are not stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

constexpr int NT = 256;      // threads per CTA (16 x 16)
constexpr int BT = 64;       // output tile: 64 rows x 64 columns
constexpr int KC = 32;       // D columns per step
constexpr int LDK = KC + 4;  // row stride of the operand tiles (floats)

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Grid (row tiles, column tiles). B, the bias's type: fp32 or E.
template <typename E, typename B>
__global__ void __launch_bounds__(NT)
matmul_bias_kernel(const E* __restrict__ x, const E* __restrict__ w, const B* __restrict__ b, E* __restrict__ y,
                   int N, int D, int F) {
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
      sA[rr * LDK + kk] = (r < N && k < D) ? smp_tc::to_f32(x[(long long)r * D + k]) : 0.f;
      sB[rr * LDK + kk] = (c < F && k < D) ? smp_tc::to_f32(w[(long long)c * D + k]) : 0.f;
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
      const float v = b ? __fadd_rn(z[i][j], smp_tc::to_f32(b[c])) : z[i][j];
      y[(long long)r * F + c] = from_f<E>(v);
    }
  }
}

template <typename E> __device__ __forceinline__ void wgmma_e(float (&d)[smp_tc::ACC], uint64_t da, uint64_t db,
                                                            int scale_d);
template <> __device__ __forceinline__ void wgmma_e<__nv_bfloat16>(float (&d)[smp_tc::ACC], uint64_t da, uint64_t db,
                                                                  int scale_d) {
  smp_tc::wgmma_bf16(d, da, db, scale_d);
}
template <> __device__ __forceinline__ void wgmma_e<__half>(float (&d)[smp_tc::ACC], uint64_t da, uint64_t db,
                                                           int scale_d) {
  smp_tc::wgmma_f16(d, da, db, scale_d);
}

// A tile is 128 rows by NB = 2 blocks of 144 columns (each consumer thread
// holds 2 x 72 accumulators), so the fused QKV's 2048 x 2304 output is 128
// tiles: one round over 132 SMs. A stage holds the x tile and both w tiles.
constexpr int NB = 2;
constexpr int STAGES = 3;
constexpr int STAGE = smp_tc::A_TILE + NB * smp_tc::B_TILE;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + smp_tc::staging_bytes<__half>() + 2 * STAGES * 8;

// A persistent grid of 384-thread CTAs (csrc/tma_wgmma.cuh).
template <typename E, typename B>
__global__ void __launch_bounds__(smp_tc::THREADS, 1)
matmul_bias_wgmma_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                         const B* __restrict__ b, E* __restrict__ y, int N, int D, int F) {
  using namespace smp_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* staging = smem + STAGES * STAGE;  // the epilogue's, apart from the stages
  const uint32_t st = smem_u32(smem);
  const uint32_t full = smem_u32(staging + staging_bytes<E>()), empty = full + 8 * STAGES;
  const TileWalk<NB> tiles(N, F);
  const int kblocks = (D + ROW_BYTES / 2 - 1) / (ROW_BYTES / 2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) produce<STAGES, NB>(&mx, &mw, st, full, empty, tiles, kblocks, ROW_BYTES / 2);
  } else {  // consumer warpgroups: rows m0 + 64 wg .. of each tile
    setmaxnreg_inc<232>();
    int it = 0;  // k-blocks consumed so far, as the producer counts them
    for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
      float d0[ACC], d1[ACC];  // columns n0 .. n0 + 143, n0 + 144 .. n0 + 287
#pragma unroll
      for (int i = 0; i < ACC; ++i) d0[i] = d1[i] = 0.f;
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        const uint32_t a = st + s * STAGE + wg * 64 * ROW_BYTES, b0 = st + s * STAGE + A_TILE, b1 = b0 + B_TILE;
        fence_regs(d0);
        fence_regs(d1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_e<E>(d0, desc_sw128(a + 32 * kk), desc_sw128(b0 + 32 * kk), 1);
          wgmma_e<E>(d1, desc_sw128(a + 32 * kk), desc_sw128(b1 + 32 * kk), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // block kb - 1 is done: release its stage while block kb runs
        fence_regs(d0);
        fence_regs(d1);
        if (kb > 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(d0);
      fence_regs(d1);
      mbar_arrive(empty + 8 * ((it - 1) % STAGES));  // the producer is loading the next tile meanwhile
      const int r0 = tiles.m0(t) + 64 * wg, n0 = tiles.n0(t);
      store_tile<E>(d0, staging, y, b, N, F, r0, n0, wg);
      store_tile<E>(d1, staging, y, b, N, F, r0, n0 + BN, wg);
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename E, typename B>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int N, int D, int F, cudaStream_t s) {
  const dim3 grid(ceil_div(N, BT), ceil_div(F, BT));
  matmul_bias_kernel<E, B><<<grid, NT, 0, s>>>(static_cast<const E*>(x), static_cast<const E*>(w),
                                               static_cast<const B*>(b), static_cast<E*>(y), N, D, F);
  return cudaGetLastError();
}

// The bias in fp32 (b_fp32) or in E.
template <typename E>
cudaError_t launch(const void* x, const void* w, const void* b, int b_fp32, void* y, int N, int D, int F,
                   cudaStream_t s) {
  return b_fp32 ? launch<E, float>(x, w, b, y, N, D, F, s) : launch<E, E>(x, w, b, y, N, D, F, s);
}

template <typename E, typename B>
cudaError_t launch_wgmma(CUtensorMapDataType type, const void* x, const void* w, const void* b, void* y, int N,
                         int D, int F, cudaStream_t s) {
  CUtensorMap mx, mw;
  if (!smp_tc::encode_rows(&mx, type, 2, x, N, D, smp_tc::BM) ||
      !smp_tc::encode_rows(&mw, type, 2, w, F, D, smp_tc::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(matmul_bias_wgmma_kernel<E, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  matmul_bias_wgmma_kernel<E, B><<<smp_tc::persistent_grid(N, F, NB * smp_tc::BN), smp_tc::THREADS, SMEM_BYTES,
                                   s>>>(mx, mw, static_cast<const B*>(b), static_cast<E*>(y), N, D, F);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_wgmma(CUtensorMapDataType type, const void* x, const void* w, const void* b, int b_fp32, void* y,
                         int N, int D, int F, cudaStream_t s) {
  return b_fp32 ? launch_wgmma<E, float>(type, x, w, b, y, N, D, F, s)
                : launch_wgmma<E, E>(type, x, w, b, y, N, D, F, s);
}

}  // namespace

extern "C" {

// The CUDA-core route. dtype: 0 fp32, 1 fp16, 2 bf16, shared by x, w and y.
// x [N, D], w [F, D] and y [N, F] are contiguous row-major; b is a contiguous
// [F] bias, fp32 if b_fp32 else of x's dtype, or null. Returns a cudaError_t
// (0 = launched).
int smp_matmul_bias_simt(int dtype, const void* x, const void* w, const void* b, int b_fp32, void* y, int N, int D,
                         int F, void* stream) {
  if (N < 0 || D < 0 || F < 0 || ceil_div(F, BT) > 65535) return (int)cudaErrorInvalidValue;
  if (N == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float, float>(x, w, b, y, N, D, F, s);
    case 1: return (int)launch<__half>(x, w, b, b_fp32, y, N, D, F, s);
    case 2: return (int)launch<__nv_bfloat16>(x, w, b, b_fp32, y, N, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route, for dtype 1 (fp16) or 2 (bf16), the rest as above;
// x and w 16-byte aligned and D a positive multiple of 8 (TMA's rules).
int smp_matmul_bias_wgmma(int dtype, const void* x, const void* w, const void* b, int b_fp32, void* y, int N, int D,
                          int F, void* stream) {
  if (N < 0 || F < 0 || D <= 0 || D % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      static_cast<long long>(ceil_div(N, smp_tc::BM)) * ceil_div(F, smp_tc::BN) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return (int)launch_wgmma<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, x, w, b, b_fp32, y, N, D, F, s);
    case 2:
      return (int)launch_wgmma<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, w, b, b_fp32, y, N, D, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
