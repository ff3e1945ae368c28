// Matrix product of two fp8 (e4m3) operands into fp32, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_qkv.py
//   _mm_fp8_kernel :162 -> matmul_fp8_wgmma_kernel (and matmul_fp8_kernel, the
//                          CUDA-core route)
// launched by matmul_bias_fp8 (:171, pl.pallas_call at :194), the fp8 rung of
// the fused QKV projection under matmul_precision: fp8 (quant._fp8_mm2d with
// use_pallas=True, called from nn/transformer.py's fused QKV). Python wrapper
// and plain PyTorch version: smdistributed_modelparallel_tpu_torch/ops/
// matmul_fp8.py, whose _route sends operands with D % 16 == 0 and 16-byte
// aligned bases (TMA's rules) to the tensor cores and the rest to the CUDA
// cores. Neither route stands in for the other.
//
// What it computes, for x8 [N, D] and w8 [F, D], both float8_e4m3fn:
//   y[r, c] = sum_d float(x8[r, d]) * float(w8[c, d])        (fp32, [N, F])
// No scale and no bias: the delayed-scaling dequant multiply and the bias stay
// in the caller's epilogue (quant._fp8_mm2d), as they stay in XLA's on the TPU.
// Every e4m3 value is exact in fp32 and so is the product of two of them (4 +
// 4 significant bits), so the kernel differs from its plain version only by
// the order and rounding of the fp32 sums.
//
// Layout: w8 is the port's parameter as it holds it, an nn.Linear-style
// [F, D] weight (the JAX kernel's w8 [D, F] transposed); both operands are
// contiguous along D (K-major), the one layout fp8 wgmma accepts.
//
// Bound on an H100 (the fused QKV of GPT-2 124M: N = 2048, D = 768, F =
// 2304): 2 N D F = 7.25 GFLOP, 3.7 us at 1,979 TFLOP/s fp8; it moves 1.57 MB
// of x8, 1.77 MB of w8 and 18.9 MB of fp32 y, 22.2 MB or 6.6 us at 3.35 TB/s,
// so it is bound by bytes (the fp32 output), which the epilogue writes as
// fully coalesced 16-byte stores.
//
// Tensor-core route (matmul_fp8_wgmma_kernel, csrc/tma_wgmma.cuh's shape): a
// persistent grid over 128 x 144 output tiles; one producer thread keeps TMA
// loads of x8 [128, 128] and w8 [144, 128] (128 bytes of K, 128-byte swizzle)
// in flight; two consumer warpgroups. The trouble is accumulation: the fp8
// tensor-core path adds with fewer bits than fp32 (about 14, DeepSeek-V3
// technical report, section 3.3.2), and the product is held to the bound of
// an fp32 sum taken in any order. So the e4m3 instruction is not used (with a
// partial per 128-deep k-block promoted into fp32 it missed that bound by up
// to 80x on an H100; PERF.md). Instead each consumer thread widens its share
// of the staged e4m3 bytes exactly to f16 (cvt.rn.f16x2.e4m3x2; e4m3's values
// from 2^-9 to 448 lie inside f16) into a swizzled f16 tile pair (two of
// them, so one k-block's widening overlaps the previous block's wgmma), then
// wgmma m64n144k16 .f16 accumulates into fp32: the product of two f16 values
// is exact in fp32. Each x and w row block is widened once for every tile
// that reads it (16 times at the fused QKV's shape); that widening, not
// measured apart, is the likely cost (PERF.md).
// Rows >= N, columns >= F and d >= D arrive from TMA as zeros and are not
// stored.
//
// CUDA-core route (matmul_fp8_kernel, the simplest right form): one CTA of
// 256 threads (16 x 16) per 64 x 64 output tile; each thread owns rows ty +
// 16i and columns tx + 16j (i, j < 4). D streams through shared memory 64
// bytes at a time: each thread loads one 16-byte segment of x8 and one of w8
// (a plain byte loop where D is not a multiple of 16 or a pointer is not
// 16-byte aligned), widens the 16 e4m3 values exactly to fp32 and stores
// them. fp32 FMA only. Rows >= N, columns >= F and d >= D load as 0 and are
// not stored, so any N, D and F run.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

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

// Two e4m3 bytes of each half of `v` -> four f16 pairs, exactly: lo[0..1]
// from the low 16 bits, in order.
__device__ __forceinline__ void e4m3x4_to_f16x4(uint32_t v, uint32_t& p0, uint32_t& p1) {
  asm("{\n"
      ".reg .b16 lo, hi;\n"
      "mov.b32 {lo, hi}, %2;\n"
      "cvt.rn.f16x2.e4m3x2 %0, lo;\n"
      "cvt.rn.f16x2.e4m3x2 %1, hi;\n"
      "}\n"
      : "=r"(p0), "=r"(p1)
      : "r"(v));
}

// Widen row r, 16-byte chunk c (K bytes 16c .. 16c + 15) of a staged e4m3
// tile (128-byte swizzled rows) into the f16 tile of `rows` rows: two
// 128-byte-swizzled atoms of 64 K each, so f16 chunks 2c and 2c + 1 land in
// atom c / 4.
__device__ __forceinline__ void widen_chunk(const uint8_t* src, uint8_t* dst, int rows, int r, int c) {
  const uint4 v = *reinterpret_cast<const uint4*>(src + r * 128 + ((c ^ (r & 7)) << 4));
  uint4 lo, hi;
  e4m3x4_to_f16x4(v.x, lo.x, lo.y);
  e4m3x4_to_f16x4(v.y, lo.z, lo.w);
  e4m3x4_to_f16x4(v.z, hi.x, hi.y);
  e4m3x4_to_f16x4(v.w, hi.z, hi.w);
  uint8_t* atom = dst + (c >> 2) * rows * 128 + r * 128;
  const int g = (2 * c) & 7;
  *reinterpret_cast<uint4*>(atom + ((g ^ (r & 7)) << 4)) = lo;
  *reinterpret_cast<uint4*>(atom + (((g + 1) ^ (r & 7)) << 4)) = hi;
}

// Shared memory past the stages: two f16 tile pairs [x 128 rows | w 144 rows]
// x 128 K, which the epilogue stages the output in once every wgmma of the
// tile is done.
constexpr int STAGES = 2;
constexpr int FA = smp_tc::BM * 256, FB = smp_tc::BN * 256;  // one f16 pair
constexpr int EXTRA = 2 * (FA + FB);
static_assert(EXTRA >= smp_tc::staging_bytes<float>(), "the epilogue stages in the f16 pairs");
constexpr int SMEM_BYTES = 1024 + STAGES * (smp_tc::A_TILE + smp_tc::B_TILE) + EXTRA + 2 * STAGES * 8;

// A persistent grid of 384-thread CTAs (csrc/tma_wgmma.cuh).
__global__ void __launch_bounds__(smp_tc::THREADS, 1)
matmul_fp8_wgmma_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                        float* __restrict__ y, int N, int D, int F) {
  using namespace smp_tc;
  constexpr int S = STAGES, STAGE = A_TILE + B_TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint8_t* extra = smem + S * STAGE;
  const uint32_t sa = smem_u32(smem);  // stage s: the x tile at sa + s * STAGE, then the w tile
  const uint32_t full = smem_u32(extra + EXTRA), empty = full + 8 * S;
  const TileWalk<1> tiles(N, F);
  const int kblocks = (D + ROW_BYTES - 1) / ROW_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) produce<S, 1>(&mx, &mw, sa, full, empty, tiles, kblocks, ROW_BYTES);
  } else {  // consumer warpgroups: rows m0 + 64 wg .. of each tile
    setmaxnreg_inc<232>();
    int it = 0;  // k-blocks consumed so far, as the producer counts them
    // Widen the staged bytes of k-block `k` (ring position) into f16 pair
    // `pair` and release the stage: this warpgroup's 64 x rows (512 16-byte
    // chunks) and its half of the w rows (shared by both).
    auto widen = [&](int k, int pair) {
      const int s = k % S, u0 = threadIdx.x & 127;
      uint8_t* fa = extra + pair * (FA + FB);
      const uint8_t* xa = smem + s * STAGE;
      const uint8_t* wb = xa + A_TILE;
      mbar_wait(full + 8 * s, (k / S) & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = u0 + 128 * i;
        widen_chunk(xa, fa, BM, 64 * wg + (u >> 3), u & 7);
      }
      for (int u = threadIdx.x; u < BN * 8; u += CONSUMERS) widen_chunk(wb, fa + FA, BN, u >> 3, u & 7);
      mbar_arrive(empty + 8 * s);
      fence_proxy_async();
    };
    for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
      float d[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[i] = 0.f;
      if (kblocks > 0) widen(it, 0);
      bar_sync(1, CONSUMERS);
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const uint32_t fa = smem_u32(extra + (kb & 1) * (FA + FB));
        const uint32_t a = fa + wg * 64 * 128, bt = fa + FA;
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int atom = kk >> 2, off = 32 * (kk & 3);  // f16 K 16 kk .. 16 kk + 15
          wgmma_f16(d, desc_sw128(a + atom * BM * 128 + off), desc_sw128(bt + atom * BN * 128 + off), 1);
        }
        wgmma_commit();
        if (kb + 1 < kblocks) widen(it + 1, (kb + 1) & 1);  // overlaps this block's wgmma
        wgmma_wait<0>();
        fence_regs(d);
        // Both warpgroups' wgmma of block kb are done (its pair may be
        // overwritten by block kb + 2) and pair kb + 1 is written.
        bar_sync(1, CONSUMERS);
      }
      store_tile<float, float>(d, extra, y, nullptr, N, F, tiles.m0(t) + 64 * wg, tiles.n0(t), wg);
      bar_sync(1, CONSUMERS);  // both are done with the staging before the next tile widens into it
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

cudaError_t launch_wgmma(const void* x8, const void* w8, float* y, int N, int D, int F, cudaStream_t s) {
  CUtensorMap mx, mw;
  if (!smp_tc::encode_rows(&mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x8, N, D, smp_tc::BM) ||
      !smp_tc::encode_rows(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w8, F, D, smp_tc::BN))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(matmul_fp8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  matmul_fp8_wgmma_kernel<<<smp_tc::persistent_grid(N, F, smp_tc::BN), smp_tc::THREADS, SMEM_BYTES, s>>>(
      mx, mw, y, N, D, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The CUDA-core route. x8 [N, D] and w8 [F, D] are contiguous row-major
// float8_e4m3fn (one byte each), y [N, F] contiguous fp32. Returns a
// cudaError_t (0 = launched).
int smp_matmul_fp8_simt(const void* x8, const void* w8, float* y, int N, int D, int F, void* stream) {
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

// The tensor-core route, the same arguments; x8 and w8 16-byte aligned and D a
// positive multiple of 16 (TMA's rules).
int smp_matmul_fp8_wgmma(const void* x8, const void* w8, float* y, int N, int D, int F, void* stream) {
  if (N < 0 || F < 0 || D <= 0 || D % 16 != 0 || reinterpret_cast<uintptr_t>(x8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w8) % 16 != 0 ||
      static_cast<long long>(ceil_div(N, smp_tc::BM)) * ceil_div(F, smp_tc::BN) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || F == 0) return (int)cudaSuccess;
  return (int)launch_wgmma(x8, w8, y, N, D, F, static_cast<cudaStream_t>(stream));
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
