// Shared pieces of the tensor-core kernels (csrc/matmul_bias.cu,
// csrc/matmul_fp8.cu, csrc/flash_bwd.cu) for Hopper (sm_90a): TMA tensor maps
// and loads, mbarriers, wgmma descriptors and instructions, and the
// output-tile store. The flash backward's pieces (a 4-D map over a
// [B, L, H, 64] operand, m64n64k16 wgmma with A from shared memory or from
// registers, the MN-major descriptor) are at the end of the file.
//
// The common shape: a persistent grid, one CTA of three warpgroups on each SM,
// walks the output tiles of an "NT" product (x [N, K] and w [F, K], both
// contiguous along K): CTA b takes tiles b, b + grid, ... A tile is BM = 128
// rows by NB blocks of BN = 144 columns. Warpgroup 2's first thread is the
// producer: it issues TMA loads of an x tile [BM, 128 bytes of K] and NB w
// tiles [BN, 128 bytes of K] into a ring of stages in dynamic shared memory,
// each guarded by a "full" mbarrier (the TMA bytes arrived) and an "empty" one
// (all 256 consumer threads are done with the stage), and runs on into the
// next tile while the consumers finish this one, so a tile's epilogue overlaps
// the next one's loads. Warpgroups 0 and 1 are the consumers: each owns 64
// rows of the tile and issues wgmma m64n144 with its fp32 accumulators in
// registers. TMA writes the tiles with the 128-byte swizzle that the wgmma
// descriptors name; rows and columns past the tensor's end arrive as zeros.
//
// Why blocks of 144 columns: wgmma takes n up to 256 in steps of 8, and the
// fused QKV's F = 2304 is 16 x 144 (or 8 x 288). At N 2048, 128 x 144 tiles
// make 256 tiles, 1.94 rounds over 132 SMs with 94% of the SMs busy in the
// last (128 x 128: 288 tiles, 2.18 rounds, 18%); 128 x 288 tiles make 128, one
// round.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smp_tc {

constexpr int BM = 128;                  // tile rows: two consumer warpgroups of 64
constexpr int BN = 144;                  // tile columns: wgmma n = 144
constexpr int ACC = BN / 2;              // fp32 accumulators a consumer thread holds (64 x 144 / 128)
constexpr int ROW_BYTES = 128;           // K bytes of a staged tile row: one 128-byte swizzle row
constexpr int A_TILE = BM * ROW_BYTES;   // bytes of one staged x tile
constexpr int B_TILE = BN * ROW_BYTES;   // bytes of one staged w tile
constexpr int CONSUMERS = 256;           // threads of the two consumer warpgroups
constexpr int THREADS = 384;             // plus the producer warpgroup

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; it is taken through the
// runtime's entry-point query, so the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a row-major [rows, cols] matrix of `esize`-byte elements
// whose rows are `cols * esize` bytes apart, read in boxes of [box_rows,
// 128 bytes] with the 128-byte swizzle; out-of-bounds elements read as zero.
// TMA needs a 16-byte aligned base and a row pitch that is a multiple of 16
// bytes (the wrappers route other operands to the CUDA-core kernels).
inline bool encode_rows(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base, int rows, int cols,
                        int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ROW_BYTES / esize), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The swizzled tiles need 1024-byte aligned bases (the 128-byte swizzle repeats
// every 8 rows of 128 bytes); the launch asks for 1 KB more than it uses.
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + 1023u) & ~1023u) - s);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (column c0, row c1) into shared memory at dst; its bytes
// complete a transaction of the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma) of them.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// start address >> 4, leading offset 1 (unused by this layout), stride 1024
// bytes between 8-row groups, layout type 1 (128-byte swizzle). A k-step
// inside the 128-byte row advances the start address by its bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma's registers
// (accumulators; with the overloads below, A fragments and descriptors)
// across the asynchronous wgmma (issued before, waited for after).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint64_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(d[i])::"memory");
}

#define SMP_ACC8(i)                                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define SMP_ACC72                                                                                                \
  SMP_ACC8(0), SMP_ACC8(8), SMP_ACC8(16), SMP_ACC8(24), SMP_ACC8(32), SMP_ACC8(40), SMP_ACC8(48), SMP_ACC8(56), \
      SMP_ACC8(64)
#define SMP_ACC72_STR                                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "  \
  "%65, %66, %67, %68, %69, %70, %71}"

// d[64 x 144] (+)= A[64 x 16] B[144 x 16]^T, bf16 operands from shared memory.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[ACC], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 " SMP_ACC72_STR ", %72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : SMP_ACC72
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with fp16 operands.
__device__ __forceinline__ void wgmma_f16(float (&d)[ACC], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.f16.f16 " SMP_ACC72_STR ", %72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : SMP_ACC72
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef SMP_ACC8
#undef SMP_ACC72
#undef SMP_ACC72_STR

// The tiles of an [N, F] output, walked by a persistent grid: CTA b takes
// tiles b, b + gridDim.x, ...; a tile is BM rows by NB blocks of BN columns,
// and tile t covers rows (t / cols) * BM and columns (t % cols) * NB * BN.
template <int NB>
struct TileWalk {
  int cols, count;
  __device__ __forceinline__ TileWalk(int N, int F)
      : cols((F + NB * BN - 1) / (NB * BN)), count(((N + BM - 1) / BM) * cols) {}
  __device__ __forceinline__ int m0(int t) const { return (t / cols) * BM; }
  __device__ __forceinline__ int n0(int t) const { return (t % cols) * NB * BN; }
};

// The producer's loop: k-block kb of every tile the CTA takes (x rows m0..,
// w rows n0.. in NB boxes of BN, 128 bytes of K each, k_step elements) into
// the next stage of the ring once the consumers have released it. A stage is
// an x tile followed by NB w tiles.
template <int S, int NB>
__device__ __forceinline__ void produce(const CUtensorMap* mx, const CUtensorMap* mw, uint32_t stages,
                                        uint32_t full, uint32_t empty, const TileWalk<NB>& tiles, int kblocks,
                                        int k_step) {
  constexpr int STAGE = A_TILE + NB * B_TILE;
  int it = 0;  // k-blocks issued so far: stage it % S, round it / S
  for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round finds every stage free
      mbar_arrive_expect_tx(full + 8 * s, STAGE);
      tma_load_2d(stages + s * STAGE, mx, full + 8 * s, kb * k_step, tiles.m0(t));
#pragma unroll
      for (int h = 0; h < NB; ++h)
        tma_load_2d(stages + s * STAGE + A_TILE + h * B_TILE, mw, full + 8 * s, kb * k_step, tiles.n0(t) + h * BN);
    }
  }
}

// Bytes of shared memory a consumer warpgroup's epilogue stages a 64-row
// tile of T in (rows padded by 16 bytes, so the pair stores spread over
// banks).
template <typename T> __host__ __device__ constexpr int stage_row() { return BN * static_cast<int>(sizeof(T)) + 16; }
template <typename T> __host__ __device__ constexpr int staging_bytes() { return 2 * 64 * stage_row<T>(); }

template <typename T> __device__ __forceinline__ void store_pair(uint8_t* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(uint8_t* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(uint8_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store_pair<__half>(uint8_t* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The epilogue of one consumer warpgroup: its 64 x 144 accumulators, plus the
// bias b[c] when b is given (B: fp32, or the output's dtype; widened to fp32
// exactly and added with __fadd_rn once the sum is complete),
// rounded once to T into shared memory (this warpgroup's 64 rows of
// `staging`, which the caller has made free; staging_bytes<T>() for both),
// then written out as 16-byte stores where a row's bytes are a multiple of 16
// (else one element at a time), masked at r < N and c < F. `r0` is the
// warpgroup's first row, `n0` the tile's first column, `wg` its index. On
// return the warpgroup is done with its staging rows.

template <typename T, typename B = float>
__device__ __forceinline__ void store_tile(const float (&d)[ACC], uint8_t* staging, T* __restrict__ y,
                                           const B* __restrict__ b, int N, int F, int r0, int n0, int wg) {
  constexpr int ROW = stage_row<T>();
  uint8_t* stage = staging + wg * 64 * ROW;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (b != nullptr) {
      b0 = n0 + c < F ? to_f32(b[n0 + c]) : 0.f;
      b1 = n0 + c + 1 < F ? to_f32(b[n0 + c + 1]) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (b != nullptr) v0 = __fadd_rn(v0, b0), v1 = __fadd_rn(v1, b1);
      store_pair<T>(stage + r * ROW + c * static_cast<int>(sizeof(T)), v0, v1);
    }
  }
  bar_sync(2 + wg, 128);
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  if ((F % EPV) == 0 && (reinterpret_cast<uintptr_t>(y) & 15u) == 0) {
    constexpr int CPR = BN / EPV;  // 16-byte chunks per tile row
    for (int i = t; i < 64 * CPR; i += 128) {
      const int r = i / CPR, ch = i % CPR, gr = r0 + r, gc = n0 + ch * EPV;
      if (gr < N && gc < F)
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(gr) * F + gc) =
            *reinterpret_cast<const uint4*>(stage + r * ROW + ch * 16);
    }
  } else {
    for (int i = t; i < 64 * BN; i += 128) {
      const int r = i / BN, c = i % BN, gr = r0 + r, gc = n0 + c;
      if (gr < N && gc < F)
        y[static_cast<size_t>(gr) * F + gc] = *reinterpret_cast<const T*>(stage + r * ROW + c * sizeof(T));
    }
  }
  bar_sync(2 + wg, 128);
}

// Host side: the persistent grid, one CTA per SM of the current device (at
// most one per tile of BM x tile_cols).
inline int persistent_grid(int N, int F, int tile_cols) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                cudaSuccess)
    sms = 132;
  const long long tiles = static_cast<long long>((N + BM - 1) / BM) * ((F + tile_cols - 1) / tile_cols);
  return static_cast<int>(tiles < sms ? tiles : sms);
}

// ------------------------------------------------- attention (flash_bwd.cu)
//
// An attention operand [B, L, H, 64] of 16-bit elements with element strides
// (sb, sl, sh) along batch, row and head (the head dim contiguous) is read in
// [64 rows, 64] boxes of one (batch, head): 64 rows of 128 bytes, the
// 128-byte swizzle, rows past L as zeros. The map's dimensions are (64, L, H,
// B), so the row stride need not be the largest (q, k and v may be views into
// a fused QKV output). TMA's rules: a 16-byte aligned base, strides that are
// multiples of 16 bytes.

constexpr int HEAD_TILE = 64 * ROW_BYTES;  // bytes of one [64, 64] 16-bit tile

inline bool encode_bthd(CUtensorMap* map, CUtensorMapDataType type, const void* base, int L, int H, int B,
                        long long sl, long long sh, long long sb) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The box of rows r0 .. r0 + 63 of head h of batch b.
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar, int r0, int h,
                                              int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(r0), "r"(h), "r"(b)
      : "memory");
}

// wgmma descriptor of an MN-major operand: a [64 k-rows, 64] tile whose 64
// columns (the product's N) are one 128-byte swizzled row. Its 8-row groups
// along k are 1024 bytes apart. The two offset fields are that stride and the
// stride between 64-column blocks along N; with one such block they are both
// set to 1024. A 16-row k-step advances the start address by 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The descriptors of the four 16-deep k-steps of a [64, 64] tile at addr:
// K-major (k-steps 32 bytes apart) or MN-major (2048 bytes apart).
__device__ __forceinline__ void k_steps(uint64_t (&d)[4], uint32_t addr, bool mn_major) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) d[kk] = mn_major ? desc_sw128_mn(addr + 2048 * kk) : desc_sw128(addr + 32 * kk);
  fence_regs(d);
}

// Two fp32 values rounded to a packed pair of 16-bit values (the first in the
// low half): one register of a wgmma A fragment.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define SMP_ACC32                                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),   \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SMP_ACC32_STR                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory
// (128-byte swizzle); scale_d = 0 overwrites d. T: __nv_bfloat16 or __half.
template <typename T> __device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_n64_ss<__nv_bfloat16>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SMP_ACC32_STR ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SMP_ACC32
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_n64_ss<__half>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " SMP_ACC32_STR ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SMP_ACC32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (a[0..3], the
// fragment of 16 columns of an m64n64 accumulator, see pack2), B MN-major in
// shared memory (desc_sw128_mn; the transpose bit).
template <typename T> __device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_n64_rs<__nv_bfloat16>(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SMP_ACC32_STR ", {%32, %33, %34, %35}, %36, p, 1, 1, "
      "1;\n}\n"
      : SMP_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_n64_rs<__half>(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " SMP_ACC32_STR ", {%32, %33, %34, %35}, %36, p, 1, 1, "
      "1;\n}\n"
      : SMP_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SMP_ACC32
#undef SMP_ACC32_STR

template <typename T> struct TmaType;
template <> struct TmaType<__nv_bfloat16> { static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; };
template <> struct TmaType<__half> { static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16; };

}  // namespace smp_tc
