// Fused LM-head cross-entropy for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_ce.py
//   _fwd_kernel    :46  -> fused_ce_fwd_wgmma_kernel<E, SMOOTH> (tensor cores,
//                          bf16 and fp16) and fused_ce_fwd_kernel<E> (CUDA
//                          cores), each + fused_ce_fwd_merge
//   _bwd_dx_kernel :95  -> fused_ce_bwd_wgmma_kernel<false> (tensor cores, bf16)
//                          and fused_ce_bwd_kernel<E, false> (CUDA cores)
//   _bwd_dw_kernel :130 -> fused_ce_bwd_wgmma_kernel<true> and
//                          fused_ce_bwd_kernel<E, true>
//   each backward kernel + fused_ce_reduce where its grid splits the walk.
// launched by _fused_ce_fwd_impl / _fused_ce_bwd_impl through pl.pallas_call,
// the forward and backward of fused_lm_head_ce's custom_vjp. Python wrappers
// and plain PyTorch versions: smdistributed_modelparallel_tpu_torch/ops/fused_ce.py,
// whose _fwd_route and _route pick the kernel by the operands alone: the
// forward takes the tensor cores for bf16 and fp16 with D a multiple of 8, the
// backward for bf16 with D a multiple of 8 up to 2048, both on 16-byte aligned
// bases; the rest (fp32; fp16 in the backward; other D) the CUDA cores.
// Neither stands in for the other.
//
// What they compute, for x [N, D], w [V, D] (one dtype: fp32, fp16 or bf16),
// int32 targets t [N], logits z = x w^T in fp32 (never stored):
//   forward: per row, lse = m + log(max(l, 1e-30)) with m = max_c z and
//            l = sum_c exp(z - m); tgt = z[t] when 0 <= t < V, else 0; and,
//            under smoothing, logit_sum = sum_c z;
//   dx:      dx = sum_c dlog[:, c] w[c] and
//   dW:      dW[c] = sum_r dlog[r, c] x[r], with
//            p = exp(z - lse), target_mass = (1 - eps) onehot(t) + eps / denom
//            (the eps term on c < V only) and dlog = (p - target_mass) * g,
//            rounded in that order (__fsub_rn / __fmul_rn keep nvcc from
//            contracting it into an FMA the reference does not do).
// Sums in fp32; dx and dW are cast to the input dtype at the end. Products of
// bf16/fp16 values are exact in fp32, so z matches the TPU kernel's fp32 dot
// up to the summation order.
//
// Bound on an H100 (GPT-2 124M head: D = 768, V = 50257, bf16): the forward
// does one [N x V x D] product (2 N V D FLOP: 158 GFLOP at N = 2048, 0.16 ms
// at 989 TFLOP/s), dx and dW two each (the recompute and the contraction:
// 0.32 ms each at N = 2048, 5.1 ms at N = 32768). They read and write 80-210
// MB (0.02-0.06 ms at 3.35 TB/s), so all three are operation-bound.
//
// Tensor-core forward (fused_ce_fwd_wgmma_kernel<E, SMOOTH>; csrc/tma_wgmma.cuh's
// pieces): matmul_bias.cu's NT mainloop with an online-softmax epilogue in
// place of its store. Products of 16-bit values are exact in fp32, so only the
// summation order changes (fp16 too: the forward has no dlog to underflow).
//   - CTA tiles of 128 x rows by 256 vocab columns: two consumer warpgroups of
//     64 rows, each with the 64 x 256 fp32 z of its rows in registers (wgmma
//     m64n256k16, both operands K-major: 128 registers a thread). One producer
//     thread streams D in 64-wide k-blocks (an x box [128, 64] and a w box
//     [256, 64], 48 KB a stage, 128-byte swizzle) through 4 stages; the ring
//     runs on across the vocab tiles, so the next tile's loads overlap a
//     tile's epilogue.
//   - The epilogue works on the accumulator fragments: a row's 256 columns
//     lie in one quad of threads, so the row max and the sums take two
//     shuffles. Columns >= V (w rows TMA reads as zeros, z = 0) are -1e30 and
//     out of the logit sum; the target logit is a masked sum over the tile.
//     Smoothing's logit sum is a template parameter.
//   - Grid (row blocks, vocab chunks), row blocks fastest: co-resident CTAs
//     walk the same w tiles at about the same time, so w is read through L2
//     and not from HBM for each row block. Where the row blocks alone do not
//     fill the SMs (N 2048: 16 of them), the wrapper splits the vocabulary
//     into chunks (_fwd_chunks); fused_ce_fwd_merge merges the chunks'
//     partials in order. No atomics: two launches give equal bits.
//   At N 32768 (D 768, V 50257) the product is 2.53 TFLOP, 2.56 ms at the
//   bf16 peak. Not yet used: ping-pong consumers (one warpgroup's epilogue
//   beside the other's products) or a second accumulator, so the tensor cores
//   idle while both warpgroups run the epilogue's 2 x 64 expf a thread and
//   tile; TMA multicast of the w tiles across a cluster.
//
// Tensor-core backward (fused_ce_bwd_wgmma_kernel<DW>, bf16; csrc/tma_wgmma.cuh's
// pieces). dx owns x rows and walks the vocab (w rows); dW owns w rows and
// walks the tokens (x rows). One template serves both: the owned operand O
// and the walked operand W, z (or z^T) = O W^T, acc += dlog W.
//   - Why a cluster: the fp32 sum of 128 owned rows over D = 768 is 384 KB,
//     more than one SM's registers (256 KB) or shared memory (227 KB). A
//     cluster of S = ceil(D / 256) CTAs (at most 8) splits D: CTA j owns slab
//     j (256 columns, the last one ragged) and holds the sum of 128 owned rows
//     x its slab in two consumer warpgroups (64 x 256 fp32: 128 registers a
//     thread). A loader warp brings the owned slab [128, slab] once and the
//     walked tiles' slab [64, slab] through a ring of three stages, by TMA
//     (128-byte swizzle) under mbarriers.
//   - Per walked tile each CTA computes its slab's partial z = O_slab W_slab^T
//     (wgmma m64n64k16, both operands K-major) and publishes it in its shared
//     memory. The producer warpgroup's other three warps (the helpers) add
//     the S partials of the cluster through distributed shared memory in rank
//     order 0 .. S-1 into a local z tile: z is the same bits in every CTA, so
//     the slabs agree on dlog. The consumers publish tile k + 1's partial
//     before they take tile k's sum, so the helpers' reads (the cluster's
//     bottleneck when the consumers did them: 64 KB of a peer's shared memory
//     a tile and CTA at S = 3) run beside the consumers' products. Two phases
//     of the cluster barrier a tile order it: R_k (every CTA has published
//     tile k) and F_k (every helper is done reading it, so the one exchange
//     buffer may take tile k + 1); two local mbarriers pass the summed tile
//     from the helpers to the consumers.
//   - The owned operand is M, so dlog comes out of the accumulator already in
//     the layout of a register A fragment for the contraction, whose B is the
//     same staged walked slab read MN-major.
//   - dlog keeps the fp32 of the reference: the TPU kernel contracts the fp32
//     dlog with the widened operand, and one bf16 rounding of dlog would be a
//     different function (2^-9 relative a term). So dlog is split into hi =
//     bf16(dlog) and lo = bf16(dlog - hi) (the difference is exact in fp32)
//     and both go through register-A wgmma into the same fp32 accumulators:
//     16 bits of dlog, a residual of ~2^-17 relative, products exact. The
//     kernel thus does 3 product units (z, hi, lo) for the function's 2. TF32
//     would cost the same tensor time and keep 11 bits; fp16's range would
//     flush dlog (~p / N, often below 6e-5) into subnormals, so fp16 and fp32
//     stay on the CUDA cores.
//   - dlog is zero on columns >= V and rows >= N: TMA fills those operand
//     rows with zeros, and z = 0 there does not make p = 0.
//   - The grid is (S, owned blocks of 128, walk chunks). At one chunk each
//     slab's sum is rounded once to bf16 and stored; where the owned blocks
//     alone cannot fill the card (dx at small N) the wrapper splits the walk
//     into chunks from cudaOccupancyMaxActiveClusters, each chunk's sum goes
//     to an fp32 partial buffer and fused_ce_reduce adds them in order.
//   - Every wgmma batch is waited for before a register it reads (A
//     fragments, accumulators) is defined, as in csrc/flash_bwd.cu: ptxas
//     serializes every wgmma of a kernel (C7513, C7515) otherwise, and (C7511)
//     when the registers run short, which an exchange in the consumers'
//     registers did.
//   - No atomics: every output element is one thread's sum in a fixed order,
//     so two launches on the same inputs give equal bits.
//   Bound as above (5.1 ms each at N = 32768); the hi/lo contraction alone is
//   5.1 ms at the tensor cores' peak, so these kernels cannot reach half
//   their bound's rate. A tile's steps still run one after another in each
//   consumer warpgroup, and both warpgroups in step: not yet used are
//   ping-pong consumers (one's dlog beside the other's products) and a
//   contraction that reads dlog from shared memory, which would let it run
//   behind the next tile's dlog but needs 32-64 KB more shared memory.
//
// CUDA-core kernels, in their simplest right form (as csrc/flash_*.cu), for
// what the tensor-core kernels do not take:
//   - one CTA of 256 threads (16 x 16) per 64 x 64 tile of z; each thread
//     owns rows ty + 16i and columns tx + 16j (i, j < 4). The product streams
//     D through shared memory 32 columns at a time, as a GEMM's K loop does,
//     so every D runs, and padding rows/columns are zero-filled and masked;
//   - forward: grid (row blocks, vocab chunks). The TPU grid carries the
//     online max/sum-exp across its sequential vocab axis; here each CTA
//     walks the vocab tiles of its chunk with the online update, writes
//     partial (m, l, tgt, sum) for the chunk, and fused_ce_fwd_merge merges
//     the chunks in order with the stable max/sum-exp merge the JAX package
//     uses across tp shards (pallas_ce.py:380-386), then finalizes lse;
//   - dx: grid (row blocks, vocab chunks); dW: grid (vocab tiles, row
//     chunks). A CTA owns its 64 output rows and walks the tiles of its chunk:
//     recompute the z tile, form dlog in shared memory, then contract it with
//     the other operand 64 output columns at a time. The fp32 sum lives in a
//     per-chunk partial buffer [chunks, rows, D] that only its owning thread
//     reads and writes (it stays in L2 while the CTA runs); fused_ce_reduce
//     sums the chunks in a fixed order and casts, so runs repeat bit for bit
//     (no atomics). The wrapper picks the chunk count so the grid fills the
//     card (vocab chunks at small N; one chunk at 32k tokens).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tma_wgmma.cuh"

namespace {

constexpr int NT = 256;       // threads per CTA (16 x 16)
constexpr int BT = 64;        // z tile: 64 rows x 64 vocab columns
constexpr int KC = 32;        // D columns per step of the z product
constexpr int LDK = KC + 4;   // row stride of the z operand tiles (floats)
constexpr int DC = 64;        // output columns per step of the contraction
constexpr int LDD = DC + 4;   // row stride of the contraction operand tile
constexpr int LDS = BT + 4;   // row stride of the dlog tile
constexpr float NEG_INF = -1e30f;

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

struct Params {
  const void* x;        // [N, D]
  const void* w;        // [V, D]
  const int* t;         // [N] targets
  const float* lse;     // [N] (backward)
  const float* g;       // [N] loss cotangent (backward)
  float* part;          // partials: forward [4, chunks, N]; backward [chunks, rows out, D]
  void* out;            // the tensor-core backward at one chunk: dx or dW (bf16); else null
  int N, V, D;
  int smoothing;
  float one_minus_eps;  // backward: 1 - eps
  float eps_d;          // backward: eps / (smooth_denom or V)
  int chunk_tiles;      // tiles of the walked dimension per chunk
};

// Reduce over the 16 lanes that share a row (tx = lane & 15).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// z[i][j] = x[r0 + ty + 16i] . w[c0 + tx + 16j] in fp32, streaming D through
// sA/sB KC columns at a time; rows >= N, columns >= V and d >= D load as 0.
template <typename E>
__device__ __forceinline__ void z_tile(const Params& p, int r0, int c0, float* sA, float* sB,
                                       int tx, int ty, float (&z)[4][4]) {
  const E* x = static_cast<const E*>(p.x);
  const E* w = static_cast<const E*>(p.w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
  for (int k0 = 0; k0 < p.D; k0 += KC) {
    __syncthreads();  // the previous operand tiles are no longer read
    for (int e = threadIdx.x; e < BT * KC; e += NT) {
      const int rr = e / KC, kk = e % KC, k = k0 + kk;
      const int r = r0 + rr, c = c0 + rr;
      sA[rr * LDK + kk] = (r < p.N && k < p.D) ? to_f<E>(x[(long long)r * p.D + k]) : 0.f;
      sB[rr * LDK + kk] = (c < p.V && k < p.D) ? to_f<E>(w[(long long)c * p.D + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&sA[(ty + 16 * i) * LDK + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(&sB[(tx + 16 * j) * LDK + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[i][j] = fmaf(a[i].x, b[j].x, z[i][j]);
          z[i][j] = fmaf(a[i].y, b[j].y, z[i][j]);
          z[i][j] = fmaf(a[i].z, b[j].z, z[i][j]);
          z[i][j] = fmaf(a[i].w, b[j].w, z[i][j]);
        }
    }
  }
}

// Forward: grid (row blocks, vocab chunks). Writes partial (m, l, tgt, sum)
// of its rows over its chunk's vocab tiles to part[q][chunk][row], q < 4.
template <typename E>
__global__ void __launch_bounds__(NT) fused_ce_fwd_kernel(const Params p) {
  __shared__ __align__(16) float sA[BT * LDK];
  __shared__ __align__(16) float sB[BT * LDK];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BT;
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const int v_tiles = (p.V + BT - 1) / BT;
  const int tile0 = chunk * p.chunk_tiles;
  const int tile1 = min(tile0 + p.chunk_tiles, v_tiles);

  int tid[4];
  float m[4], l[4], tg[4], sm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    const int t = r < p.N ? p.t[r] : -1;
    tid[i] = (t >= 0 && t < p.V) ? t : -1;  // a target outside [0, V) never hits
    m[i] = NEG_INF;
    l[i] = tg[i] = sm[i] = 0.f;
  }

  for (int tile = tile0; tile < tile1; ++tile) {
    const int c0 = tile * BT;
    float z[4][4];
    z_tile<E>(p, r0, c0, sA, sB, tx, ty, z);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF, hit = 0.f, vsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= p.V) z[i][j] = NEG_INF;  // padding columns, as on the TPU
        else vsum += z[i][j];
        if (c == tid[i]) hit += z[i][j];
        mx = fmaxf(mx, z[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(z[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(e);
      m[i] = m_new;
      tg[i] += row_sum(hit);
      if (p.smoothing) sm[i] += row_sum(vsum);
    }
  }

  if (tx == 0) {
    const long long plane = (long long)chunks * p.N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r >= p.N) continue;
      const long long o = (long long)chunk * p.N + r;
      p.part[o] = m[i];
      p.part[plane + o] = l[i];
      p.part[2 * plane + o] = tg[i];
      p.part[3 * plane + o] = sm[i];
    }
  }
}

// Merge the forward's chunks in order: lse = M + log(max(sum_c l_c e^{m_c - M},
// 1e-30)) with M = max_c m_c; tgt and logit_sum add up.
__global__ void fused_ce_fwd_merge(const float* part, int chunks, int N, float* lse, float* tgt,
                                   float* lsum) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long plane = (long long)chunks * N;
  float M = NEG_INF;
  for (int c = 0; c < chunks; ++c) M = fmaxf(M, part[(long long)c * N + r]);
  float L = 0.f, T = 0.f, S = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const long long o = (long long)c * N + r;
    L += part[plane + o] * expf(part[o] - M);
    T += part[2 * plane + o];
    S += part[3 * plane + o];
  }
  lse[r] = M + logf(fmaxf(L, 1e-30f));
  tgt[r] = T;
  if (lsum) lsum[r] = S;
}

// Backward: dx (DW = false; grid (row blocks, vocab chunks), walking vocab
// tiles) or dW (DW = true; grid (vocab tiles, row chunks), walking row
// tiles). Adds the chunk's sum into part[chunk][owned row][D] in fp32.
template <typename E, bool DW>
__global__ void __launch_bounds__(NT) fused_ce_bwd_kernel(const Params p) {
  // The contraction operand tile reuses the z operand tiles' space.
  __shared__ __align__(16) float sAB[2 * BT * LDK];
  __shared__ __align__(16) float sDL[BT * LDS];  // dlog as [walked][owned]
  static_assert(BT * LDD <= 2 * BT * LDK, "operand tile does not fit");
  float* sA = sAB;
  float* sB = sAB + BT * LDK;
  float* sOp = sAB;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int o0 = blockIdx.x * BT;  // owned rows: x rows (dx) or w rows (dW)
  const int chunk = blockIdx.y;
  const int owned_total = DW ? p.V : p.N;
  const int walk_total = DW ? p.N : p.V;
  const int walk_tiles = (walk_total + BT - 1) / BT;
  const int tile0 = chunk * p.chunk_tiles;
  const int tile1 = min(tile0 + p.chunk_tiles, walk_tiles);
  const E* op = static_cast<const E*>(DW ? p.x : p.w);
  float* part = p.part + ((long long)chunk * owned_total + o0) * p.D;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int r0 = DW ? tile * BT : o0;
    const int c0 = DW ? o0 : tile * BT;
    float z[4][4];
    z_tile<E>(p, r0, c0, sA, sB, tx, ty, z);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      const bool row_ok = r < p.N;
      const float lse = row_ok ? p.lse[r] : 0.f;
      const float g = row_ok ? p.g[r] : 0.f;
      const int t = row_ok ? p.t[r] : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        float d = 0.f;
        if (row_ok && c < p.V) {
          const float pr = expf(__fsub_rn(z[i][j], lse));
          float tm = (c == t) ? p.one_minus_eps : 0.f;
          if (p.smoothing) tm = __fadd_rn(tm, p.eps_d);
          d = __fmul_rn(__fsub_rn(pr, tm), g);
        }
        if (DW) sDL[(ty + 16 * i) * LDS + tx + 16 * j] = d;  // [row][vocab]
        else sDL[(tx + 16 * j) * LDS + ty + 16 * i] = d;      // [vocab][row]
      }
    }

    const int k0 = DW ? r0 : c0;  // first walked row of the operand tile
    const int k_rows = DW ? p.N : p.V;
    for (int d0 = 0; d0 < p.D; d0 += DC) {
      __syncthreads();  // sDL written; sA/sB (or the previous sOp) no longer read
      for (int e = threadIdx.x; e < BT * DC; e += NT) {
        const int kk = e / DC, dd = e % DC;
        const int k = k0 + kk, d = d0 + dd;
        sOp[kk * LDD + dd] = (k < k_rows && d < p.D) ? to_f<E>(op[(long long)k * p.D + d]) : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + ty + 16 * i, d = d0 + tx + 16 * j;
          acc[i][j] = (tile > tile0 && o < owned_total && d < p.D)
                          ? part[(long long)(ty + 16 * i) * p.D + d] : 0.f;
        }
#pragma unroll 4
      for (int kk = 0; kk < BT; ++kk) {
        float dl[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dl[i] = sDL[kk * LDS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) ov[j] = sOp[kk * LDD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dl[i], ov[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + ty + 16 * i, d = d0 + tx + 16 * j;
          if (o < owned_total && d < p.D) part[(long long)(ty + 16 * i) * p.D + d] = acc[i][j];
        }
    }
  }
}

// out[e] = sum over chunks, in order, of part[c][e], cast to E.
template <typename E>
__global__ void fused_ce_reduce(const float* part, int chunks, long long n, E* out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[(long long)c * n + e];
    out[e] = from_f<E>(s);
  }
}

// ------------------------------------------------------------ tensor cores

namespace tc {

constexpr int SLAB = 256;                   // D columns a CTA of the cluster owns
constexpr int BOXES = SLAB / 64;            // [rows, 64] TMA boxes (128 bytes a row) in a slab
constexpr int OWN_ROWS = 128;               // owned rows a CTA: two consumer warpgroups of 64
constexpr int WALK_ROWS = 64;               // rows of a walked tile
constexpr int OWN_BOX = OWN_ROWS * 128;     // bytes of one owned box
constexpr int WALK_BOX = WALK_ROWS * 128;   // bytes of one walked box
constexpr int STAGE = BOXES * WALK_BOX;     // a walked tile's slab: 32 KB
constexpr int STAGES = 3;
constexpr int ZTILE = 2 * 64 * 64 * 4;      // an fp32 z tile of both warpgroups (128 x 64): 32 KB
constexpr int SLOTS = ZTILE / 16;           // its float4s
constexpr int MAX_CLUSTER = 8;              // the portable cluster size: D <= 2048
constexpr int THREADS = 384;                // two consumer warpgroups and a producer warpgroup
constexpr int HELPERS = 96;                 // the producer warpgroup's last three warps
// One CTA an SM: 170 registers a thread at launch; after setmaxnreg the
// consumers have 224 (128 of them the slab's sum) and the producer warpgroup
// 56 (a helper keeps one float4 from each of up to 8 CTAs in flight).
constexpr int CONSUMER_REGS = 224, PRODUCER_REGS = 56;

// What the producer warp writes beside each stage for dW (the walked rows are
// tokens): their lse, g and target (0, 0, -1 past N).
struct Aux {
  float lse[WALK_ROWS];
  float g[WALK_ROWS];
  int t[WALK_ROWS];
};

// Dynamic shared memory from the first 1 KB boundary: the owned slab, the
// ring, the published partial, the summed z, the Aux of each stage, the
// barriers (full and empty per stage, one for the owned slab, full and empty
// for the summed z): 231,752 bytes. The launch asks for all a CTA may have
// (232,448), which leaves 696 bytes for the alignment; the dynamic base is
// 1 KB aligned in practice, and the kernel traps where it is not aligned
// enough rather than overrun.
constexpr int OFF_STAGES = BOXES * OWN_BOX;
constexpr int OFF_XCH = OFF_STAGES + STAGES * STAGE;
constexpr int OFF_ZSUM = OFF_XCH + ZTILE;
constexpr int OFF_AUX = OFF_ZSUM + ZTILE;
constexpr int OFF_BARS = OFF_AUX + STAGES * static_cast<int>(sizeof(Aux));
constexpr int OFF_END = OFF_BARS + 8 * (2 * STAGES + 3);
constexpr int SMEM_BYTES = 232448;
static_assert(OFF_END <= SMEM_BYTES, "the tensor-core CE backward's shared memory does not fit");

// The cluster barrier in its two halves: every thread of the cluster arrives
// at each phase and then waits for it. Release and acquire order the
// shared-memory accesses before a thread's arrival with those of every other
// thread (of any CTA of the cluster) after its wait.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;" ::: "memory"); }

// The address in CTA `rank` of the cluster of this CTA's shared address a.
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t a, float x, float y, float z, float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(x), "f"(y), "f"(z), "f"(w) : "memory");
}

__device__ __forceinline__ float4 ld_shared(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}

// A helper thread's share (slots h, h + HELPERS, ...) of the sum over the S
// CTAs of the cluster of their published partials (at xch in each), in rank
// order, into zsum: the same bits in every CTA. A slot's S loads are issued
// together.
template <int S>
__device__ __forceinline__ void sum_partials(uint32_t xch, uint32_t zsum, int h) {
  for (int q = h; q < SLOTS; q += HELPERS) {
    float4 v[S];
#pragma unroll
    for (int r = 0; r < S; ++r) v[r] = ld_cluster(map_rank(xch + 16 * q, r));
#pragma unroll
    for (int r = 1; r < S; ++r) v[0].x += v[r].x, v[0].y += v[r].y, v[0].z += v[r].z, v[0].w += v[r].w;
    st_shared(zsum + 16 * q, v[0].x, v[0].y, v[0].z, v[0].w);
  }
}

__device__ __forceinline__ void sum_partials(int S, uint32_t xch, uint32_t zsum, int h) {
  switch (S) {
    case 1: sum_partials<1>(xch, zsum, h); break;
    case 2: sum_partials<2>(xch, zsum, h); break;
    case 3: sum_partials<3>(xch, zsum, h); break;
    case 4: sum_partials<4>(xch, zsum, h); break;
    case 5: sum_partials<5>(xch, zsum, h); break;
    case 6: sum_partials<6>(xch, zsum, h); break;
    case 7: sum_partials<7>(xch, zsum, h); break;
    default: sum_partials<8>(xch, zsum, h); break;
  }
}

}  // namespace tc

// dx (DW = false) or dW (DW = true) on the tensor cores, bf16. Grid (S,
// owned blocks, walk chunks), clusters of (S, 1, 1): CTA j of a cluster owns
// D columns [256 j, 256 j + 256) of owned rows o0 .. o0 + 127 (x rows for dx,
// w rows for dW) and walks the 64-row tiles of its chunk of the other operand
// (w rows, the vocab, for dx; x rows, the tokens, for dW). m_own reads the
// owned operand in [128, 64] boxes, m_walk the walked one in [64, 64] boxes.
template <bool DW>
__global__ void __launch_bounds__(tc::THREADS, 1)
fused_ce_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap m_own, const __grid_constant__ CUtensorMap m_walk,
                          const Params p) {
  using namespace smp_tc;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  if (smem - smem_raw + tc::OFF_END > tc::SMEM_BYTES) __trap();
  const uint32_t own = smem_u32(smem), stages = own + tc::OFF_STAGES;
  const uint32_t xch = own + tc::OFF_XCH, zsum = own + tc::OFF_ZSUM;
  tc::Aux* aux = reinterpret_cast<tc::Aux*>(smem + tc::OFF_AUX);
  const uint32_t full = own + tc::OFF_BARS, empty = full + 8 * tc::STAGES, own_bar = empty + 8 * tc::STAGES;
  const uint32_t zs_full = own_bar + 8, zs_empty = zs_full + 8;
  const int S = gridDim.x, d0 = blockIdx.x * tc::SLAB;  // the cluster spans x: its rank is blockIdx.x
  const int nb = min(tc::BOXES, (p.D - d0 + 63) / 64);  // boxes in this CTA's slab
  const int o0 = blockIdx.y * tc::OWN_ROWS;
  const int owned_total = DW ? p.V : p.N;
  const int walk_tiles = ((DW ? p.N : p.V) + tc::WALK_ROWS - 1) / tc::WALK_ROWS;
  const int tile0 = blockIdx.z * p.chunk_tiles;
  const int n = max(0, min(tile0 + p.chunk_tiles, walk_tiles) - tile0);  // tiles walked, the same in every CTA
  if (threadIdx.x == 0) {
    for (int s = 0; s < tc::STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(own_bar, 1);
    mbar_init(zs_full, tc::HELPERS);
    mbar_init(zs_empty, 256);
    mbar_init_fence();
  }
  __syncthreads();

  // Every thread of the cluster takes part in two phases of the cluster
  // barrier a walked tile k: R_k (every CTA's consumers have published tile
  // k's partial in xch) and F_k (every CTA's helpers are done reading it).
  if (threadIdx.x >= 256) {  // producer warpgroup: a loader warp and three helper warps
    setmaxnreg_dec<tc::PRODUCER_REGS>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x >= 288) {  // helpers: tile k's sum over the cluster into zsum, in rank order
      const int h = threadIdx.x - 288;
      for (int k = 0; k < n; ++k) {
        tc::cluster_arrive();  // R_k
        tc::cluster_wait();
        if (k > 0) mbar_wait(zs_empty, (k - 1) & 1);  // the consumers have read tile k - 1's sum
        tc::sum_partials(S, xch, zsum, h);
        mbar_arrive(zs_full);
        tc::cluster_arrive();  // F_k
        tc::cluster_wait();
      }
      return;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(own_bar, nb * tc::OWN_BOX);
      for (int b = 0; b < nb; ++b) tma_load_2d(own + b * tc::OWN_BOX, &m_own, own_bar, d0 + 64 * b, o0);
    }
    auto issue = [&](int j) {  // walked tile j of the chunk into stage j % STAGES
      const int s = j % tc::STAGES, r0 = (tile0 + j) * tc::WALK_ROWS;
      mbar_wait(empty + 8 * s, ((j / tc::STAGES) & 1) ^ 1);  // the first round finds every stage free
      if (DW) {
        for (int i = lane; i < tc::WALK_ROWS; i += 32) {
          const bool in = r0 + i < p.N;
          aux[s].lse[i] = in ? p.lse[r0 + i] : 0.f;
          aux[s].g[i] = in ? p.g[r0 + i] : 0.f;
          aux[s].t[i] = in ? p.t[r0 + i] : -1;
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + 8 * s, nb * tc::WALK_BOX);
        for (int b = 0; b < nb; ++b)
          tma_load_2d(stages + s * tc::STAGE + b * tc::WALK_BOX, &m_walk, full + 8 * s, d0 + 64 * b, r0);
      } else {
        mbar_arrive(full + 8 * s);
      }
    };
    // The loader arrives at each phase before it may block on a stage (the
    // consumers free stage k only after tile k's sum, which waits for R_k).
    for (int j = 0; j < min(tc::STAGES, n); ++j) issue(j);
    if (n > 0) tc::cluster_arrive();  // R_0
    for (int k = 0; k < n; ++k) {
      tc::cluster_wait();  // R_k
      tc::cluster_arrive();  // F_k
      tc::cluster_wait();
      if (k + 1 < n) tc::cluster_arrive();  // R_k+1
      if (k + tc::STAGES < n) issue(k + tc::STAGES);
    }
    return;
  }

  // Consumer warpgroups: owned rows o0 + 64 wg .. o0 + 64 wg + 63.
  setmaxnreg_inc<tc::CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, qd = lane & 3;
  int orow[2];  // the thread's two owned rows (accumulator rows lane / 4 and + 8 of its warp's 16)
  float o_lse[2] = {0.f, 0.f}, o_g[2] = {0.f, 0.f};
  int o_t[2] = {-1, -1};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    orow[hh] = o0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hh;
    if (!DW && orow[hh] < p.N) {  // dx: the owned rows are tokens
      o_lse[hh] = p.lse[orow[hh]];
      o_g[hh] = p.g[orow[hh]];
      o_t[hh] = p.t[orow[hh]];
    }
  }
  float acc[tc::BOXES][32];
#pragma unroll
  for (int b = 0; b < tc::BOXES; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
  const uint32_t a_own = own + wg * 64 * 128;  // this warpgroup's 64 rows of each owned box
  const uint32_t frag = wg * (tc::ZTILE / 2) + t * 16;  // the thread's float4 k of a z tile: frag + 2048 k

  // This slab's partial z of walked tile j (64 owned x 64 walked): one batch
  // of 4 nb wgmma.
  auto partial = [&](float(&z)[32], int j) {
    const uint32_t st = stages + (j % tc::STAGES) * tc::STAGE;
    mbar_wait(full + 8 * (j % tc::STAGES), (j / tc::STAGES) & 1);
    fence_regs(z);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < tc::BOXES; ++b) {
      if (b < nb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n64_ss<bf16>(z, desc_sw128(a_own + b * tc::OWN_BOX + 32 * kk),
                             desc_sw128(st + b * tc::WALK_BOX + 32 * kk), (b | kk) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);
  };
  auto publish = [&](const float(&z)[32]) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      tc::st_shared(xch + frag + 2048 * k, z[4 * k], z[4 * k + 1], z[4 * k + 2], z[4 * k + 3]);
  };

  // A software pipeline over the walked tiles: tile it + 1's partial is
  // computed and published while the helpers sum tile it's over the
  // cluster, then tile it's dlog and contraction run on that sum.
  mbar_wait(own_bar, 0);
  if (n > 0) {
    float z[32];
    partial(z, 0);
    publish(z);
    tc::cluster_arrive();  // R_0
    tc::cluster_wait();
    tc::cluster_arrive();  // F_0
  }
  for (int it = 0; it < n; ++it) {
    const int s = it % tc::STAGES;
    const uint32_t st = stages + s * tc::STAGE;
    const bool next = it + 1 < n;
    if (next) {
      float zn[32];
      partial(zn, it + 1);
      tc::cluster_wait();  // F_it: every helper of the cluster is done reading tile it's partials
      publish(zn);
      tc::cluster_arrive();  // R_it+1
    }
    float z[32];  // tile it's z, summed over the cluster
    mbar_wait(zs_full, it & 1);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = tc::ld_shared(zsum + frag + 2048 * k);
      z[4 * k] = v.x, z[4 * k + 1] = v.y, z[4 * k + 2] = v.z, z[4 * k + 3] = v.w;
    }
    mbar_arrive(zs_empty);

    // dlog of each element (owned row orow[hh], walked row c0 + 8j + 2qd + e)
    // in the CUDA-core kernel's rounding order, split into bf16 hi and lo A
    // fragments (accumulator pairs).
    const int c0 = (tile0 + it) * tc::WALK_ROWS;
    const bool inner = c0 + tc::WALK_ROWS <= (DW ? p.N : p.V);  // no walked row of the tile past the end
    const tc::Aux& ax = aux[s];
    uint32_t hf[16], lf[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = 8 * j + 2 * qd;
      float2 w_lse = make_float2(0.f, 0.f), w_g = make_float2(0.f, 0.f);
      int2 w_t = make_int2(-1, -1);
      if (DW) {  // dW: the walked rows are tokens
        w_lse = *reinterpret_cast<const float2*>(&ax.lse[cc]);
        w_g = *reinterpret_cast<const float2*>(&ax.g[cc]);
        w_t = *reinterpret_cast<const int2*>(&ax.t[cc]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tok = DW ? c0 + cc + e : orow[hh], voc = DW ? orow[hh] : c0 + cc + e;
          const float lse = DW ? (e ? w_lse.y : w_lse.x) : o_lse[hh];
          const float g = DW ? (e ? w_g.y : w_g.x) : o_g[hh];
          const int tgt = DW ? (e ? w_t.y : w_t.x) : o_t[hh];
          float d = 0.f;
          if (orow[hh] < owned_total && (inner || (DW ? tok < p.N : voc < p.V))) {
            const float pr = expf(__fsub_rn(z[4 * j + 2 * hh + e], lse));
            float tm = (voc == tgt) ? p.one_minus_eps : 0.f;
            if (p.smoothing) tm = __fadd_rn(tm, p.eps_d);
            d = __fmul_rn(__fsub_rn(pr, tm), g);
          }
          dl[e] = d;
        }
        const uint32_t h = pack2<bf16>(dl[0], dl[1]);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&h);
        hf[2 * j + hh] = h;
        lf[2 * j + hh] = pack2<bf16>(__fsub_rn(dl[0], __low2float(hv)), __fsub_rn(dl[1], __high2float(hv)));
      }
    }

    // acc += dlog_hi W_slab, then += dlog_lo W_slab (A from registers, the
    // staged walked boxes read MN-major): one batch of 8 nb wgmma.
#pragma unroll
    for (int b = 0; b < tc::BOXES; ++b) fence_regs(acc[b]);
    fence_regs(hf);
    fence_regs(lf);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < tc::BOXES; ++b) {
      if (b < nb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n64_rs<bf16>(acc[b], hf + 4 * kk, desc_sw128_mn(st + b * tc::WALK_BOX + 2048 * kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n64_rs<bf16>(acc[b], lf + 4 * kk, desc_sw128_mn(st + b * tc::WALK_BOX + 2048 * kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < tc::BOXES; ++b) fence_regs(acc[b]);
    fence_regs(hf);
    fence_regs(lf);
    mbar_arrive(empty + 8 * s);
    if (next) {
      tc::cluster_wait();  // R_it+1
      tc::cluster_arrive();  // F_it+1
    }
  }
  if (n > 0) tc::cluster_wait();  // F_n-1: no peer reads this CTA's shared memory any more

  // The slab's sum: bf16 into out at one chunk, else fp32 into the chunk's partials.
  const long long part0 = static_cast<long long>(blockIdx.z) * owned_total;
#pragma unroll
  for (int b = 0; b < tc::BOXES; ++b) {
    if (b >= nb) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (orow[hh] >= owned_total) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + 64 * b + 8 * j + 2 * qd;  // d + 1 < D too: D is a multiple of 8
        if (d >= p.D) continue;
        const float v0 = acc[b][4 * j + 2 * hh], v1 = acc[b][4 * j + 2 * hh + 1];
        if (p.out != nullptr)
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + static_cast<long long>(orow[hh]) * p.D + d) =
              pack2<bf16>(v0, v1);
        else
          *reinterpret_cast<float2*>(p.part + (part0 + orow[hh]) * p.D + d) = make_float2(v0, v1);
      }
    }
  }
}

// ------------------------------------------------ tensor-core forward

namespace fwd {

constexpr int ROWS = 128;               // x rows a CTA: two consumer warpgroups of 64
constexpr int COLS = 256;               // vocab columns a tile: wgmma n = 256
constexpr int X_BOX = ROWS * 128;       // bytes of an x box [128 rows, 64 of D]
constexpr int W_BOX = COLS * 128;       // bytes of a w box [256 rows, 64 of D]
constexpr int STAGE = X_BOX + W_BOX;    // 48 KB
constexpr int STAGES = 4;
constexpr int THREADS = 384;            // two consumer warpgroups and a producer warpgroup
// One CTA an SM (its ring takes 192 KB): after setmaxnreg the consumers have
// 232 registers (128 of them a tile's fp32 z) and the producer 40.
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + 8 * 2 * STAGES;

#define SMP_Z8(i)                                                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define SMP_Z128                                                                                               \
  SMP_Z8(0), SMP_Z8(8), SMP_Z8(16), SMP_Z8(24), SMP_Z8(32), SMP_Z8(40), SMP_Z8(48), SMP_Z8(56), SMP_Z8(64),  \
      SMP_Z8(72), SMP_Z8(80), SMP_Z8(88), SMP_Z8(96), SMP_Z8(104), SMP_Z8(112), SMP_Z8(120)
#define SMP_Z128_STR                                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "   \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "    \
  "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "  \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "       \
  "%123, %124, %125, %126, %127}"

// d[64 x 256] (+)= A[64 x 16] B[256 x 16]^T, both K-major in shared memory
// (128-byte swizzle); scale_d = 0 overwrites d. E: __nv_bfloat16 or __half.
template <typename E> __device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_n256<__nv_bfloat16>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SMP_Z128_STR ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SMP_Z128
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_n256<__half>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " SMP_Z128_STR ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SMP_Z128
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef SMP_Z8
#undef SMP_Z128
#undef SMP_Z128_STR

// The sum, and the largest, over the four threads of a quad (which hold the
// columns of the same two rows).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

}  // namespace fwd

// The forward on the tensor cores, fp16 or bf16; SMOOTH: the logit sum under
// smoothing. Grid (row blocks of 128, vocab chunks): a CTA walks the 256-wide
// vocab tiles of its chunk; for each, z = x w^T over D streamed in 64-wide
// k-blocks (x [128, 64] and w [256, 64] boxes by TMA, 128-byte swizzle, a ring
// of 4 stages that runs on across tiles), then the online update of each row's
// (m, l, tgt, sum) on the fp32 accumulators in registers. Writes the same
// partials part[q][chunk][row], q < 4, as fused_ce_fwd_kernel; columns >= V
// (w rows TMA reads as zeros) count as -1e30 and not in the sum.
template <typename E, bool SMOOTH>
__global__ void __launch_bounds__(fwd::THREADS, 1)
fused_ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                          const Params p) {
  using namespace smp_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  const uint32_t st = smem_u32(smem), full = st + fwd::STAGES * fwd::STAGE, empty = full + 8 * fwd::STAGES;
  const int r0 = blockIdx.x * fwd::ROWS, chunk = blockIdx.y;
  const int v_tiles = (p.V + fwd::COLS - 1) / fwd::COLS;
  const int tile0 = chunk * p.chunk_tiles, tile1 = min(tile0 + p.chunk_tiles, v_tiles);
  const int kblocks = (p.D + 63) / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < fwd::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<fwd::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int it = 0;  // k-blocks issued so far: stage it % STAGES, round it / STAGES
      for (int tile = tile0; tile < tile1; ++tile)
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % fwd::STAGES;
          mbar_wait(empty + 8 * s, ((it / fwd::STAGES) & 1) ^ 1);  // the first round finds every stage free
          mbar_arrive_expect_tx(full + 8 * s, fwd::STAGE);
          tma_load_2d(st + s * fwd::STAGE, &mx, full + 8 * s, 64 * kb, r0);
          tma_load_2d(st + s * fwd::STAGE + fwd::X_BOX, &mw, full + 8 * s, 64 * kb, tile * fwd::COLS);
        }
    }
    return;
  }

  // Consumer warpgroups: rows r0 + 64 wg .. r0 + 64 wg + 63.
  setmaxnreg_inc<fwd::CONSUMER_REGS>();
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, qd = lane & 3;
  int row[2], tgt[2];  // the thread's two rows (accumulator rows lane / 4 and + 8 of its warp's 16)
  float m[2], l[2], tg[2], sm[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = r0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hh;
    const int tt = row[hh] < p.N ? p.t[row[hh]] : -1;
    tgt[hh] = tt >= 0 && tt < p.V ? tt : -1;  // a target outside [0, V) never hits
    m[hh] = NEG_INF;
    l[hh] = tg[hh] = sm[hh] = 0.f;
  }
  int it = 0;  // k-blocks consumed so far, as the producer counts them
  for (int tile = tile0; tile < tile1; ++tile) {
    float z[128];  // columns n0 + 8j + 2(lane % 4) + e of rows row[hh]: z[4j + 2hh + e]
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % fwd::STAGES;
      mbar_wait(full + 8 * s, (it / fwd::STAGES) & 1);
      const uint32_t a = st + s * fwd::STAGE + wg * 64 * 128, bw = st + s * fwd::STAGE + fwd::X_BOX;
      fence_regs(z);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fwd::wgmma_n256<E>(z, desc_sw128(a + 32 * kk), desc_sw128(bw + 32 * kk), kb | kk);
      wgmma_commit();
      wgmma_wait<1>();  // k-block kb - 1 is done: release its stage while kb runs
      fence_regs(z);
      if (kb > 0) mbar_arrive(empty + 8 * ((it - 1) % fwd::STAGES));
    }
    wgmma_wait<0>();
    fence_regs(z);
    mbar_arrive(empty + 8 * ((it - 1) % fwd::STAGES));  // the producer loads the next tile meanwhile

    // The online update, in fused_ce_fwd_kernel's order: columns >= V (only
    // in the last tile: masked) at -1e30, the tile's row max, then l, the
    // target logit and the logit sum.
    const int n0 = tile * fwd::COLS;
    auto update = [&](auto masked) {
      constexpr bool M = decltype(masked)::value;
      float mx[2] = {NEG_INF, NEG_INF}, hit[2] = {0.f, 0.f}, vs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, c = n0 + 8 * j + 2 * qd + e;
            float v = z[i];
            if (M && c >= p.V) v = NEG_INF;
            else if (SMOOTH) vs[hh] += v;
            if (c == tgt[hh]) hit[hh] += v;
            mx[hh] = fmaxf(mx[hh], v);
            z[i] = v;
          }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], fwd::quad_max(mx[hh]));
        float ex = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) ex += expf(z[4 * j + 2 * hh] - m_new) + expf(z[4 * j + 2 * hh + 1] - m_new);
        l[hh] = l[hh] * expf(m[hh] - m_new) + fwd::quad_sum(ex);
        m[hh] = m_new;
        tg[hh] += fwd::quad_sum(hit[hh]);
        if (SMOOTH) sm[hh] += fwd::quad_sum(vs[hh]);
      }
    };
    if (n0 + fwd::COLS > p.V) update(std::true_type());
    else update(std::false_type());
  }

  if (qd == 0) {
    const long long plane = static_cast<long long>(gridDim.y) * p.N;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row[hh] >= p.N) continue;
      const long long o = static_cast<long long>(chunk) * p.N + row[hh];
      p.part[o] = m[hh];
      p.part[plane + o] = l[hh];
      p.part[2 * plane + o] = tg[hh];
      p.part[3 * plane + o] = sm[hh];
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename E>
cudaError_t launch_fwd(const Params& p, float* lse, float* tgt, float* lsum, cudaStream_t s) {
  const int chunks = ceil_div(ceil_div(p.V, BT), p.chunk_tiles);
  fused_ce_fwd_kernel<E><<<dim3(ceil_div(p.N, BT), chunks), NT, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_fwd_merge<<<ceil_div(p.N, 256), 256, 0, s>>>(p.part, chunks, p.N, lse, tgt, lsum);
  return cudaGetLastError();
}

template <typename E, bool SMOOTH>
cudaError_t launch_fwd_wgmma(const Params& p, CUtensorMapDataType type, float* lse, float* tgt, float* lsum,
                             cudaStream_t s) {
  CUtensorMap mx, mw;
  if (!smp_tc::encode_rows(&mx, type, 2, p.x, p.N, p.D, fwd::ROWS) ||
      !smp_tc::encode_rows(&mw, type, 2, p.w, p.V, p.D, fwd::COLS))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_ce_fwd_wgmma_kernel<E, SMOOTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int chunks = ceil_div(ceil_div(p.V, fwd::COLS), p.chunk_tiles);
  fused_ce_fwd_wgmma_kernel<E, SMOOTH>
      <<<dim3(ceil_div(p.N, fwd::ROWS), chunks), fwd::THREADS, fwd::SMEM_BYTES, s>>>(mx, mw, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_fwd_merge<<<ceil_div(p.N, 256), 256, 0, s>>>(p.part, chunks, p.N, lse, tgt, lsum);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_bwd(const Params& p, bool dw, void* out, cudaStream_t s) {
  const int owned = dw ? p.V : p.N;
  const int walked = dw ? p.N : p.V;
  const int chunks = ceil_div(ceil_div(walked, BT), p.chunk_tiles);
  const dim3 grid(ceil_div(owned, BT), chunks);
  if (dw) fused_ce_bwd_kernel<E, true><<<grid, NT, 0, s>>>(p);
  else fused_ce_bwd_kernel<E, false><<<grid, NT, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)owned * p.D;
  if (n == 0) return cudaSuccess;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  fused_ce_reduce<E><<<blocks, 256, 0, s>>>(p.part, chunks, n, static_cast<E*>(out));
  return cudaGetLastError();
}

template <bool DW>
cudaLaunchConfig_t wgmma_config(const Params& p, int chunks, cudaLaunchAttribute* attr, cudaStream_t s) {
  const int S = ceil_div(p.D, tc::SLAB);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, ceil_div(DW ? p.V : p.N, tc::OWN_ROWS), chunks);
  cfg.blockDim = dim3(tc::THREADS, 1, 1);
  cfg.dynamicSmemBytes = tc::SMEM_BYTES;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool DW>
cudaError_t launch_bwd_wgmma(Params p, cudaStream_t s) {
  using namespace smp_tc;
  const int owned = DW ? p.V : p.N, walked = DW ? p.N : p.V;
  CUtensorMap m_own, m_walk;
  if (!encode_rows(&m_own, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, DW ? p.w : p.x, owned, p.D, tc::OWN_ROWS) ||
      !encode_rows(&m_walk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, DW ? p.x : p.w, walked, p.D, tc::WALK_ROWS))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_ce_bwd_wgmma_kernel<DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int chunks = ceil_div(ceil_div(walked, tc::WALK_ROWS), p.chunk_tiles);
  void* out = p.out;
  if (chunks > 1) p.out = nullptr;  // each chunk's sum into the partials
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgmma_config<DW>(p, chunks, &attr, s);
  err = cudaLaunchKernelEx(&cfg, fused_ce_bwd_wgmma_kernel<DW>, m_own, m_walk, p);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const long long n = (long long)owned * p.D;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  fused_ce_reduce<__nv_bfloat16><<<blocks, 256, 0, s>>>(p.part, chunks, n, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

// What the tensor-core backward takes: bf16, D a multiple of 8 (16-byte TMA
// rows) up to 256 x the portable cluster size, 16-byte aligned bases.
bool wgmma_ok(int dtype, const void* x, const void* w, int D) {
  return dtype == 2 && D > 0 && D % 8 == 0 && D <= tc::SLAB * tc::MAX_CLUSTER &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 fp16, 2 bf16, shared by x and w (and dx, dW). x [N, D] and
// w [V, D] are contiguous row-major; targets int32 [N]; lse, g fp32 [N].
// lsum: logit_sum's output under smoothing, else null.
// chunk_tiles: 64-wide tiles of the walked dimension (vocab for the forward
// and dx, rows for dW) per CTA. part: fp32 scratch of 4 * chunks * N floats
// (forward) or chunks * (N for dx, V for dW) * D floats (backward), chunks =
// ceil(tiles / chunk_tiles). Each returns a cudaError_t (0 = launched).
int smp_fused_ce_fwd(int dtype, const void* x, const void* w, const int* t, int N, int V, int D,
                     int smoothing, int chunk_tiles, float* part, float* lse, float* tgt,
                     float* lsum, void* stream) {
  if (N < 1 || V < 1 || D < 0 || chunk_tiles < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.w = w; p.t = t; p.part = part;
  p.N = N; p.V = V; p.D = D; p.smoothing = smoothing; p.chunk_tiles = chunk_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(p, lse, tgt, lsum, s);
    case 1: return (int)launch_fwd<__half>(p, lse, tgt, lsum, s);
    case 2: return (int)launch_fwd<__nv_bfloat16>(p, lse, tgt, lsum, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route of the forward: dtype 1 (fp16) or 2 (bf16), x and w
// 16-byte aligned and D a positive multiple of 8 (anything else is refused,
// never sent to the other kernel); chunk_tiles counts 256-wide vocab tiles,
// part holds 4 * chunks * N floats; the rest as above.
int smp_fused_ce_fwd_wgmma(int dtype, const void* x, const void* w, const int* t, int N, int V, int D,
                           int smoothing, int chunk_tiles, float* part, float* lse, float* tgt, float* lsum,
                           void* stream) {
  if (N < 1 || V < 1 || D <= 0 || D % 8 != 0 || chunk_tiles < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.w = w; p.t = t; p.part = part;
  p.N = N; p.V = V; p.D = D; p.smoothing = smoothing; p.chunk_tiles = chunk_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr CUtensorMapDataType f16 = CU_TENSOR_MAP_DATA_TYPE_FLOAT16, bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  switch (dtype) {
    case 1:
      return (int)(smoothing ? launch_fwd_wgmma<__half, true>(p, f16, lse, tgt, lsum, s)
                             : launch_fwd_wgmma<__half, false>(p, f16, lse, tgt, lsum, s));
    case 2:
      return (int)(smoothing ? launch_fwd_wgmma<__nv_bfloat16, true>(p, bf16, lse, tgt, lsum, s)
                             : launch_fwd_wgmma<__nv_bfloat16, false>(p, bf16, lse, tgt, lsum, s));
    default: return (int)cudaErrorInvalidValue;
  }
}

// The CUDA-core route. dw = 0: dx [N, D] into out; dw = 1: dW [V, D] into
// out (x's dtype).
int smp_fused_ce_bwd(int dtype, int dw, const void* x, const void* w, const int* t,
                     const float* lse, const float* g, int N, int V, int D, int smoothing,
                     float one_minus_eps, float eps_d, int chunk_tiles, float* part, void* out,
                     void* stream) {
  if (N < 1 || V < 1 || D < 0 || chunk_tiles < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.w = w; p.t = t; p.lse = lse; p.g = g; p.part = part;
  p.N = N; p.V = V; p.D = D; p.smoothing = smoothing;
  p.one_minus_eps = one_minus_eps; p.eps_d = eps_d; p.chunk_tiles = chunk_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(p, dw != 0, out, s);
    case 1: return (int)launch_bwd<__half>(p, dw != 0, out, s);
    case 2: return (int)launch_bwd<__nv_bfloat16>(p, dw != 0, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route of the same: dtype 2 (bf16) only, x and w 16-byte
// aligned and D a multiple of 8 up to 2048 (anything else is refused, never
// sent to the other kernel). chunk_tiles: 64-row tiles of the walked
// dimension per cluster; at one chunk the kernel writes out and part may be
// null, else part holds chunks * (N for dx, V for dW) * D floats.
int smp_fused_ce_bwd_wgmma(int dtype, int dw, const void* x, const void* w, const int* t, const float* lse,
                           const float* g, int N, int V, int D, int smoothing, float one_minus_eps, float eps_d,
                           int chunk_tiles, float* part, void* out, void* stream) {
  if (N < 1 || V < 1 || chunk_tiles < 1 || !wgmma_ok(dtype, x, w, D)) return (int)cudaErrorInvalidValue;
  if (ceil_div(ceil_div(dw ? N : V, tc::WALK_ROWS), chunk_tiles) > 1 && part == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.w = w; p.t = t; p.lse = lse; p.g = g; p.part = part; p.out = out;
  p.N = N; p.V = V; p.D = D; p.smoothing = smoothing;
  p.one_minus_eps = one_minus_eps; p.eps_d = eps_d; p.chunk_tiles = chunk_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dw ? launch_bwd_wgmma<true>(p, s) : launch_bwd_wgmma<false>(p, s));
}

// How many clusters of the tensor-core backward (dw: the dW kernel) at this
// D can be resident on the current device at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
int smp_fused_ce_bwd_wgmma_clusters(int dw, int D) {
  if (D <= 0 || D > tc::SLAB * tc::MAX_CLUSTER) return -(int)cudaErrorInvalidValue;
  Params p = {};
  p.N = p.V = 1; p.D = D;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      dw ? wgmma_config<true>(p, 1, &attr, nullptr) : wgmma_config<false>(p, 1, &attr, nullptr);
  const void* kernel =
      dw ? (const void*)fused_ce_bwd_wgmma_kernel<true> : (const void*)fused_ce_bwd_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
