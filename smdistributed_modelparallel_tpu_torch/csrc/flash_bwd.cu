// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_attention.py
//   _bwd_dq_kernel  -> flash_bwd_dq_wgmma_kernel (tensor cores) and
//                      flash_bwd_dq_kernel (CUDA cores)      (dq pass)
//   _bwd_dkv_kernel -> flash_bwd_dkv_wgmma_kernel and
//                      flash_bwd_dkv_kernel                  (dk/dv pass)
//   both launched by _flash_bwd_impl through pl.pallas_call, the backward of
//   flash_attention's custom_vjp. Python wrappers and plain PyTorch versions:
//   smdistributed_modelparallel_tpu_torch/ops/flash_attention.py, whose
//   _route picks the kernel by the operands alone: fp16/bf16 with hd 64 and
//   TMA's strides and alignment take the tensor cores, the rest (fp32, other
//   head dims) the CUDA cores. Neither route stands in for the other.
//
// What they compute, per (batch, head), query row r and kv column c, from
// the forward's saved lse and delta = rowsum(dO * O) (computed by the
// wrapper in fp32, as the JAX package computes it outside its kernels):
//   s      = (q_r . k_c) * scale + kpad[b, c]                       (fp32)
//   p      = keep(r, c) ? exp(s - lse_r) : 0
//   dp     = dO_r . v_c;  under dropout dp = drop(r, c) ? 0 : dp / (1 - rate)
//   p_drop = dropout ? (drop(r, c) ? 0 : p / (1 - rate)) : p
//   ds     = p * (dp - delta_r) * scale                             (fp32)
//   dq_r   = sum_c round_k(ds) * k_c
//   dk_c   = sum_r round_q(ds) * q_r          (q unscaled: ds holds the scale)
//   dv_c   = sum_r round_dO(p_drop) * dO_r
// with fp32 accumulation and the outputs rounded to the input dtype: the
// TPU kernels' rounding points, kept exactly. keep is the TPU kernel's
// _tile_mask (c < S, r < T, causal, window band). Rows whose forward saw
// only masked columns are not special-cased: exp(s - lse) in fp32 gives
// what it gives (with kpad = -1e30 both are -1e30 and p = 1), as on the TPU.
// The dropout bits come from the same counter hash (_dropout_keep) with the
// head remap (_bh_remap) and row stride s_total.
//
// Visited ranges. The TPU kernels walk _kv_bounds (dq) and _q_bounds (dk/dv)
// of their own tiling. Those ranges contain every kept (r, c) and p = 0
// elsewhere, so they decide nothing: these kernels walk only the tiles
// that hold kept pairs of their own tiles (64 rows; 32 for hd > 128 on the
// CUDA cores).
//
// Bound on an H100: at the training path's shape (B=2, T=S=1024, H=12,
// hd=64, bf16, causal, per microbatch) the dq kernel does three
// [pairs x hd] products (s, dp, dq: 4.84 GFLOP over 15.9 MB of q, k, v,
// dO, lse, delta in and dq out) and the dk/dv kernel four (s, dp, dv, dk:
// 6.45 GFLOP over 19.1 MB): 4.9 and 6.5 us of tensor-core time against 4.8
// and 5.7 us of memory time. Both are operation-bound.
//
// Tensor-core route (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel;
// csrc/tma_wgmma.cuh's pieces). The TPU kernels round ds and p_drop to the
// operand dtype and take fp32-accumulating dots: exactly the operands and
// accumulators of a 16-bit wgmma, so only the summation order changes.
//   - dk/dv: one CTA per (64 kv rows, batch*head), two CTAs an SM. A
//     consumer warpgroup keeps the K and V tiles of its kv rows in shared
//     memory; one producer thread streams the q tiles (64 rows) that hold
//     kept pairs, Q and dO by TMA (128-byte swizzle) through a ring of 3
//     stages, and its warp writes lse, delta and the q ids beside them. Per q
//     tile: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands
//     K-major; one batch of eight), grad_p and grad_ds on each accumulator
//     element at its (q column, kv row), p_drop and ds rounded to the input
//     dtype as register A fragments, then dV += P_drop^T dO and dK += dS^T Q
//     (dO and Q read MN-major; one batch of eight). The two CTAs of an SM
//     overlap one's elementwise work with the other's products.
//   - dq: the same turned around: 64 q rows a CTA with Q and dO resident,
//     the kv tiles streamed, dQ += dS K.
//   - Warps whose 16 x 64 block is all kept skip the mask; the mask itself is
//     a per-row span (kept_span), not kept() per element; dropout is a
//     compile-time branch of the elementwise pass.
//   - Every batch of wgmma is waited for before the next instruction that
//     defines a register a wgmma reads or accumulates into (its A fragments,
//     descriptors, accumulators): ptxas serializes every wgmma of a kernel
//     (C7513, C7515) when one such register is defined while a batch is open,
//     and overlapping the elementwise work with a batch in flight did that.
//   - No atomics: every output element is summed by one thread in a fixed
//     order, so two launches on the same inputs give equal bits.
//   - CTAs whose causal walk is longest launch first (kv tile 0 for dk/dv,
//     the last q tile for dq). A CTA has one consumer warpgroup, so its
//     producer skips exactly the tiles that consumer has no kept pair in;
//     with two consumers a CTA would have to skip per warpgroup, and a
//     consumer that skips past the stage its products still read holds up
//     the ring.
// Not yet used: warp-specialized ping-pong between two consumers, 2-CTA
// clusters, TMA multicast of the streamed tiles.
//
// CUDA-core route, in its simplest right form (as csrc/flash_fwd.cu):
//   - dq: one CTA of 256 threads per (BT query rows, batch*head), looping
//     over the kv tiles with kept pairs; Q and dO tiles stay in shared
//     memory, K and V tiles stream through it;
//   - dk/dv: one CTA per (BT kv rows, batch*head), looping over the q tiles
//     with kept pairs; K and V stay, Q, dO, lse and delta stream;
//   - tiles staged as fp32 in shared memory, so one code path serves fp32,
//     fp16 and bf16 (products of bf16/fp16 values are exact in fp32, as the
//     reference's fp32-accumulating dots are);
//   - all products by plain FMA: each thread owns a (BT/16)x(BT/16) block of
//     the score tile (rows ty+16i, cols tx+16j) and (BT/16) rows x hd/16
//     columns of each accumulator; no cross-thread reduction is needed, the
//     backward has no softmax.
// They serve fp32 and the head dims the tensor-core kernels do not take.
//
// Ids mode (q_ids, kv_ids non-null) replaces the same two TPU kernels with
// has_ids=True (flash_bwd_with_ids: one (q block, kv block) pair of a
// context-parallel ring step, from the GLOBAL lse and delta): keep(r, c) is
// r < T && c < S && (!causal || kv_ids[c] <= q_ids[r]), dropout hashes the
// ids with the counter_len stride, and dq, dk and dv are written in fp32
// (the ring accumulates them in fp32). The TPU kernels skip a reference
// block pair whose smallest column id exceeds its largest row id; such a
// pair is all masked (p = 0), so these kernels skip at their own 64-row
// tiles instead, which is exact.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tma_wgmma.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA (16 x 16)

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

// _dropout_keep's lowbias32-style hash of the global (bh, row, col) position.
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t bh, uint32_t row,
                                                 uint32_t col, uint32_t s_total) {
  uint32_t x = bh * 0x9E3779B9u + row * s_total + col;
  x += seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct Params {
  const void* q;      // [B, T, H, hd]
  const void* k;      // [B, S, H, hd]
  const void* v;      // [B, S, H, hd]
  const void* dout;   // [B, T, H, hd]
  const float* lse;   // [B, H, T] fp32
  const float* delta; // [B, H, T] fp32
  const float* kpad;  // [B or 1, S] fp32, or null
  const int* q_ids;   // [T] global row ids, or null: ids mode when set
  const int* kv_ids;  // [S] global column ids
  void* dq;           // [B, T, H, hd]; fp32 in ids mode, as dk and dv
  void* dk;           // [B, S, H, hd]
  void* dv;           // [B, S, H, hd]
  int B, T, S, H, hd;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  long long kpad_sb;
  float scale;
  int causal;
  int window;  // <= 0: none
  int has_dropout;
  uint32_t seed, keep_threshold, s_total;
  float inv_keep;
  int head0, head_total;  // dropout hash coordinates
};

constexpr int IDS_NONE = 1 << 30;  // above every id

// _tile_mask for one (row, col), or _ids_mask with the ids qid, kid; r, c >= 0.
__device__ __forceinline__ bool kept(const Params& p, int r, int c, int qid, int kid) {
  if (r >= p.T || c >= p.S) return false;
  if (p.q_ids) return !p.causal || kid <= qid;
  const int d = r + (p.S - p.T) - c;  // >= 0 on and below the causal diagonal
  if (p.causal) return d >= 0 && (p.window <= 0 || d < p.window);
  return p.window <= 0 || abs(d) < p.window;
}

// Rows [r0, r0 + BT) of an id vector of `n` entries into shared memory,
// IDS_NONE past n; then the largest (or smallest) valid one, read from
// shared memory by every thread after the caller's __syncthreads().
template <int BT>
__device__ __forceinline__ void load_ids(int* dst, const int* src, int r0, int n) {
  for (int i = threadIdx.x; i < BT; i += NT) dst[i] = r0 + i < n ? src[r0 + i] : IDS_NONE;
}

template <int BT>
__device__ __forceinline__ int ids_max(const int* ids) {
  int m = -1;
  for (int i = 0; i < BT; ++i) m = max(m, ids[i] == IDS_NONE ? -1 : ids[i]);
  return m;
}

template <int BT>
__device__ __forceinline__ int ids_min(const int* ids) {
  int m = IDS_NONE;
  for (int i = 0; i < BT; ++i) m = min(m, ids[i]);
  return m;
}

// ds and p_drop of one (row, col), in the reference's fp32 order, in two
// steps: grad_p (p and p_drop from s; returns whether dropout keeps the pair,
// true without dropout), then grad_ds (ds from p, dp and that bit); D says
// whether dropout is on. The __f*_rn intrinsics keep nvcc from contracting a
// multiply and an add into an FMA the reference does not do. keep: kept(...)
// of the pair; kpad_c: the column's kpad (read only when has_kpad).
// (hrow, hcol) are the dropout hash's row and column: the local indices, or
// the ids in ids mode.
template <bool D>
__device__ __forceinline__ bool grad_p(const Params& p, bool keep, float s, bool has_kpad, float kpad_c, float lse,
                                       int hrow, int hcol, uint32_t bh_hash, float& pr, float& p_drop) {
  pr = 0.f;
  if (keep) {
    float x = __fmul_rn(s, p.scale);
    if (has_kpad) x = __fadd_rn(x, kpad_c);
    pr = expf(__fsub_rn(x, lse));
  }
  p_drop = pr;
  if (!D) return true;
  const bool kd = dropout_bits(p.seed, bh_hash, (uint32_t)hrow, (uint32_t)hcol, p.s_total) >= p.keep_threshold;
  p_drop = kd ? __fmul_rn(pr, p.inv_keep) : 0.f;
  return kd;
}

template <bool D>
__device__ __forceinline__ float grad_ds(const Params& p, float pr, float dp, float delta, bool kd) {
  if (D) dp = kd ? __fmul_rn(dp, p.inv_keep) : 0.f;
  return __fmul_rn(__fmul_rn(pr, __fsub_rn(dp, delta)), p.scale);
}

__device__ __forceinline__ void grad_elem(const Params& p, bool keep, float s, float dp, bool has_kpad,
                                          float kpad_c, float lse, float delta, int hrow, int hcol,
                                          uint32_t bh_hash, float& ds, float& p_drop) {
  float pr;
  if (p.has_dropout) {
    const bool kd = grad_p<true>(p, keep, s, has_kpad, kpad_c, lse, hrow, hcol, bh_hash, pr, p_drop);
    ds = grad_ds<true>(p, pr, dp, delta, kd);
  } else {
    grad_p<false>(p, keep, s, has_kpad, kpad_c, lse, hrow, hcol, bh_hash, pr, p_drop);
    ds = grad_ds<false>(p, pr, dp, delta, true);
  }
}

// Whether every pair of rows [r0, r0 + nr) and columns [c0, c0 + nc) is kept
// (kept() outside ids mode), and whether none is.
__device__ __forceinline__ bool all_kept(const Params& p, int r0, int nr, int c0, int nc) {
  if (r0 + nr > p.T || c0 + nc > p.S) return false;
  const int dmin = r0 + (p.S - p.T) - (c0 + nc - 1), dmax = r0 + nr - 1 + (p.S - p.T) - c0;
  if (p.causal) return dmin >= 0 && (p.window <= 0 || dmax < p.window);
  return p.window <= 0 || max(-dmin, dmax) < p.window;
}

__device__ __forceinline__ bool none_kept(const Params& p, int r0, int nr, int c0, int nc) {
  if (r0 >= p.T || c0 >= p.S) return true;
  const int dmin = r0 + (p.S - p.T) - (min(c0 + nc, p.S) - 1), dmax = min(r0 + nr, p.T) - 1 + (p.S - p.T) - c0;
  if (p.causal) return dmax < 0 || (p.window > 0 && dmin >= p.window);
  return p.window > 0 && (dmax <= -p.window || dmin >= p.window);
}

// The columns [lo, hi) that kept() keeps in row r (outside ids mode); the
// rows [lo, hi) it keeps in column c with by_col.
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span kept_span(const Params& p, int x, bool by_col) {
  const int off = p.S - p.T;
  const int n = by_col ? p.T : p.S;  // the extent of the span's dimension
  if (x >= (by_col ? p.S : p.T)) return {0, 0};
  const int d0 = by_col ? x - off : x + off;  // the diagonal's index in that dimension
  if (p.causal) {
    if (by_col) return {max(0, d0), p.window > 0 ? min(n, d0 + p.window) : n};
    return {p.window > 0 ? max(0, d0 - p.window + 1) : 0, min(n, d0 + 1)};
  }
  if (p.window > 0) return {max(0, d0 - p.window + 1), min(n, d0 + p.window)};
  return {0, n};
}

// grad_elem of the pair (r, c), kpad read from the [S] row `kpad` (or null).
__device__ __forceinline__ void grad_pair(const Params& p, float s, float dp, float lse,
                                          float delta, int r, int c, int hrow, int hcol,
                                          const float* kpad, uint32_t bh_hash, float& ds,
                                          float& p_drop) {
  const bool keep = kept(p, r, c, hrow, hcol);
  grad_elem(p, keep, s, dp, kpad != nullptr, keep && kpad ? kpad[c] : 0.f, lse, delta, hrow, hcol, bh_hash, ds,
            p_drop);
}

// One output element: fp32 in ids mode, else the input dtype.
template <typename E>
__device__ __forceinline__ void store(const Params& p, void* base, long long at, float x) {
  if (p.q_ids) static_cast<float*>(base)[at] = x;
  else static_cast<E*>(base)[at] = from_f<E>(x);
}

// Rows [r0, r0 + BT) of a [rows, hd] operand into an fp32 tile, zero-filled
// past `rows` and hd.
template <typename E, int HD, int BT>
__device__ __forceinline__ void load_tile(float* dst, const E* src, long long stride, int r0,
                                          int rows, int hd) {
  constexpr int LD = HD + 4;
  for (int e = threadIdx.x; e < BT * HD; e += NT) {
    const int rr = e / HD, d = e % HD;
    const int r = r0 + rr;
    dst[rr * LD + d] = (r < rows && d < hd) ? to_f<E>(src[r * stride + d]) : 0.f;
  }
}

// s[i][j] = A[ty+16i] . B[tx+16j] and t[i][j] = C[ty+16i] . D[tx+16j] over
// HD columns of four fp32 tiles.
template <int HD, int R>
__device__ __forceinline__ void two_products(const float* A, const float* Bm, const float* C,
                                             const float* D, int tx, int ty, float (&s)[R][R],
                                             float (&t)[R][R]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[R], b[R], c[R], e[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
      c[i] = *reinterpret_cast<const float4*>(&C[(ty + 16 * i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      b[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * LD + d]);
      e[j] = *reinterpret_cast<const float4*>(&D[(tx + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        t[i][j] = fmaf(c[i].x, e[j].x, t[i][j]);
        t[i][j] = fmaf(c[i].y, e[j].y, t[i][j]);
        t[i][j] = fmaf(c[i].z, e[j].z, t[i][j]);
        t[i][j] = fmaf(c[i].w, e[j].w, t[i][j]);
      }
  }
}

template <typename E, int HD, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = HD + 4;   // row stride of the operand tiles in floats
  constexpr int LDS = BT + 4;  // row stride of the ds tile in floats
  constexpr int R = BT / 16;   // score rows / cols per thread
  constexpr int NJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BT * LD;
  float* sK = sDO + BT * LD;
  float* sV = sK + BT * LD;
  float* sDS = sV + BT * LD;
  int* sQid = reinterpret_cast<int*>(sDS + BT * LDS);  // ids mode
  int* sKid = sQid + BT;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int r0 = blockIdx.y * BT;
  const int T = p.T, S = p.S, off = S - T;

  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const E* dout = static_cast<const E*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kpad = p.kpad ? p.kpad + b * p.kpad_sb : nullptr;
  const uint32_t bh_hash = (uint32_t)(b * p.head_total + p.head0 + h);

  load_tile<E, HD, BT>(sQ, q, p.q_st, r0, T, p.hd);
  load_tile<E, HD, BT>(sDO, dout, p.do_st, r0, T, p.hd);
  const bool ids = p.q_ids != nullptr;
  if (ids) load_ids<BT>(sQid, p.q_ids, r0, T);
  float lse[R], delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + ty + 16 * i;
    lse[i] = r < T ? p.lse[(long long)bh * T + r] : 0.f;
    delta[i] = r < T ? p.delta[(long long)bh * T + r] : 0.f;
  }

  // Columns kept by some row of this tile.
  const int r_last = min(r0 + BT, T) - 1;
  int c_begin = 0, c_end = S;
  if (ids) {
    // every tile; under causal those with no kept pair are skipped below
  } else if (p.causal) {
    c_end = min(S, r_last + off + 1);
    if (p.window > 0) c_begin = max(0, r0 + off - p.window + 1);
  } else if (p.window > 0) {
    c_begin = max(0, r0 + off - p.window + 1);
    c_end = min(S, r_last + off + p.window);
  }

  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int rmax = 0;
  if (ids) {
    __syncthreads();
    rmax = ids_max<BT>(sQid);
  }
  for (int c0 = c_begin; c0 < c_end; c0 += BT) {
    __syncthreads();  // the previous K tile and ds tile are no longer read
    if (ids) {
      load_ids<BT>(sKid, p.kv_ids, c0, S);
      __syncthreads();
      if (p.causal && ids_min<BT>(sKid) > rmax) continue;  // no kept pair
    }
    load_tile<E, HD, BT>(sK, k, p.k_st, c0, S, p.hd);
    load_tile<E, HD, BT>(sV, v, p.v_st, c0, S, p.hd);
    __syncthreads();

    float s[R][R], dp[R][R];
    two_products<HD, R>(sQ, sK, sDO, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int rr = ty + 16 * i, cc = tx + 16 * j;
        float ds, p_drop;
        grad_pair(p, s[i][j], dp[i][j], lse[i], delta[i], r0 + rr, c0 + cc,
                  ids ? sQid[rr] : r0 + rr, ids ? sKid[cc] : c0 + cc, kpad, bh_hash, ds, p_drop);
        sDS[(ty + 16 * i) * LDS + tx + 16 * j] = to_f<E>(from_f<E>(ds));  // rounded to k's dtype
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float dsr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsr[i] = sDS[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kk = sK[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(dsr[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.hd) store<E>(p, p.dq, b * p.dq_sb + h * p.dq_sh + r * p.dq_st + d, acc[i][j]);
    }
  }
}

template <typename E, int HD, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = HD + 4;
  constexpr int LDS = BT + 4;
  constexpr int R = BT / 16;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sDO = sQ + BT * LD;
  float* sP = sDO + BT * LD;   // p_drop, rounded to dO's dtype: [q row][kv col]
  float* sDS = sP + BT * LDS;  // ds, rounded to q's dtype: [q row][kv col]
  float* sL = sDS + BT * LDS;
  float* sD = sL + BT;
  int* sKid = reinterpret_cast<int*>(sD + BT);  // ids mode
  int* sQid = sKid + BT;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int c0 = blockIdx.y * BT;
  const int T = p.T, S = p.S, off = S - T;

  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const E* dout = static_cast<const E*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kpad = p.kpad ? p.kpad + b * p.kpad_sb : nullptr;
  const float* lse_bh = p.lse + (long long)bh * T;
  const float* delta_bh = p.delta + (long long)bh * T;
  const uint32_t bh_hash = (uint32_t)(b * p.head_total + p.head0 + h);

  load_tile<E, HD, BT>(sK, k, p.k_st, c0, S, p.hd);
  load_tile<E, HD, BT>(sV, v, p.v_st, c0, S, p.hd);
  const bool ids = p.q_ids != nullptr;
  int cmin = 0;
  if (ids) {
    load_ids<BT>(sKid, p.kv_ids, c0, S);
    __syncthreads();
    cmin = ids_min<BT>(sKid);
  }

  // Rows that keep some column of this tile.
  const int c_last = min(c0 + BT, S) - 1;
  int r_begin = 0, r_end = T;
  if (ids) {
    // every tile; under causal those with no kept pair are skipped below
  } else if (p.causal) {
    r_begin = max(0, c0 - off);
    if (p.window > 0) r_end = min(T, c_last - off + p.window);
  } else if (p.window > 0) {
    r_begin = max(0, c0 - off - p.window + 1);
    r_end = min(T, c_last - off + p.window);
  }

  float dk[R][NJ], dv[R][NJ];  // kv cols ty+16i, head columns tx+16j
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BT) {
    __syncthreads();  // the previous Q/dO/P/ds tiles are no longer read
    if (ids) {
      load_ids<BT>(sQid, p.q_ids, r0, T);
      __syncthreads();
      if (p.causal && cmin > ids_max<BT>(sQid)) continue;  // no kept pair
    }
    load_tile<E, HD, BT>(sQ, q, p.q_st, r0, T, p.hd);
    load_tile<E, HD, BT>(sDO, dout, p.do_st, r0, T, p.hd);
    for (int rr = threadIdx.x; rr < BT; rr += NT) {
      const int r = r0 + rr;
      sL[rr] = r < T ? lse_bh[r] : 0.f;
      sD[rr] = r < T ? delta_bh[r] : 0.f;
    }
    __syncthreads();

    float s[R][R], dp[R][R];  // q rows ty+16i, kv cols tx+16j
    two_products<HD, R>(sQ, sK, sDO, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int rr = ty + 16 * i, cc = tx + 16 * j;
        float ds, p_drop;
        grad_pair(p, s[i][j], dp[i][j], sL[rr], sD[rr], r0 + rr, c0 + cc,
                  ids ? sQid[rr] : r0 + rr, ids ? sKid[cc] : c0 + cc, kpad, bh_hash, ds, p_drop);
        sP[rr * LDS + tx + 16 * j] = to_f<E>(from_f<E>(p_drop));
        sDS[rr * LDS + tx + 16 * j] = to_f<E>(from_f<E>(ds));
      }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < BT; ++rr) {
      float pc[R], dc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pc[i] = sP[rr * LDS + ty + 16 * i];
        dc[i] = sDS[rr * LDS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = sDO[rr * LD + tx + 16 * j];
        const float qq = sQ[rr * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i][j] = fmaf(pc[i], g, dv[i][j]);
          dk[i][j] = fmaf(dc[i], qq, dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.hd) {
        store<E>(p, p.dk, b * p.dk_sb + h * p.dk_sh + c * p.dk_st + d, dk[i][j]);
        store<E>(p, p.dv, b * p.dv_sb + h * p.dv_sh + c * p.dv_st + d, dv[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------ tensor cores

namespace tc {

constexpr int ROWS = 64;                 // rows of a CTA's resident tiles, and of each streamed tile
constexpr int TILE = smp_tc::HEAD_TILE;  // bytes of one [64, 64] 16-bit tile
constexpr int STAGE = 2 * TILE;          // a stage: two streamed tiles
constexpr int STAGES = 3;
constexpr int THREADS = 256;             // a consumer warpgroup and a producer warpgroup
// Two CTAs an SM: 128 registers a thread at launch; after setmaxnreg the
// consumer has 216 and the producer 40 (128 x 216 + 128 x 40 = 32768).
constexpr int CONSUMER_REGS = 216, PRODUCER_REGS = 40;

// What the producer warp writes beside each stage's two tiles.
struct Aux {
  float a[ROWS];  // dk/dv: lse of the tile's q rows; dq: kpad of its kv rows
  float b[ROWS];  // dk/dv: delta of the tile's q rows
  int ids[ROWS];  // ids mode: the tile's q (dk/dv) or kv (dq) ids, IDS_NONE past the end
  int r0;         // the tile's first row; -1: the walk is over
  int bound;      // ids mode: dk/dv the smallest q id, dq the largest kv id of the tile's valid rows
  int pad_[2];
};

// Dynamic shared memory: the two resident tiles, the ring of stages, their
// Aux, the barriers (full and empty per stage, one for the resident tiles),
// after up to 1 KB of alignment.
constexpr int AUX = 2 * TILE + STAGES * STAGE;
constexpr int BARS = AUX + STAGES * static_cast<int>(sizeof(Aux));
constexpr int SMEM_BYTES = 1024 + BARS + 8 * (2 * STAGES + 1);

// The producer warp's loop over the tiles rows begin, begin + 64, ... < end
// that skip(r0) does not skip (warp-uniform): wait for the next stage of the
// ring to be free, fill its Aux (fill(aux, r0)), then lane 0 loads rows r0 ..
// r0 + 63 of head h of batch b from m0 and m1 into its two tiles by TMA. Every
// lane arrives on the stage's full barrier (32 arrivals, lane 0's with the TMA
// bytes). A last stage with r0 = -1 ends the consumers' walk.
template <typename Skip, typename Fill>
__device__ __forceinline__ void produce(const CUtensorMap* m0, const CUtensorMap* m1, uint32_t stages, Aux* aux,
                                        uint32_t full, uint32_t empty, int begin, int end, int h, int b, Skip skip,
                                        Fill fill) {
  using namespace smp_tc;
  const int lane = threadIdx.x & 31;
  int it = 0;  // stages filled so far
  for (int r0 = begin; r0 < end; r0 += ROWS) {
    if (skip(r0)) continue;
    const int s = it % STAGES;
    mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // the first round finds every stage free
    fill(aux[s], r0);
    if (lane == 0) {
      aux[s].r0 = r0;
      mbar_arrive_expect_tx(full + 8 * s, STAGE);
      tma_load_rows(stages + s * STAGE, m0, full + 8 * s, r0, h, b);
      tma_load_rows(stages + s * STAGE + TILE, m1, full + 8 * s, r0, h, b);
    } else {
      mbar_arrive(full + 8 * s);
    }
    ++it;
  }
  const int s = it % STAGES;
  mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
  if (lane == 0) aux[s].r0 = -1;
  mbar_arrive(full + 8 * s);
}

// The smallest and largest of the ids of rows r0 .. r0 + 63 below n, over a
// warp (IDS_NONE and -1 when none is valid).
__device__ __forceinline__ int2 ids_range(const int* ids, int r0, int n) {
  const int lane = threadIdx.x & 31;
  int lo = IDS_NONE, hi = -1;
  for (int i = lane; i < ROWS; i += 32)
    if (r0 + i < n) lo = min(lo, ids[r0 + i]), hi = max(hi, ids[r0 + i]);
  return make_int2(__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi));
}

// Writes the consumer warpgroup's m64n64 accumulator d: the thread's rows
// rows[0] and rows[1] (those < n), columns 8j + 2(lane % 4) and the next, as
// pairs; fp32 in ids mode, else E. `at` is the (batch, head) offset of the
// output, `stride` its row stride.
template <typename E>
__device__ __forceinline__ void store_acc(const Params& p, void* out, long long at, long long stride,
                                          const int (&rows)[2], int n, const float (&d)[32]) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= n) continue;
    const long long row = at + rows[hh] * stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * hh;
      const long long e = row + 8 * j + 2 * qd;
      if (p.q_ids) *reinterpret_cast<float2*>(static_cast<float*>(out) + e) = make_float2(d[i], d[i + 1]);
      else *reinterpret_cast<uint32_t*>(static_cast<E*>(out) + e) = smp_tc::pack2<E>(d[i], d[i + 1]);
    }
  }
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// The setup both kernels share: barriers initialized, the roles split.
// Returns the shared-memory base (1 KB aligned).
__device__ __forceinline__ uint8_t* setup(uint8_t* smem_raw) {
  using namespace smp_tc;
  uint8_t* smem = align_1k(smem_raw);
  const uint32_t full = smem_u32(smem) + BARS, empty = full + 8 * STAGES, res_bar = empty + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 128);
    }
    mbar_init(res_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  return smem;
}

}  // namespace tc

// dk and dv on the tensor cores. One CTA per (64 kv rows, batch * head), two
// CTAs an SM. The consumer warpgroup keeps the K and V tiles of its kv rows in
// shared memory; the producer warp streams the q tiles that hold kept pairs
// (Q, dO by TMA; lse, delta and the q ids into Aux) through the ring. For each
// q tile the consumer computes S^T = K Q^T and dP^T = V dO^T (wgmma, both
// operands K-major in shared memory), then p_drop and ds of each accumulator
// element (grad_p, grad_ds at its kv row and q column) as wgmma A fragments
// rounded to E, then dV += P_drop^T dO and dK += dS^T Q (A from registers, dO
// and Q read MN-major). No atomics: each output element is one thread's sum in
// a fixed order.
template <typename E>
__global__ void __launch_bounds__(tc::THREADS, 2)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                           const Params p) {
  using namespace smp_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc::setup(smem_raw);
  const uint32_t aK = smem_u32(smem), aV = aK + tc::TILE, stages = aK + 2 * tc::TILE;
  tc::Aux* aux = reinterpret_cast<tc::Aux*>(smem + tc::AUX);
  const uint32_t full = aK + tc::BARS, empty = full + 8 * tc::STAGES, res_bar = empty + 8 * tc::STAGES;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int c0 = blockIdx.y * tc::ROWS;  // the first (longest under causal) launch first
  const int T = p.T, S = p.S;
  const bool ids = p.q_ids != nullptr;

  if (threadIdx.x >= 128) {  // producer warpgroup: its first warp
    setmaxnreg_dec<tc::PRODUCER_REGS>();
    if (threadIdx.x >= 160) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(res_bar, 2 * tc::TILE);
      tma_load_rows(aK, &mk, res_bar, c0, h, b);
      tma_load_rows(aV, &mv, res_bar, c0, h, b);
    }
    // Rows that keep some column of this CTA (as flash_bwd_dkv_kernel).
    const int off = S - T, c_last = min(c0 + tc::ROWS, S) - 1;
    int r_begin = 0, r_end = T;
    if (ids) {
      // every tile; under causal those with no kept pair are skipped
    } else if (p.causal) {
      r_begin = max(0, c0 - off);
      if (p.window > 0) r_end = min(T, c_last - off + p.window);
    } else if (p.window > 0) {
      r_begin = max(0, c0 - off - p.window + 1);
      r_end = min(T, c_last - off + p.window);
    }
    const int cmin = ids ? tc::ids_range(p.kv_ids, c0, S).x : 0;  // ids mode: the CTA's smallest kv id
    const float* lse = p.lse + static_cast<long long>(bh) * T;
    const float* delta = p.delta + static_cast<long long>(bh) * T;
    auto skip = [&](int r0) {  // no pair of the tile and the CTA's rows is kept
      if (!ids) return none_kept(p, r0, tc::ROWS, c0, tc::ROWS);
      return p.causal && cmin > tc::ids_range(p.q_ids, r0, T).y;
    };
    auto fill = [&](tc::Aux& a, int r0) {
      for (int i = lane; i < tc::ROWS; i += 32) {
        const int r = r0 + i;
        a.a[i] = r < T ? lse[r] : 0.f;
        a.b[i] = r < T ? delta[r] : 0.f;
        if (ids) a.ids[i] = r < T ? p.q_ids[r] : IDS_NONE;
      }
      if (ids) {
        const int lo = tc::ids_range(p.q_ids, r0, T).x;
        if (lane == 0) a.bound = lo;
      }
    };
    tc::produce(&mq, &mdo, stages, aux, full, empty, r_begin, r_end, h, b, skip, fill);
    return;
  }

  // Consumer warpgroup: kv rows c0 .. c0 + 63.
  setmaxnreg_inc<tc::CONSUMER_REGS>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane & 3;
  const float* kpad = p.kpad ? p.kpad + b * p.kpad_sb : nullptr;
  const uint32_t bh_hash = static_cast<uint32_t>(b * p.head_total + p.head0 + h);
  const bool ids_causal = ids && p.causal;
  const int cw = c0 + 16 * warp;  // the warp's 16 kv rows
  int c[2], kid[2];  // the thread's two kv rows (accumulator rows lane / 4 and + 8) and their ids
  float kp[2];
  Span span[2];  // the q rows each keeps (all rows below T in ids mode)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    c[hh] = cw + (lane >> 2) + 8 * hh;
    kp[hh] = kpad && c[hh] < S ? kpad[c[hh]] : 0.f;
    kid[hh] = ids ? (c[hh] < S ? p.kv_ids[c[hh]] : IDS_NONE) : c[hh];
    span[hh] = ids ? Span{0, c[hh] < S ? T : 0} : kept_span(p, c[hh], true);
  }
  const int kv_hi = __reduce_max_sync(0xffffffffu, max(kid[0], kid[1]));  // ids mode: the warp's largest kv id
  float dk[32], dv[32], st[32], dpt[32];
  tc::zero(dk);
  tc::zero(dv);
  mbar_wait(res_bar, 0);
  for (int it = 0;; ++it) {
    const int s = it % tc::STAGES;
    mbar_wait(full + 8 * s, (it / tc::STAGES) & 1);
    const tc::Aux& ax = aux[s];
    const int r0 = ax.r0;
    if (r0 < 0) break;
    const uint32_t aQ = stages + s * tc::STAGE, aDO = aQ + tc::TILE;

    // S^T = K Q^T and dP^T = V dO^T: one batch of eight wgmma.
    uint64_t da[4], db[4], dc[4], dd[4];
    k_steps(da, aK, false);
    k_steps(db, aQ, false);
    k_steps(dc, aV, false);
    k_steps(dd, aDO, false);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_ss<E>(st, da[kk], db[kk], kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_ss<E>(dpt, dc[kk], dd[kk], kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p_drop and ds of each element at its q column and kv row, rounded to E
    // as A fragments (accumulator pairs). Warps whose 16 x 64 block is all
    // kept skip the mask (masked = false); D: dropout.
    uint32_t pf[16], df[16];
    auto grads = [&](auto masked, auto dropout) {
      constexpr bool D = decltype(dropout)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 8 * j + 2 * qd;  // the tile's q rows cc and cc + 1: this thread's columns
        const float2 l = *reinterpret_cast<const float2*>(&ax.a[cc]);
        const float2 dl = *reinterpret_cast<const float2*>(&ax.b[cc]);
        const int2 qi = ids ? *reinterpret_cast<const int2*>(&ax.ids[cc]) : make_int2(0, 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r0 + cc + e, i = 4 * j + 2 * hh + e;
            const int qid = e ? qi.y : qi.x;
            bool keep = true;
            if (decltype(masked)::value)
              keep = r >= span[hh].lo && r < span[hh].hi && (!ids_causal || kid[hh] <= qid);
            float pr;
            const bool kd = grad_p<D>(p, keep, st[i], kpad != nullptr, kp[hh], e ? l.y : l.x, ids ? qid : r,
                                      kid[hh], bh_hash, pr, pd[e]);
            ds[e] = grad_ds<D>(p, pr, dpt[i], e ? dl.y : dl.x, kd);
          }
          pf[2 * j + hh] = pack2<E>(pd[0], pd[1]);
          df[2 * j + hh] = pack2<E>(ds[0], ds[1]);
        }
      }
    };
    const bool all = ids ? r0 + tc::ROWS <= T && cw + 16 <= S && (!p.causal || kv_hi <= ax.bound)
                         : all_kept(p, r0, tc::ROWS, cw, 16);
    if (p.has_dropout) {
      if (all) grads(std::false_type(), std::true_type());
      else grads(std::true_type(), std::true_type());
    } else {
      if (all) grads(std::false_type(), std::false_type());
      else grads(std::true_type(), std::false_type());
    }

    // dV += P_drop^T dO and dK += dS^T Q (A from registers, dO and Q read
    // MN-major): one batch of eight wgmma.
    k_steps(db, aDO, true);
    k_steps(dd, aQ, true);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pf);
    fence_regs(df);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_rs<E>(dv, pf + 4 * kk, db[kk]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_rs<E>(dk, df + 4 * kk, dd[kk]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pf);
    fence_regs(df);
    mbar_arrive(empty + 8 * s);
  }
  tc::store_acc<E>(p, p.dk, b * p.dk_sb + h * p.dk_sh, p.dk_st, c, S, dk);
  tc::store_acc<E>(p, p.dv, b * p.dv_sb + h * p.dv_sh, p.dv_st, c, S, dv);
}

// dq on the tensor cores, the dk/dv kernel's design turned around: one CTA per
// (64 q rows, batch * head), whose Q and dO tiles stay while the producer
// streams the kv tiles that hold kept pairs (K, V; kpad and the kv ids into
// Aux). Per kv tile: S = Q K^T and dP = dO V^T, ds, then dQ += dS K (A from
// registers, K read MN-major).
template <typename E>
__global__ void __launch_bounds__(tc::THREADS, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                          const Params p) {
  using namespace smp_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tc::setup(smem_raw);
  const uint32_t aQ = smem_u32(smem), aDO = aQ + tc::TILE, stages = aQ + 2 * tc::TILE;
  tc::Aux* aux = reinterpret_cast<tc::Aux*>(smem + tc::AUX);
  const uint32_t full = aQ + tc::BARS, empty = full + 8 * tc::STAGES, res_bar = empty + 8 * tc::STAGES;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * tc::ROWS;  // the last (longest under causal) launch first
  const int T = p.T, S = p.S;
  const bool ids = p.q_ids != nullptr;
  const float* kpad = p.kpad ? p.kpad + b * p.kpad_sb : nullptr;

  if (threadIdx.x >= 128) {  // producer warpgroup: its first warp
    setmaxnreg_dec<tc::PRODUCER_REGS>();
    if (threadIdx.x >= 160) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(res_bar, 2 * tc::TILE);
      tma_load_rows(aQ, &mq, res_bar, r0, h, b);
      tma_load_rows(aDO, &mdo, res_bar, r0, h, b);
    }
    // Columns kept by some row of this CTA (as flash_bwd_dq_kernel).
    const int off = S - T, r_last = min(r0 + tc::ROWS, T) - 1;
    int c_begin = 0, c_end = S;
    if (ids) {
      // every tile; under causal those with no kept pair are skipped
    } else if (p.causal) {
      c_end = min(S, r_last + off + 1);
      if (p.window > 0) c_begin = max(0, r0 + off - p.window + 1);
    } else if (p.window > 0) {
      c_begin = max(0, r0 + off - p.window + 1);
      c_end = min(S, r_last + off + p.window);
    }
    const int rmax = ids ? tc::ids_range(p.q_ids, r0, T).y : 0;  // ids mode: the CTA's largest q id
    auto skip = [&](int k0) {  // no pair of the CTA's rows and the tile is kept
      if (!ids) return none_kept(p, r0, tc::ROWS, k0, tc::ROWS);
      return p.causal && tc::ids_range(p.kv_ids, k0, S).x > rmax;
    };
    auto fill = [&](tc::Aux& a, int k0) {
      for (int i = lane; i < tc::ROWS; i += 32) {
        const int c = k0 + i;
        a.a[i] = kpad && c < S ? kpad[c] : 0.f;
        if (ids) a.ids[i] = c < S ? p.kv_ids[c] : IDS_NONE;
      }
      if (ids) {
        const int hi = tc::ids_range(p.kv_ids, k0, S).y;
        if (lane == 0) a.bound = hi;
      }
    };
    tc::produce(&mk, &mv, stages, aux, full, empty, c_begin, c_end, h, b, skip, fill);
    return;
  }

  // Consumer warpgroup: q rows r0 .. r0 + 63.
  setmaxnreg_inc<tc::CONSUMER_REGS>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane & 3;
  const uint32_t bh_hash = static_cast<uint32_t>(b * p.head_total + p.head0 + h);
  const bool ids_causal = ids && p.causal;
  const int rw = r0 + 16 * warp;  // the warp's 16 q rows
  int r[2], qid[2];  // the thread's two q rows (accumulator rows lane / 4 and + 8) and their ids
  float lse[2], delta[2];
  Span span[2];  // the kv columns each keeps (all columns below S in ids mode)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    r[hh] = rw + (lane >> 2) + 8 * hh;
    const bool in = r[hh] < T;
    lse[hh] = in ? p.lse[static_cast<long long>(bh) * T + r[hh]] : 0.f;
    delta[hh] = in ? p.delta[static_cast<long long>(bh) * T + r[hh]] : 0.f;
    qid[hh] = ids ? (in ? p.q_ids[r[hh]] : IDS_NONE) : r[hh];
    span[hh] = ids ? Span{0, in ? S : 0} : kept_span(p, r[hh], false);
  }
  const int q_lo = __reduce_min_sync(0xffffffffu, min(qid[0], qid[1]));  // ids mode: the warp's smallest q id
  float dq[32], sc[32], dp[32];
  tc::zero(dq);
  mbar_wait(res_bar, 0);
  for (int it = 0;; ++it) {
    const int s = it % tc::STAGES;
    mbar_wait(full + 8 * s, (it / tc::STAGES) & 1);
    const tc::Aux& ax = aux[s];
    const int k0 = ax.r0;
    if (k0 < 0) break;
    const uint32_t aK = stages + s * tc::STAGE, aV = aK + tc::TILE;

    // S = Q K^T and dP = dO V^T: one batch of eight wgmma.
    uint64_t da[4], db[4], dc[4], dd[4];
    k_steps(da, aQ, false);
    k_steps(db, aK, false);
    k_steps(dc, aDO, false);
    k_steps(dd, aV, false);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_ss<E>(sc, da[kk], db[kk], kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_ss<E>(dp, dc[kk], dd[kk], kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // ds of each element at its q row and kv column, rounded to E as A
    // fragments. Warps whose 16 x 64 block is all kept skip the mask (masked
    // = false); D: dropout.
    uint32_t df[16];
    auto grads = [&](auto masked, auto dropout) {
      constexpr bool D = decltype(dropout)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 8 * j + 2 * qd;  // the tile's kv rows cc and cc + 1: this thread's columns
        const float2 kv_pad = *reinterpret_cast<const float2*>(&ax.a[cc]);
        const int2 ki = ids ? *reinterpret_cast<const int2*>(&ax.ids[cc]) : make_int2(0, 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + cc + e, i = 4 * j + 2 * hh + e;
            const int kid = e ? ki.y : ki.x;
            bool keep = true;
            if (decltype(masked)::value)
              keep = col >= span[hh].lo && col < span[hh].hi && (!ids_causal || kid <= qid[hh]);
            float pr, pd;
            const bool kd = grad_p<D>(p, keep, sc[i], kpad != nullptr, e ? kv_pad.y : kv_pad.x, lse[hh], qid[hh],
                                      ids ? kid : col, bh_hash, pr, pd);
            ds[e] = grad_ds<D>(p, pr, dp[i], delta[hh], kd);
          }
          df[2 * j + hh] = pack2<E>(ds[0], ds[1]);
        }
      }
    };
    const bool all = ids ? rw + 16 <= T && k0 + tc::ROWS <= S && (!p.causal || ax.bound <= q_lo)
                         : all_kept(p, rw, 16, k0, tc::ROWS);
    if (p.has_dropout) {
      if (all) grads(std::false_type(), std::true_type());
      else grads(std::true_type(), std::true_type());
    } else {
      if (all) grads(std::false_type(), std::false_type());
      else grads(std::true_type(), std::false_type());
    }

    // dQ += dS K (A from registers, K read MN-major): one batch of four wgmma.
    k_steps(db, aK, true);
    fence_regs(dq);
    fence_regs(df);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_rs<E>(dq, df + 4 * kk, db[kk]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(df);
    mbar_arrive(empty + 8 * s);
  }
  tc::store_acc<E>(p, p.dq, b * p.dq_sb + h * p.dq_sh, p.dq_st, r, T, dq);
}

template <int HD, int BT>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(4 * BT * (HD + 4) + BT * (BT + 4) + 2 * BT);
}

template <int HD, int BT>
constexpr size_t dkv_smem() {
  return sizeof(float) * (size_t)(4 * BT * (HD + 4) + 2 * BT * (BT + 4) + 4 * BT);
}

template <typename E, int HD, int BT>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<HD, BT>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<E, HD, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + BT - 1) / BT);
  flash_bwd_dq_kernel<E, HD, BT><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename E, int HD, int BT>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<HD, BT>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<E, HD, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.S + BT - 1) / BT);
  flash_bwd_dkv_kernel<E, HD, BT><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// hd <= 64 and <= 128 take 64-row tiles; hd <= 256 takes 32-row tiles so
// four fp32 operand tiles fit the 227 KB of shared memory.
template <typename E>
cudaError_t launch(const Params& p, bool dq, cudaStream_t stream) {
  if (p.hd <= 64) return dq ? launch_dq<E, 64, 64>(p, stream) : launch_dkv<E, 64, 64>(p, stream);
  if (p.hd <= 128)
    return dq ? launch_dq<E, 128, 64>(p, stream) : launch_dkv<E, 128, 64>(p, stream);
  return dq ? launch_dq<E, 256, 32>(p, stream) : launch_dkv<E, 256, 32>(p, stream);
}

template <typename E>
cudaError_t launch_wgmma(const Params& p, bool dq, cudaStream_t stream) {
  using namespace smp_tc;
  constexpr CUtensorMapDataType ty = TmaType<E>::value;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_bthd(&mq, ty, p.q, p.T, p.H, p.B, p.q_st, p.q_sh, p.q_sb) ||
      !encode_bthd(&mk, ty, p.k, p.S, p.H, p.B, p.k_st, p.k_sh, p.k_sb) ||
      !encode_bthd(&mv, ty, p.v, p.S, p.H, p.B, p.v_st, p.v_sh, p.v_sb) ||
      !encode_bthd(&mdo, ty, p.dout, p.T, p.H, p.B, p.do_st, p.do_sh, p.do_sb))
    return cudaErrorInvalidValue;
  auto kernel = dq ? flash_bwd_dq_wgmma_kernel<E> : flash_bwd_dkv_wgmma_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, ((dq ? p.T : p.S) + tc::ROWS - 1) / tc::ROWS);
  kernel<<<grid, tc::THREADS, tc::SMEM_BYTES, stream>>>(mq, mk, mv, mdo, p);
  return cudaGetLastError();
}

bool aligned(const void* x, int bytes) { return reinterpret_cast<uintptr_t>(x) % bytes == 0; }

// What TMA and the pair stores need: 16-bit operands with hd 64 on 16-byte
// aligned bases, their (batch, row, head) strides positive multiples of 16
// bytes; outputs whose element pairs are aligned (an absent output passes).
bool tensor_core_ok(int dtype, const Params& p) {
  if ((dtype != 1 && dtype != 2) || p.hd != 64) return false;
  for (const void* x : {p.q, p.k, p.v, p.dout})
    if (!aligned(x, 16)) return false;
  for (long long s : {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_st, p.k_sh, p.v_sb, p.v_st, p.v_sh, p.do_sb, p.do_st,
                      p.do_sh})
    if (s <= 0 || s % 8 != 0) return false;
  for (long long s : {p.dq_sb, p.dq_st, p.dq_sh, p.dk_sb, p.dk_st, p.dk_sh, p.dv_sb, p.dv_st, p.dv_sh})
    if (s % 2 != 0) return false;
  return aligned(p.dq, 8) && aligned(p.dk, 8) && aligned(p.dv, 8);
}

int launch_any(int tensor_cores, int dtype, const Params& p, bool dq, void* stream) {
  if (p.hd < 1 || p.hd > 256) return (int)cudaErrorInvalidValue;
  if ((p.q_ids == nullptr) != (p.kv_ids == nullptr) || (p.q_ids && p.window > 0))
    return (int)cudaErrorInvalidValue;
  if (tensor_cores && !tensor_core_ok(dtype, p)) return (int)cudaErrorInvalidValue;
  if (p.B * p.H == 0 || p.T == 0 || p.S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, dq, s);
    case 1: return (int)(tensor_cores ? launch_wgmma<__half>(p, dq, s) : launch<__half>(p, dq, s));
    case 2: return (int)(tensor_cores ? launch_wgmma<__nv_bfloat16>(p, dq, s) : launch<__nv_bfloat16>(p, dq, s));
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const float* kpad, const int* q_ids,
                   const int* kv_ids, void* dq, void* dk,
                   void* dv, int B, int T, int S, int H, int hd, const long long* st,
                   float scale, int causal, int window, int has_dropout, unsigned int seed,
                   unsigned int keep_threshold, unsigned int s_total, float inv_keep, int head0,
                   int head_total) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = lse; p.delta = delta; p.kpad = kpad; p.q_ids = q_ids; p.kv_ids = kv_ids;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.T = T; p.S = S; p.H = H; p.hd = hd;
  p.q_sb = st[0]; p.q_st = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_st = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_st = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_st = st[10]; p.do_sh = st[11];
  p.dq_sb = st[12]; p.dq_st = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_st = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_st = st[19]; p.dv_sh = st[20];
  p.kpad_sb = st[21];
  p.scale = scale; p.causal = causal; p.window = window; p.has_dropout = has_dropout;
  p.seed = seed; p.keep_threshold = keep_threshold; p.s_total = s_total;
  p.inv_keep = inv_keep; p.head0 = head0; p.head_total = head_total;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 fp16, 2 bf16, shared by q, k, v, dO and the outputs.
// strides: 22 element strides, (batch, row, head) of q, k, v, dO, dq, dk,
// dv, then kpad's batch stride (0 to broadcast one row); the head-dim
// stride is 1. window <= 0 means none. smp_flash_bwd_dq writes dq only,
// smp_flash_bwd_dkv dk and dv only (the other output pointers may be null).
// q_ids/kv_ids (int32 [T]/[S]) select ids mode (no window; fp32 outputs),
// null for the plain kernels. tensor_cores: 1 launches the wgmma kernel (fp16
// or bf16, hd 64, tensor_core_ok's strides and alignment; anything else is
// refused, never sent to the other kernel), 0 the CUDA-core kernel. Each
// returns a cudaError_t (0 = launched).
int smp_flash_bwd_dq(int tensor_cores, int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const float* kpad,
                     const int* q_ids, const int* kv_ids, void* dq, int B,
                     int T, int S, int H, int hd, const long long* strides, float scale,
                     int causal, int window, int has_dropout, unsigned int seed,
                     unsigned int keep_threshold, unsigned int s_total, float inv_keep, int head0,
                     int head_total, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, kpad, q_ids, kv_ids, dq, nullptr, nullptr, B, T, S,
                               H, hd, strides, scale, causal, window, has_dropout, seed,
                               keep_threshold, s_total, inv_keep, head0, head_total);
  return launch_any(tensor_cores, dtype, p, true, stream);
}

int smp_flash_bwd_dkv(int tensor_cores, int dtype, const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* kpad,
                      const int* q_ids, const int* kv_ids, void* dk,
                      void* dv, int B, int T, int S, int H, int hd, const long long* strides,
                      float scale, int causal, int window, int has_dropout, unsigned int seed,
                      unsigned int keep_threshold, unsigned int s_total, float inv_keep,
                      int head0, int head_total, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, kpad, q_ids, kv_ids, nullptr, dk, dv, B, T, S, H,
                               hd, strides, scale, causal, window, has_dropout, seed,
                               keep_threshold, s_total, inv_keep, head0, head_total);
  return launch_any(tensor_cores, dtype, p, false, stream);
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
