// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_attention.py
//   _bwd_dq_kernel  -> flash_bwd_dq_kernel  (dq pass)
//   _bwd_dkv_kernel -> flash_bwd_dkv_kernel (dk/dv pass)
//   both launched by _flash_bwd_impl through pl.pallas_call, the backward of
//   flash_attention's custom_vjp. Python wrappers and plain PyTorch versions:
//   smdistributed_modelparallel_tpu_torch/ops/flash_attention.py.
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
// that hold kept pairs of their own 64-row (32 for hd > 128) tiles.
//
// Bound on an H100: at the training path's shape (B=2, T=S=1024, H=12,
// hd=64, bf16, causal, per microbatch) the dq kernel does three
// [pairs x hd] products (s, dp, dq: 4.84 GFLOP over 15.9 MB of q, k, v,
// dO, lse, delta in and dq out) and the dk/dv kernel four (s, dp, dv, dk:
// 6.45 GFLOP over 19.1 MB): 4.9 and 6.5 us of tensor-core time against 4.8
// and 5.7 us of memory time. Both are operation-bound.
//
// Design, in its simplest right form (as csrc/flash_fwd.cu):
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
// Not yet used: wgmma, TMA, cp.async pipelining. These kernels run on the
// CUDA cores and are far from their bound; making them fast is later work.
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

// ds and p_drop of one (row, col), in the reference's fp32 order. The
// __f*_rn intrinsics keep nvcc from contracting a multiply and an add into
// an FMA the reference does not do.
// (hrow, hcol) are the dropout hash's row and column: the local indices, or
// the ids in ids mode.
__device__ __forceinline__ void grad_pair(const Params& p, float s, float dp, float lse,
                                          float delta, int r, int c, int hrow, int hcol,
                                          const float* kpad, uint32_t bh_hash, float& ds,
                                          float& p_drop) {
  float pr = 0.f;
  if (kept(p, r, c, hrow, hcol)) {
    float x = __fmul_rn(s, p.scale);
    if (kpad) x = __fadd_rn(x, kpad[c]);
    pr = expf(__fsub_rn(x, lse));
  }
  p_drop = pr;
  if (p.has_dropout) {
    const bool keep = dropout_bits(p.seed, bh_hash, (uint32_t)hrow, (uint32_t)hcol, p.s_total) >=
                      p.keep_threshold;
    dp = keep ? __fmul_rn(dp, p.inv_keep) : 0.f;
    p_drop = keep ? __fmul_rn(pr, p.inv_keep) : 0.f;
  }
  ds = __fmul_rn(__fmul_rn(pr, __fsub_rn(dp, delta)), p.scale);
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

int launch_any(int dtype, const Params& p, bool dq, void* stream) {
  if (p.hd < 1 || p.hd > 256) return (int)cudaErrorInvalidValue;
  if ((p.q_ids == nullptr) != (p.kv_ids == nullptr) || (p.q_ids && p.window > 0))
    return (int)cudaErrorInvalidValue;
  if (p.B * p.H == 0 || p.T == 0 || p.S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, dq, s);
    case 1: return (int)launch<__half>(p, dq, s);
    case 2: return (int)launch<__nv_bfloat16>(p, dq, s);
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
// null for the plain kernels. Each returns a cudaError_t (0 = launched).
int smp_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const float* kpad,
                     const int* q_ids, const int* kv_ids, void* dq, int B,
                     int T, int S, int H, int hd, const long long* strides, float scale,
                     int causal, int window, int has_dropout, unsigned int seed,
                     unsigned int keep_threshold, unsigned int s_total, float inv_keep, int head0,
                     int head_total, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, kpad, q_ids, kv_ids, dq, nullptr, nullptr, B, T, S,
                               H, hd, strides, scale, causal, window, has_dropout, seed,
                               keep_threshold, s_total, inv_keep, head0, head_total);
  return launch_any(dtype, p, true, stream);
}

int smp_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* kpad,
                      const int* q_ids, const int* kv_ids, void* dk,
                      void* dv, int B, int T, int S, int H, int hd, const long long* strides,
                      float scale, int causal, int window, int has_dropout, unsigned int seed,
                      unsigned int keep_threshold, unsigned int s_total, float inv_keep,
                      int head0, int head_total, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, kpad, q_ids, kv_ids, nullptr, dk, dv, B, T, S, H,
                               hd, strides, scale, causal, window, has_dropout, seed,
                               keep_threshold, s_total, inv_keep, head0, head_total);
  return launch_any(dtype, p, false, stream);
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
