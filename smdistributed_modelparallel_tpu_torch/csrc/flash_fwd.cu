// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_attention.py
//   _fwd_kernel :162 (launched by _flash_fwd_impl through pl.pallas_call at
//   :578), the kernel behind flash_attention, and the same kernel with
//   has_ids=True (flash_fwd_with_ids :796)
//     -> flash_fwd_wgmma_kernel (tensor cores) and flash_fwd_kernel (CUDA cores).
//   Python wrappers and plain PyTorch versions:
//   smdistributed_modelparallel_tpu_torch/ops/flash_attention.py, whose _route
//   picks the kernel by the operands alone: fp16/bf16 with hd 64 and TMA's
//   strides and alignment take the tensor cores, the rest (fp32, other head
//   dims) the CUDA cores. Neither route stands in for the other.
//
// What it computes, per (batch, head) and query row r:
//   s[c]  = keep(r, c) ? (q_r . k_c) * scale + kpad[b, c] : -1e30   (fp32)
//   p     = online softmax of s over the reference kv range of r
//   o_r   = (sum_c drop(r, c) * round_v(p[c]) * v_c) / (1 - rate) / max(l, 1e-30)
//   lse_r = l > 0 ? m + log(l) : 1e30
// with the reference kernel's conventions kept exactly: masked scores are
// -1e30 (not -inf), the scale multiplies the fp32 scores after the product,
// probabilities are rounded to v's dtype before the second product, the
// dropout keep bits come from the same counter hash (_dropout_keep), and
// the whole output is rescaled by 1/(1-rate) at the end.
//
// The reference kv range. The TPU kernel visits, for each of its q blocks
// (block_q rows), the kv blocks [lo, hi) of _kv_bounds with its block_k, on
// K/V zero-padded to s_pad = S rounded up to block_k. For a row with at
// least one kept column this range does not change the result. A row whose
// columns are all masked has every visited score at -1e30, so each visited
// column (padding included, whose v is 0) gets p = 1: its output is the mean
// of the visited v's. The wrapper passes the reference tiling (ref_bq,
// ref_bk, s_pad) so this kernel reproduces that range: the columns in
// [S, s_pad) are counted analytically (n_pad below), never loaded.
//
// Bound on an H100: at the main path's shape (B=4, T=S=512, H=12, hd=64,
// bf16, causal) the work is ~1.6 GFLOP over ~12.6 MB, i.e. ~1.6 us of
// tensor-core time against ~3.8 us of memory time: memory-bound. At the
// training microbatch (B=2, T=S=1024) ~3.2 GFLOP over ~12.6 MB: 3.3 us of
// tensor-core time against 3.8 us of memory time.
//
// Tensor-core route (flash_fwd_wgmma_kernel; csrc/tma_wgmma.cuh's pieces),
// the dq kernel of csrc/flash_bwd.cu with the dP product and ds taken out and
// an online softmax put in. The TPU kernel's dots take 16-bit operands with
// fp32 accumulation and it rounds p to v's dtype before the second dot:
// exactly a 16-bit wgmma's operands and accumulators, so only the summation
// order changes.
//   - One CTA per (64 q rows, batch * head), two CTAs an SM: a consumer
//     warpgroup and a producer warp. The Q tile is loaded once by TMA; the
//     producer streams [64, 64] K and V tiles through a ring of 3 stages from
//     the [B, S, H, 64] operands as they lie (the 4-D map, 128-byte swizzle;
//     q, k and v may be views into a fused QKV output) and writes each tile's
//     kpad, kv ids and visited end beside it.
//   - The producer walks the reference kv range itself (the plain range of
//     plain_walk; in ids mode the reference blocks' causal skip, decided per
//     reference block from warp reductions of the ids, and the 64-column skip
//     only where it is exact), so it loads exactly the tiles the consumer
//     reads; its last stage carries n_pad.
//   - Per tile: S = Q K^T (wgmma m64n64k16, both operands K-major); on the
//     accumulator fragments in registers the scale and kpad (__fmul_rn,
//     __fadd_rn), the mask (per-row spans; warps whose 16 x 64 block is all
//     kept skip it), columns >= c_end at -inf (TMA reads K/V rows past S as
//     zeros, which would score 0), the row max by quad shuffles, alpha, p =
//     expf(s - m_new) and l from the unrounded fp32 p; dropout zeroes p after
//     the row sum (a compile-time branch); p rounded to v's dtype as register
//     A fragments; then O = alpha O and O += P V (V read MN-major).
//   - Every wgmma batch is waited for before a register it reads or
//     accumulates into is defined (ptxas serializes every wgmma of a kernel
//     otherwise, C7513/C7515). No atomics: two launches give equal bits.
//   - CTAs with the longest causal walk launch first (the last q tile).
//   - The epilogue writes o as register pairs (q's dtype; fp32 in ids mode)
//     and lse from the quad's first lane.
// Not yet used: two consumer warpgroups sharing the K/V stream, ping-pong of
// the softmax of one tile with the products of the next, hd 128.
//
// CUDA-core route (flash_fwd_kernel), in its simplest right form, for fp32
// and the head dims the tensor-core kernel does not take:
//   - one CTA of 256 threads per (64 query rows, batch*head);
//   - Q, K, V tiles of 64 rows staged in shared memory as fp32, so one code
//     path serves fp32, fp16 and bf16 (bf16/fp16 products are exact in fp32,
//     as the reference's fp32-accumulating dots are);
//   - scores and P.V by plain FMA: each thread owns a 4x4 block of the
//     64x64 score tile (rows ty+16i, cols tx+16j) and the matching 4 rows of
//     the output accumulator; row max and sum are reduced with warp shuffles
//     across the 16 threads of a row;
//   - fp32 running max, sum and accumulator in registers;
//   - kv tiles outside the causal/window band are skipped whenever every
//     row of the tile has a kept column and there is no kpad bias (then the
//     skipped columns contribute exactly 0); otherwise the whole reference
//     range is walked so fully-masked rows match the reference.
//
// Ids mode (q_ids, kv_ids non-null) replaces the same TPU kernel with
// has_ids=True (flash_fwd_with_ids: one (q block, kv block) pair of a
// context-parallel ring step):
//   - keep(r, c) = r < T && c < S && (!causal || kv_ids[c] <= q_ids[r]): the
//     causal relation of the global (zigzag-ordered) ids, no window;
//   - the visited range is every reference kv block, except that under
//     causal a block whose smallest valid column id exceeds the largest
//     valid row id of the reference q block is skipped, as the TPU kernel's
//     runtime skip does (_ids_rmax, _ids_cmin). The decision is made per
//     reference block (ref_bk, 256 by default), never per 64-column tile: a
//     row whose visited columns are all masked averages every visited v, so
//     the granularity shows in the output. The padding columns of the last
//     reference block count only when that block is visited;
//   - inside a visited block, a 64-column tile with no kept pair is skipped
//     when there is no kpad and every row of this CTA keeps some column (its
//     smallest id is at least the smallest kv id): the tile then contributes
//     exactly 0;
//   - dropout hashes (q_ids[r], kv_ids[c]) with the counter_len stride;
//   - o is written in fp32, for the ring's fp32 merge.
// Bound at the context-parallel path's ring pair (B=2, Tl=2048, H=12,
// hd=64, bf16, causal): the zigzag diagonal pair keeps ~half its pairs
// (~3.3 GFLOP over ~13 MB: 3.4 us of tensor-core time against 3.9 us of
// memory time), the off-diagonal pair half of them fully and half not at
// all; chip_smoke.py computes the bound of each measured pair.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tma_wgmma.cuh"

namespace {

constexpr int BM = 64;       // query rows per CTA
constexpr int BN = 64;       // kv rows per tile
constexpr int NT = 256;      // threads per CTA
constexpr int LDP = BN + 4;  // row stride of the P tile in floats
constexpr float NEG_BIG = -1e30f;
constexpr float LSE_MASKED = 1e30f;

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

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
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

constexpr int IDS_NONE = 1 << 30;  // above every id

// Minimum of one int per thread over the CTA, returned to every thread;
// `red` is NT / 32 ints of shared memory.
__device__ __forceinline__ int block_min(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // an earlier call no longer reads red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) v = min(v, red[w]);
  return v;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kpad;  // [B or 1, S] fp32, or null
  const int* q_ids;   // [T] global row ids, or null: ids mode when set
  const int* kv_ids;  // [S] global column ids
  void* o;            // [B, T, H, hd]: q's dtype, fp32 in ids mode
  float* lse;         // [B, H, T] fp32
  int B, T, S, H, hd;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long kpad_sb;
  float scale;
  int causal;
  int window;  // <= 0: none
  int has_dropout;
  uint32_t seed, keep_threshold, s_total;
  float inv_keep;
  int head0, head_total;  // dropout hash coordinates
  int ref_bq, ref_bk, s_pad;
};

// The 64-column tiles a plain-mode CTA of rows r0 .. r0 + 63 walks: c0 =
// begin, begin + 64, ... < end, with columns >= c_end not visited and n_pad
// visited padding columns [S, s_pad). That is the reference kv range of the
// q block that holds the rows (_kv_bounds; BM divides ref_bq, so it is one
// block), tightened to the rows' band where that is exact (see the header).
struct KvWalk {
  int begin, end, c_end, n_pad;
};

__device__ __forceinline__ KvWalk plain_walk(const Params& p, int r0) {
  const int T = p.T, S = p.S, offset = S - T, window = p.window;
  const bool has_window = window > 0;
  const int q_lo = (r0 / p.ref_bq) * p.ref_bq;
  const int q_hi = q_lo + p.ref_bq;
  const int num_kv = p.s_pad / p.ref_bk;
  int hi_blk = num_kv;
  if (p.causal) {
    hi_blk = min(num_kv, floor_div(q_hi - 1 + offset, p.ref_bk) + 1);
  } else if (has_window) {
    hi_blk = min(num_kv, floor_div(q_hi - 1 + offset + window - 1, p.ref_bk) + 1);
  }
  const int lo_blk = has_window ? max(0, floor_div(q_lo + offset - window + 1, p.ref_bk)) : 0;
  const int c_lo = lo_blk * p.ref_bk;
  const int c_hi = hi_blk * p.ref_bk;
  const int c_end = min(c_hi, S);
  const int n_pad = max(0, c_hi - max(S, c_lo));

  const int r_last = min(r0 + BM, T) - 1;
  bool dense = p.kpad == nullptr;
  if (p.causal) {
    dense = dense && r0 + offset >= 0;
  } else if (has_window) {
    dense = dense && r0 + offset > -window && r_last + offset < S - 1 + window;
  }
  int k_begin = c_lo, k_end = c_end;
  if (dense) {
    if (p.causal) k_end = min(k_end, r_last + offset + 1);
    else if (has_window) k_end = min(k_end, r_last + offset + window);
    if (has_window) k_begin = max(k_begin, r0 + offset - window + 1);
    k_begin = (k_begin / BN) * BN;
  }
  return {k_begin, k_end, c_end, n_pad};
}

template <typename E, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int LD = HD + 4;  // row stride of the Q/K/V tiles in floats
  constexpr int NJ = HD / 16; // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;
  int* sQid = reinterpret_cast<int*>(sP + BM * LDP);  // ids mode: this CTA's row ids
  int* sKid = sQid + BM;                               // and the current tile's column ids
  int* sRed = sKid + BN;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int r0 = blockIdx.y * BM;
  const int T = p.T, S = p.S, hd = p.hd;
  const int offset = S - T;
  const bool has_window = p.window > 0;
  const int window = p.window;
  const bool ids = p.q_ids != nullptr;

  const E* q = static_cast<const E*>(p.q) + b * p.q_sb + h * p.q_sh;
  const E* k = static_cast<const E*>(p.k) + b * p.k_sb + h * p.k_sh;
  const E* v = static_cast<const E*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* kpad = p.kpad ? p.kpad + b * p.kpad_sb : nullptr;

  for (int e = tid; e < BM * HD; e += NT) {
    const int rr = e / HD, d = e % HD;
    const int r = r0 + rr;
    sQ[rr * LD + d] = (r < T && d < hd) ? to_f<E>(q[r * p.q_st + d]) : 0.f;
  }
  if (ids && tid < BM) sQid[tid] = r0 + tid < T ? p.q_ids[r0 + tid] : IDS_NONE;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const uint32_t bh_hash = (uint32_t)(b * p.head_total + p.head0 + h);

  // One 64-column tile at c0: columns >= c_end are not visited (-inf).
  auto tile = [&](int c0, int c_end) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BN * HD; e += NT) {
      const int cc = e / HD, d = e % HD;
      const int c = c0 + cc;
      const bool in = c < S && d < hd;
      sK[cc * LD + d] = in ? to_f<E>(k[c * p.k_st + d]) : 0.f;
      sV[cc * LD + d] = in ? to_f<E>(v[c * p.v_st + d]) : 0.f;
    }
    if (ids && tid < BN) sKid[tid] = c0 + tid < S ? p.kv_ids[c0 + tid] : IDS_NONE;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
      const int r = r0 + rr;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j;
        const int c = c0 + cc;
        float x;
        if (c >= c_end) {
          x = -INFINITY;  // outside the reference range: not visited
        } else {
          bool keep = r < T;
          if (ids) {
            keep = keep && (!p.causal || sKid[cc] <= sQid[rr]);
          } else if (p.causal) {
            keep = keep && c <= r + offset;
            if (has_window) keep = keep && r + offset - c < window;
          } else if (has_window) {
            keep = keep && abs(r + offset - c) < window;
          }
          if (keep) {
            x = __fmul_rn(s[i][j], p.scale);
            if (kpad) x = __fadd_rn(x, kpad[c]);
          } else {
            x = NEG_BIG;
          }
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pj = expf(s[i][j] - m_new);
        rs += pj;
        if (p.has_dropout) {
          const int cc = tx + 16 * j;
          const uint32_t hrow = ids ? (uint32_t)sQid[rr] : (uint32_t)r;
          const uint32_t hcol = ids ? (uint32_t)sKid[cc] : (uint32_t)(c0 + cc);
          if (dropout_bits(p.seed, bh_hash, hrow, hcol, p.s_total) < p.keep_threshold) pj = 0.f;
        }
        sP[rr * LDP + tx + 16 * j] = to_f<E>(from_f<E>(pj));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  };

  // The reference tiling's q block that holds this CTA's rows (BM divides
  // ref_bq, so it is one block) and its kv blocks.
  const int q_lo = (r0 / p.ref_bq) * p.ref_bq;
  const int num_kv = p.s_pad / p.ref_bk;
  int n_pad = 0;  // visited padding columns [S, s_pad)
  if (ids) {
    // The reference q block's largest valid row id, this CTA's smallest,
    // and the smallest kv id, which every row that keeps a column reaches.
    int mx = -1, mn = IDS_NONE;
    for (int r = q_lo + tid; r < min(q_lo + p.ref_bq, T); r += NT) mx = max(mx, p.q_ids[r]);
    for (int c = tid; c < S; c += NT) mn = min(mn, p.kv_ids[c]);
    const int rmax_ref = -block_min(-mx, sRed);
    const int kv_min = block_min(mn, sRed);
    const int rmin_cta = block_min(tid < BM ? sQid[tid] : IDS_NONE, sRed);
    const bool dense = p.causal && kpad == nullptr && rmin_cta >= kv_min;
    int rmax_cta = -1;
    if (dense) {
      for (int rr = 0; rr < BM; ++rr) rmax_cta = max(rmax_cta, sQid[rr] == IDS_NONE ? -1 : sQid[rr]);
    }
    for (int j = 0; j < num_kv; ++j) {
      const int cb = j * p.ref_bk;
      const int ce = min(cb + p.ref_bk, S);
      if (p.causal) {
        int cm = IDS_NONE;
        for (int c = cb + tid; c < ce; c += NT) cm = min(cm, p.kv_ids[c]);
        if (block_min(cm, sRed) > rmax_ref) continue;  // the reference kernel skips this block
      }
      if (j == num_kv - 1) n_pad = p.s_pad - S;
      for (int c0 = cb; c0 < ce; c0 += BN) {
        if (dense) {
          int cm = IDS_NONE;
          for (int c = c0; c < min(c0 + BN, ce); ++c) cm = min(cm, p.kv_ids[c]);
          if (cm > rmax_cta) continue;  // no kept pair, and every row keeps one elsewhere
        }
        tile(c0, ce);
      }
    }
  } else {
    const KvWalk w = plain_walk(p, r0);
    n_pad = w.n_pad;
    for (int c0 = w.begin; c0 < w.end; c0 += BN) tile(c0, w.c_end);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= T) continue;
    // Padding columns in the range score -1e30 too: they count only when
    // every visited score is -1e30 (then each has p = 1 and v = 0).
    const float li = (m[i] == NEG_BIG) ? l[i] + (float)n_pad : l[i];
    const float denom = fmaxf(li, 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d >= hd) continue;
      const float val = __fmul_rn(acc[i][j], p.inv_keep) / denom;
      const long long at = b * p.o_sb + h * p.o_sh + r * p.o_st + d;
      if (ids) static_cast<float*>(p.o)[at] = val;
      else static_cast<E*>(p.o)[at] = from_f<E>(val);
    }
    if (tx == 0) p.lse[(long long)bh * T + r] = li > 0.f ? m[i] + logf(denom) : LSE_MASKED;
  }
}

// ------------------------------------------------------------ tensor cores

namespace tc {

constexpr int ROWS = 64;                 // q rows of a CTA, and kv rows of each streamed tile
constexpr int TILE = smp_tc::HEAD_TILE;  // bytes of one [64, 64] 16-bit tile
constexpr int STAGE = 2 * TILE;          // a stage: the K and the V tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;             // a consumer warpgroup and a producer warpgroup
// Two CTAs an SM: 128 registers a thread at launch; after setmaxnreg the
// consumer has 216 and the producer 40 (128 x 216 + 128 x 40 = 32768).
constexpr int CONSUMER_REGS = 216, PRODUCER_REGS = 40;

// What the producer warp writes beside each stage's two tiles.
struct Aux {
  float kpad[ROWS];  // kpad of the tile's kv rows (0 past S, or without kpad)
  int ids[ROWS];     // ids mode: their kv ids, IDS_NONE past S
  int c0;            // the tile's first column; -1: the walk is over, and c_end is n_pad
  int c_end;         // columns >= c_end are not visited
  int bound;         // ids mode: the largest kv id of the tile's rows below S
  int pad_;
};

// Dynamic shared memory: the Q tile, the ring of stages, their Aux, the
// barriers (full and empty per stage, one for Q), after up to 1 KB of
// alignment.
constexpr int AUX = TILE + STAGES * STAGE;
constexpr int BARS = AUX + STAGES * static_cast<int>(sizeof(Aux));
constexpr int SMEM_BYTES = 1024 + BARS + 8 * (2 * STAGES + 1);

// The smallest and the largest of ids[lo .. hi) over a warp (IDS_NONE and -1
// for an empty range).
__device__ __forceinline__ int2 ids_range(const int* ids, int lo, int hi) {
  int mn = IDS_NONE, mx = -1;
  for (int i = lo + (threadIdx.x & 31); i < hi; i += 32) mn = min(mn, ids[i]), mx = max(mx, ids[i]);
  return make_int2(__reduce_min_sync(0xffffffffu, mn), __reduce_max_sync(0xffffffffu, mx));
}

}  // namespace tc

// The forward on the tensor cores (see the header). One CTA per (64 q rows,
// batch * head); the last q tile launches first.
template <typename E>
__global__ void __launch_bounds__(tc::THREADS, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, const Params p) {
  using namespace smp_tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  const uint32_t aQ = smem_u32(smem), stages = aQ + tc::TILE;
  tc::Aux* aux = reinterpret_cast<tc::Aux*>(smem + tc::AUX);
  const uint32_t full = aQ + tc::BARS, empty = full + 8 * tc::STAGES, q_bar = empty + 8 * tc::STAGES;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * tc::ROWS;
  const int T = p.T, S = p.S;
  const bool ids = p.q_ids != nullptr;
  const float* kpad = p.kpad ? p.kpad + b * p.kpad_sb : nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < tc::STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 128);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warpgroup: its first warp
    setmaxnreg_dec<tc::PRODUCER_REGS>();
    if (threadIdx.x >= 160) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, tc::TILE);
      tma_load_rows(aQ, &mq, q_bar, r0, h, b);
    }
    int it = 0;  // stages filled so far
    // The tile of columns c0 .. c0 + 63 into the next free stage: its Aux by
    // every lane, then K and V by TMA from lane 0. Every lane arrives on the
    // stage's full barrier (32 arrivals, lane 0's with the TMA bytes).
    auto stage = [&](int c0, int c_end) {
      const int s = it % tc::STAGES;
      mbar_wait(empty + 8 * s, ((it / tc::STAGES) & 1) ^ 1);  // the first round finds every stage free
      tc::Aux& a = aux[s];
      for (int i = lane; i < tc::ROWS; i += 32) {
        const int c = c0 + i;
        a.kpad[i] = kpad && c < S ? kpad[c] : 0.f;
        if (ids) a.ids[i] = c < S ? p.kv_ids[c] : IDS_NONE;
      }
      const int bound = ids ? tc::ids_range(p.kv_ids, c0, min(c0 + tc::ROWS, S)).y : 0;
      if (lane == 0) {
        a.c0 = c0;
        a.c_end = c_end;
        a.bound = bound;
        mbar_arrive_expect_tx(full + 8 * s, tc::STAGE);
        tma_load_rows(stages + s * tc::STAGE, &mk, full + 8 * s, c0, h, b);
        tma_load_rows(stages + s * tc::STAGE + tc::TILE, &mv, full + 8 * s, c0, h, b);
      } else {
        mbar_arrive(full + 8 * s);
      }
      ++it;
    };
    int n_pad = 0;
    if (ids) {
      // flash_fwd_kernel's walk, with warp reductions for its block minima:
      // the reference q block's largest valid row id, the smallest kv id,
      // and this CTA's smallest and largest valid row ids.
      const int q_lo = (r0 / p.ref_bq) * p.ref_bq;
      const int rmax_ref = tc::ids_range(p.q_ids, q_lo, min(q_lo + p.ref_bq, T)).y;
      const int kv_min = tc::ids_range(p.kv_ids, 0, S).x;
      const int2 cta = tc::ids_range(p.q_ids, r0, min(r0 + tc::ROWS, T));
      const bool dense = p.causal && kpad == nullptr && cta.x >= kv_min;
      const int num_kv = p.s_pad / p.ref_bk;
      for (int j = 0; j < num_kv; ++j) {
        const int cb = j * p.ref_bk, ce = min(cb + p.ref_bk, S);
        if (p.causal && tc::ids_range(p.kv_ids, cb, ce).x > rmax_ref) continue;  // the reference skips it
        if (j == num_kv - 1) n_pad = p.s_pad - S;
        for (int c0 = cb; c0 < ce; c0 += tc::ROWS) {
          if (dense && tc::ids_range(p.kv_ids, c0, min(c0 + tc::ROWS, ce)).x > cta.y) continue;  // no kept pair
          stage(c0, ce);
        }
      }
    } else {
      const KvWalk w = plain_walk(p, r0);
      n_pad = w.n_pad;
      for (int c0 = w.begin; c0 < w.end; c0 += tc::ROWS) stage(c0, w.c_end);
    }
    // A last stage with c0 = -1 ends the consumer's walk and carries n_pad.
    const int s = it % tc::STAGES;
    mbar_wait(empty + 8 * s, ((it / tc::STAGES) & 1) ^ 1);
    if (lane == 0) {
      aux[s].c0 = -1;
      aux[s].c_end = n_pad;
    }
    mbar_arrive(full + 8 * s);
    return;
  }

  // Consumer warpgroup: q rows r0 .. r0 + 63.
  setmaxnreg_inc<tc::CONSUMER_REGS>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane & 3;
  const uint32_t bh_hash = static_cast<uint32_t>(b * p.head_total + p.head0 + h);
  const int off = S - T, rw = r0 + 16 * warp;  // the warp's 16 q rows
  int r[2], qid[2], lo[2], hi[2];  // the thread's two q rows (accumulator rows lane / 4 and + 8), their ids,
                                   // and (plain mode) the columns [lo, hi) each keeps
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    r[hh] = rw + (lane >> 2) + 8 * hh;
    const bool in = r[hh] < T;
    qid[hh] = ids ? (in ? p.q_ids[r[hh]] : IDS_NONE) : r[hh];
    const int d0 = r[hh] + off;  // the row's diagonal column
    lo[hh] = 0, hi[hh] = in ? S : 0;
    if (in && p.causal) {
      hi[hh] = d0 + 1;
      if (p.window > 0) lo[hh] = d0 - p.window + 1;
    } else if (in && p.window > 0) {
      lo[hh] = d0 - p.window + 1, hi[hh] = d0 + p.window;
    }
  }
  const bool rows_in = rw + 16 <= T;
  const int q_lo = __reduce_min_sync(0xffffffffu, min(qid[0], qid[1]));  // ids mode: the warp's smallest q id
  float o[32], sc[32], m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  int n_pad = 0;
  mbar_wait(q_bar, 0);
  for (int it = 0;; ++it) {
    const int s = it % tc::STAGES;
    mbar_wait(full + 8 * s, (it / tc::STAGES) & 1);
    const tc::Aux& ax = aux[s];
    const int c0 = ax.c0, c_end = ax.c_end;
    if (c0 < 0) {
      n_pad = c_end;
      break;
    }
    const uint32_t aK = stages + s * tc::STAGE, aV = aK + tc::TILE;

    // S = Q K^T: one batch of four wgmma.
    uint64_t da[4], db[4];
    k_steps(da, aQ, false);
    k_steps(db, aK, false);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_ss<E>(sc, da[kk], db[kk], kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // The online softmax of the tile, in flash_fwd_kernel's fp32 order, and
    // p rounded to E as A fragments (accumulator pairs). Warps whose 16 x 64
    // block is all kept and visited skip the mask (masked = false); D:
    // dropout.
    uint32_t pf[16];
    auto softmax = [&](auto masked, auto dropout) {
      constexpr bool M = decltype(masked)::value, D = decltype(dropout)::value;
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 8 * j + 2 * qd;  // this thread's columns cc and cc + 1 of the tile
        const float2 kp = *reinterpret_cast<const float2*>(&ax.kpad[cc]);
        const int2 ki = ids ? *reinterpret_cast<const int2*>(&ax.ids[cc]) : make_int2(0, 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, c = c0 + cc + e;
            float x = __fmul_rn(sc[i], p.scale);
            if (kpad) x = __fadd_rn(x, e ? kp.y : kp.x);
            if (M) {
              const bool keep = ids ? r[hh] < T && (!p.causal || (e ? ki.y : ki.x) <= qid[hh])
                                    : c >= lo[hh] && c < hi[hh];
              x = c >= c_end ? -INFINITY : keep ? x : NEG_BIG;  // past c_end: not visited
            }
            sc[i] = x;
            mt[hh] = fmaxf(mt[hh], x);
          }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
        const float m_new = fmaxf(m[hh], mt[hh]);
        alpha[hh] = expf(m[hh] - m_new);
        m[hh] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 8 * j + 2 * qd;
        const int2 ki = D && ids ? *reinterpret_cast<const int2*>(&ax.ids[cc]) : make_int2(0, 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pr[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pr[e] = expf(sc[4 * j + 2 * hh + e] - m[hh]);
            rs[hh] += pr[e];  // the unrounded p, before dropout
            if (D) {
              const uint32_t hrow = static_cast<uint32_t>(qid[hh]);
              const uint32_t hcol = ids ? static_cast<uint32_t>(e ? ki.y : ki.x) : static_cast<uint32_t>(c0 + cc + e);
              if (dropout_bits(p.seed, bh_hash, hrow, hcol, p.s_total) < p.keep_threshold) pr[e] = 0.f;
            }
          }
          pf[2 * j + hh] = pack2<E>(pr[0], pr[1]);
          o[4 * j + 2 * hh] *= alpha[hh];
          o[4 * j + 2 * hh + 1] *= alpha[hh];
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
        l[hh] = __fadd_rn(__fmul_rn(alpha[hh], l[hh]), rs[hh]);
      }
    };
    bool all = c0 + tc::ROWS <= c_end && rows_in;
    if (ids) all = all && (!p.causal || ax.bound <= q_lo);
    else all = __all_sync(0xffffffffu, all && lo[0] <= c0 && lo[1] <= c0 && hi[0] >= c0 + tc::ROWS &&
                                           hi[1] >= c0 + tc::ROWS);
    if (p.has_dropout) {
      if (all) softmax(std::false_type(), std::true_type());
      else softmax(std::true_type(), std::true_type());
    } else {
      if (all) softmax(std::false_type(), std::false_type());
      else softmax(std::true_type(), std::false_type());
    }

    // O += P V (A from registers, V read MN-major): one batch of four wgmma.
    k_steps(db, aV, true);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_rs<E>(o, pf + 4 * kk, db[kk]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    mbar_arrive(empty + 8 * s);
  }

  // Padding columns in the range score -1e30 too: they count only when every
  // visited score is -1e30 (then each has p = 1 and v = 0).
  const long long at = b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (r[hh] >= T) continue;
    const float li = m[hh] == NEG_BIG ? l[hh] + static_cast<float>(n_pad) : l[hh];
    const float denom = fmaxf(li, 1e-30f);
    const long long row = at + r[hh] * p.o_st;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * hh, d = 8 * j + 2 * qd;
      const float v0 = __fmul_rn(o[i], p.inv_keep) / denom, v1 = __fmul_rn(o[i + 1], p.inv_keep) / denom;
      if (ids) *reinterpret_cast<float2*>(static_cast<float*>(p.o) + row + d) = make_float2(v0, v1);
      else *reinterpret_cast<uint32_t*>(static_cast<E*>(p.o) + row + d) = pack2<E>(v0, v1);
    }
    if (qd == 0) p.lse[static_cast<long long>(bh) * T + r[hh]] = li > 0.f ? m[hh] + logf(denom) : LSE_MASKED;
  }
}

template <typename E, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const size_t smem = sizeof(float) * (size_t)(BM * LD + 2 * BN * LD + BM * LDP + BM + BN + NT / 32);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<E, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + BM - 1) / BM);
  flash_fwd_kernel<E, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 64) return launch<E, 64>(p, stream);
  if (p.hd <= 128) return launch<E, 128>(p, stream);
  return launch<E, 256>(p, stream);
}

template <typename E>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  using namespace smp_tc;
  constexpr CUtensorMapDataType ty = TmaType<E>::value;
  CUtensorMap mq, mk, mv;
  if (!encode_bthd(&mq, ty, p.q, p.T, p.H, p.B, p.q_st, p.q_sh, p.q_sb) ||
      !encode_bthd(&mk, ty, p.k, p.S, p.H, p.B, p.k_st, p.k_sh, p.k_sb) ||
      !encode_bthd(&mv, ty, p.v, p.S, p.H, p.B, p.v_st, p.v_sh, p.v_sb))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.T + tc::ROWS - 1) / tc::ROWS);
  flash_fwd_wgmma_kernel<E><<<grid, tc::THREADS, tc::SMEM_BYTES, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

bool aligned(const void* x, int bytes) { return reinterpret_cast<uintptr_t>(x) % bytes == 0; }

// What TMA and the pair stores need: 16-bit operands with hd 64 on 16-byte
// aligned bases, their (batch, row, head) strides positive multiples of 16
// bytes, S > 0; an output whose element pairs are aligned.
bool tensor_core_ok(int dtype, const Params& p) {
  if ((dtype != 1 && dtype != 2) || p.hd != 64 || p.S < 1) return false;
  for (const void* x : {p.q, p.k, p.v})
    if (!aligned(x, 16)) return false;
  for (long long s : {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_st, p.k_sh, p.v_sb, p.v_st, p.v_sh})
    if (s <= 0 || s % 8 != 0) return false;
  for (long long s : {p.o_sb, p.o_st, p.o_sh})
    if (s % 2 != 0) return false;
  return aligned(p.o, 8);
}

}  // namespace

extern "C" {

// tensor_cores: 1 launches flash_fwd_wgmma_kernel (fp16 or bf16, hd 64,
// tensor_core_ok's strides and alignment; anything else is refused, never
// sent to the other kernel), 0 flash_fwd_kernel. dtype: 0 fp32, 1 fp16, 2
// bf16. Strides are in elements; the head-dim stride is 1. window <= 0 means
// none. q_ids/kv_ids (int32 [T]/[S]) select ids mode (no window; o is fp32),
// null for the plain kernel. Returns a cudaError_t (0 = launched).
int smp_flash_fwd(int tensor_cores, int dtype, const void* q, const void* k, const void* v, const float* kpad,
                  const int* q_ids, const int* kv_ids, void* o, float* lse, int B, int T, int S, int H, int hd, long long q_sb,
                  long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
                  long long v_sb, long long v_st, long long v_sh, long long o_sb, long long o_st,
                  long long o_sh, long long kpad_sb, float scale, int causal, int window,
                  int has_dropout, unsigned int seed, unsigned int keep_threshold,
                  unsigned int s_total, float inv_keep, int head0, int head_total, int ref_bq,
                  int ref_bk, int s_pad, void* stream) {
  if (hd < 1 || hd > 256 || ref_bq % BM != 0 || ref_bk < 1 || s_pad % ref_bk != 0)
    return (int)cudaErrorInvalidValue;
  if ((q_ids == nullptr) != (kv_ids == nullptr) || (q_ids && (window > 0 || ref_bk % BN != 0)))
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    kpad, q_ids, kv_ids, o,    lse,     B,       T,        S,        H,
           hd,   q_sb, q_st, q_sh, k_sb, k_st,    k_sh,    v_sb,     v_st,     v_sh,
           o_sb, o_st, o_sh, kpad_sb, scale, causal, window, has_dropout, seed, keep_threshold,
           s_total, inv_keep, head0, head_total, ref_bq, ref_bk, s_pad};
  if (tensor_cores && !tensor_core_ok(dtype, p)) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = tensor_cores ? cudaErrorInvalidValue : launch_hd<float>(p, s); break;
    case 1: err = tensor_cores ? launch_wgmma<__half>(p, s) : launch_hd<__half>(p, s); break;
    case 2: err = tensor_cores ? launch_wgmma<__nv_bfloat16>(p, s) : launch_hd<__nv_bfloat16>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
