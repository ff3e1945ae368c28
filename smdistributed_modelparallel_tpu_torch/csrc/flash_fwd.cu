// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_attention.py
//   _fwd_kernel (launched by _flash_fwd_impl through pl.pallas_call), the
//   kernel behind flash_attention. Python wrapper and plain PyTorch version:
//   smdistributed_modelparallel_tpu_torch/ops/flash_attention.py.
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
// tensor-core time against ~3.8 us of memory time: memory-bound.
//
// Design, in its simplest right form:
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
// Not yet used: wgmma, TMA, cp.async pipelining, warp specialisation. This
// kernel runs on the CUDA cores and is far from its bound; making it fast is
// later work.
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
    // The reference kv range of this tile's rows (_kv_bounds).
    const int q_hi = q_lo + p.ref_bq;
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
    n_pad = max(0, c_hi - max(S, c_lo));

    // Tighten to this tile's band when that is exact (see the header).
    const int r_last = min(r0 + BM, T) - 1;
    bool dense = kpad == nullptr;
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
    for (int c0 = k_begin; c0 < k_end; c0 += BN) tile(c0, c_end);
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

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 fp16, 2 bf16. Strides are in elements; the head-dim
// stride is 1. window <= 0 means none. q_ids/kv_ids (int32 [T]/[S]) select
// ids mode (no window; o is fp32), null for the plain kernel. Returns a
// cudaError_t (0 = launched).
int smp_flash_fwd(int dtype, const void* q, const void* k, const void* v, const float* kpad,
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
  if (B * H == 0 || T == 0) return 0;
  Params p{q,    k,    v,    kpad, q_ids, kv_ids, o,    lse,     B,       T,        S,        H,
           hd,   q_sb, q_st, q_sh, k_sb, k_st,    k_sh,    v_sb,     v_st,     v_sh,
           o_sb, o_st, o_sh, kpad_sb, scale, causal, window, has_dropout, seed, keep_threshold,
           s_total, inv_keep, head0, head_total, ref_bq, ref_bk, s_pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_hd<float>(p, s); break;
    case 1: err = launch_hd<__half>(p, s); break;
    case 2: err = launch_hd<__nv_bfloat16>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
