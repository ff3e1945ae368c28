// Fused LM-head cross-entropy for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_ce.py
//   _fwd_kernel    :46  -> fused_ce_fwd_kernel + fused_ce_fwd_merge
//   _bwd_dx_kernel :95  -> fused_ce_bwd_kernel<E, false> + fused_ce_reduce
//   _bwd_dw_kernel :130 -> fused_ce_bwd_kernel<E, true>  + fused_ce_reduce
// launched by _fused_ce_fwd_impl / _fused_ce_bwd_impl through pl.pallas_call,
// the forward and backward of fused_lm_head_ce's custom_vjp. Python wrappers
// and plain PyTorch versions: smdistributed_modelparallel_tpu_torch/ops/fused_ce.py.
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
// Design, in its simplest right form (CUDA-core FMA, as csrc/flash_*.cu):
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
// Not yet used: wgmma, TMA, cp.async pipelining. These kernels run on the CUDA
// cores, far from their bound; making them fast is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// dw = 0: dx [N, D] into out; dw = 1: dW [V, D] into out (x's dtype).
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

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
