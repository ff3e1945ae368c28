// Fused bias + tanh-GELU, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces: smdistributed_modelparallel_tpu/ops/pallas_gelu.py
//   _fwd_kernel :54 -> bias_gelu_fwd_vec_kernel (route "vec"),
//                      bias_gelu_fwd_kernel (route "simt")
//   _bwd_kernel :59 and _bg_bwd's cast and row sum (:112-122)
//                   -> bias_gelu_bwd_vec_kernel + bias_gelu_db_kernel ("vec"),
//                      bias_gelu_bwd_kernel, then a torch cast and row sum ("simt")
// launched by _call_rowwise (pl.pallas_call at :82) from bias_gelu's forward
// and its custom_vjp backward _bg_bwd (:112); the MLP's fc epilogue
// (nn/transformer.py, fused_bias_gelu). Python wrappers, the routes and plain
// PyTorch versions: smdistributed_modelparallel_tpu_torch/ops/bias_gelu.py.
//
// What they compute, for x [N, F] (fp32, fp16 or bf16), a bias b [F] and, in
// the backward, g [N, F] in x's dtype, with u = float(x) + float(b):
//   forward:  y = 0.5 u (1 + tanh(s (u + c u^3))) in x's dtype;
//   backward: dpre = g * (0.5 (1 + t) + 0.5 u (1 - t^2) s (1 + 3c u^2)) in
//             fp32, t = tanh(s (u + c u^3)); then dx = dpre rounded once to
//             x's dtype and db = the fp32 column sum of the unrounded dpre,
//             rounded once to b's dtype (_bg_bwd);
// s = sqrt(2 / pi), c = 0.044715, evaluated in the TPU kernel's order
// (pallas_gelu._gelu_tanh / _dgelu_tanh, left to right). Every product and
// sum is __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs the
// reference does not do, and tanh is the accurate tanhf (no fast-math, no
// tanh.approx: its ~2^-11 error is a large relative error of y where 1 + t is
// small), so y and dpre equal the plain PyTorch version's on the card.
//
// Bound on an H100 (GPT-2 124M's MLP: N = 2048, F = 3072, bf16): an
// elementwise pass with ~10 (forward) and ~20 (backward) fp32 operations per
// element, far below the card's fp32 rate, so bytes bind: the forward reads x
// and writes y (25.2 MB, 7.5 us at 3.35 TB/s); the whole backward reads x and
// g and writes dx, plus [F]-sized b and db (37.8 MB, 11.3 us). The
// instructions the SMs must dispatch per element (conversions, accurate tanhf,
// unfused products) come close to that time, so the design cuts them too.
//
// Design of the "vec" kernels (rows a multiple of 16 bytes, 16-byte aligned
// bases). A block is VT x VR threads: threadIdx.x picks a group of V = 16 /
// sizeof(E) neighbouring columns (one 16-byte access; a warp reads 512
// contiguous bytes of a row), threadIdx.y one of VR row slices. A thread
// widens its V bias values to fp32 once (b is read in its own dtype: fp32,
// fp16 or bf16; exact), then walks its rows VU at a time, the next VU rows'
// 16-byte loads (x, and g) started before this pass's arithmetic: a grid of one
// wave starts every warp together, and without that prefetch they would all
// load, then all compute, leaving the memory idle meanwhile. Packed
// conversions (bf16x2 / f16x2 <-> float2) and one 64-bit row base a row keep
// the instructions per element down.
//   Backward: each thread adds its unrounded fp32 dpre into V registers in
// row order; the block adds its VR row slices in slice order through 8 KB of
// shared memory and writes one fp32 partial a column for its band of
// rows_per_band rows into partials [n_bands, F]; bias_gelu_db_kernel then adds
// the bands in band order and rounds once to b's dtype. No atomics: every
// repeat gives the same bits. The wrapper sizes the bands so the grid is one
// wave of BWD_BLOCKS_PER_SM blocks an SM (registers capped to fit them) and
// the partials stay near 400 KB (393 KB at the path's shape); the forward's
// grid is one wave of FWD_BLOCKS_PER_SM blocks an SM, each walking the same
// number of row blocks.
// The "simt" kernels (one element a thread per step, fp32 bias, fp32 dpre out)
// take what "vec" does not: a row of other bytes, a base off 16 bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;
constexpr int VT = 32;  // "vec": column groups of a block (threadIdx.x)
constexpr int VR = 8;   // "vec": row slices of a block (threadIdx.y)
constexpr int VU = 2;   // "vec": rows of a thread's pass (the next pass's loads fly during it)
constexpr int FWD_BLOCKS_PER_SM = 4;  // "vec" forward: resident blocks an SM (at most 64 registers a thread)
constexpr int BWD_BLOCKS_PER_SM = 3;  // "vec" backward: the same (at most 85), as the wrapper's bands assume
constexpr int DB_NT = 256;
constexpr int DB_BATCH = 16;  // bias_gelu_db_kernel: partials loaded before they are added
constexpr float S2PI = (float)0.7978845608028654;    // sqrt(2 / pi), a double cast as Python's
constexpr float COEFF = (float)0.044715;
constexpr float COEFF3 = (float)(3.0 * 0.044715);    // 3.0 * _COEFF, folded in double as in Python

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

// s * (u + c * u * u * u)
__device__ __forceinline__ float inner_of(float u) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(COEFF, u), u), u);
  return __fmul_rn(S2PI, __fadd_rn(u, cube));
}

// 0.5 * u * (1 + tanh(inner))
__device__ __forceinline__ float gelu_tanh(float u) {
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, tanhf(inner_of(u))));
}

// gelu'(u) = 0.5 * (1 + t) + 0.5 * u * sech2 * dinner
__device__ __forceinline__ float dgelu_tanh(float u) {
  const float t = tanhf(inner_of(u));
  const float sech2 = __fsub_rn(1.f, __fmul_rn(t, t));
  // s * (1 + 3c * u * u)
  const float dinner = __fmul_rn(S2PI, __fadd_rn(1.f, __fmul_rn(__fmul_rn(COEFF3, u), u)));
  const float left = __fmul_rn(0.5f, __fadd_rn(1.f, t));
  const float right = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, u), sech2), dinner);
  return __fadd_rn(left, right);
}

template <typename E>
__global__ void __launch_bounds__(NT)
bias_gelu_fwd_kernel(const E* __restrict__ x, const float* __restrict__ b, E* __restrict__ y, int N,
                     int F) {
  for (long long r = blockIdx.y; r < N; r += gridDim.y) {
    for (int c = blockIdx.x * NT + threadIdx.x; c < F; c += gridDim.x * NT) {
      const long long e = r * F + c;
      y[e] = from_f<E>(gelu_tanh(__fadd_rn(to_f<E>(x[e]), b[c])));
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(NT)
bias_gelu_bwd_kernel(const E* __restrict__ x, const float* __restrict__ b, const E* __restrict__ g,
                     float* __restrict__ dpre, int N, int F) {
  for (long long r = blockIdx.y; r < N; r += gridDim.y) {
    for (int c = blockIdx.x * NT + threadIdx.x; c < F; c += gridDim.x * NT) {
      const long long e = r * F + c;
      dpre[e] = __fmul_rn(to_f<E>(g[e]), dgelu_tanh(__fadd_rn(to_f<E>(x[e]), b[c])));
    }
  }
}

// 16 bytes of E <-> V floats, by packed conversions.
template <typename E> struct Pack;

template <> struct Pack<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ float2 to_f2(__nv_bfloat162 h) { return __bfloat1622float2(h); }
__device__ __forceinline__ float2 to_f2(__half2 h) { return __half22float2(h); }
template <typename H2> __device__ __forceinline__ H2 from_f2(float a, float b);
template <> __device__ __forceinline__ __nv_bfloat162 from_f2<__nv_bfloat162>(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ __half2 from_f2<__half2>(float a, float b) { return __floats2half2_rn(a, b); }

// Eight 16-bit values as four packed pairs (H2: __nv_bfloat162 or __half2).
template <typename H2> struct Pack16 {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& w, float* f) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      H2 h;
      memcpy(&h, &words[i], 4);
      const float2 p = to_f2(h);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const H2 h = from_f2<H2>(f[2 * i], f[2 * i + 1]);  // each rounded once, to nearest even
      memcpy(&words[i], &h, 4);
    }
    return make_uint4(words[0], words[1], words[2], words[3]);
  }
};

template <> struct Pack<__nv_bfloat16> : Pack16<__nv_bfloat162> {};
template <> struct Pack<__half> : Pack16<__half2> {};

// Rows r0, r0 + VR, ..., r0 + (VU - 1) VR (those below end) of a 16-byte
// column group: v[k] = p[(r0 + k VR) * row16].
__device__ __forceinline__ void load_rows(const uint4* p, long long row16, long long r0, long long end,
                                          uint4 (&v)[VU]) {
#pragma unroll
  for (int k = 0; k < VU; ++k)
    if (r0 + k * VR < end) v[k] = p[(r0 + k * VR) * row16];
}

template <typename E, typename B>
__global__ void __launch_bounds__(VT * VR, FWD_BLOCKS_PER_SM)
bias_gelu_fwd_vec_kernel(const E* __restrict__ x, const B* __restrict__ b, E* __restrict__ y, int N, int F) {
  constexpr int V = Pack<E>::V;
  const int cg = blockIdx.x * VT + threadIdx.x;
  if (cg >= F / V) return;
  float bias[V];
#pragma unroll
  for (int j = 0; j < V; ++j) bias[j] = to_f<B>(b[cg * V + j]);
  const uint4* xs = reinterpret_cast<const uint4*>(x) + cg;
  uint4* ys = reinterpret_cast<uint4*>(y) + cg;
  const long long row16 = F / V;  // 16-byte words a row
  const long long step = (long long)gridDim.y * (VR * VU);
  long long r0 = (long long)blockIdx.y * (VR * VU) + threadIdx.y;
  uint4 v[VU];
  load_rows(xs, row16, r0, N, v);
  for (; r0 < N; r0 += step) {
    uint4 next[VU];  // the next pass's rows, in flight while this pass computes
    load_rows(xs, row16, r0 + step, N, next);
#pragma unroll
    for (int k = 0; k < VU; ++k) {
      if (r0 + k * VR < N) {
        float f[V];
        Pack<E>::unpack(v[k], f);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = gelu_tanh(__fadd_rn(f[j], bias[j]));
        ys[(r0 + k * VR) * row16] = Pack<E>::pack(f);
      }
    }
#pragma unroll
    for (int k = 0; k < VU; ++k) v[k] = next[k];
  }
}

template <typename E, typename B>
__global__ void __launch_bounds__(VT * VR, BWD_BLOCKS_PER_SM)
bias_gelu_bwd_vec_kernel(const E* __restrict__ x, const B* __restrict__ b, const E* __restrict__ g,
                         E* __restrict__ dx, float* __restrict__ partials, int N, int F, int rows_per_band) {
  constexpr int V = Pack<E>::V;
  __shared__ __align__(16) float red[VR][VT * V];
  const int cg = blockIdx.x * VT + threadIdx.x;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (cg < F / V) {
    float bias[V];
#pragma unroll
    for (int j = 0; j < V; ++j) bias[j] = to_f<B>(b[cg * V + j]);
    const uint4* xs = reinterpret_cast<const uint4*>(x) + cg;
    const uint4* gs = reinterpret_cast<const uint4*>(g) + cg;
    uint4* dxs = reinterpret_cast<uint4*>(dx) + cg;
    const long long row16 = F / V;
    const long long begin = (long long)blockIdx.y * rows_per_band;
    const long long end = min((long long)N, begin + rows_per_band);
    // Rows begin + threadIdx.y, + VR, + 2 VR, ...: each thread's in ascending order.
    long long r0 = begin + threadIdx.y;
    uint4 xv[VU], gv[VU];
    load_rows(xs, row16, r0, end, xv);
    load_rows(gs, row16, r0, end, gv);
    for (; r0 < end; r0 += VR * VU) {
      uint4 xn[VU], gn[VU];  // the next rows, in flight while these compute
      load_rows(xs, row16, r0 + VR * VU, end, xn);
      load_rows(gs, row16, r0 + VR * VU, end, gn);
#pragma unroll
      for (int k = 0; k < VU; ++k) {
        if (r0 + k * VR < end) {
          float u[V], d[V];
          Pack<E>::unpack(xv[k], u);
          Pack<E>::unpack(gv[k], d);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            d[j] = __fmul_rn(d[j], dgelu_tanh(__fadd_rn(u[j], bias[j])));  // dpre, fp32
            acc[j] = __fadd_rn(acc[j], d[j]);
          }
          dxs[(r0 + k * VR) * row16] = Pack<E>::pack(d);
        }
      }
#pragma unroll
      for (int k = 0; k < VU; ++k) {
        xv[k] = xn[k];
        gv[k] = gn[k];
      }
    }
  }
  // The block's VR row slices, added in slice order: one partial a column.
  float4* mine = reinterpret_cast<float4*>(&red[threadIdx.y][threadIdx.x * V]);
#pragma unroll
  for (int q = 0; q < V / 4; ++q) mine[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  __syncthreads();
  const int col = threadIdx.y * VT + threadIdx.x;  // of the block's VT * V columns
  const long long c = (long long)blockIdx.x * (VT * V) + col;
  if (col < VT * V && c < F) {
    float s = red[0][col];
#pragma unroll
    for (int i = 1; i < VR; ++i) s = __fadd_rn(s, red[i][col]);
    partials[(long long)blockIdx.y * F + c] = s;
  }
}

// db[c] = the bands' partials of column c added in band order, rounded once.
template <typename B>
__global__ void __launch_bounds__(DB_NT)
bias_gelu_db_kernel(const float* __restrict__ partials, B* __restrict__ db, int n_bands, int F) {
  const int c = blockIdx.x * DB_NT + threadIdx.x;
  if (c >= F) return;
  float s = 0.f;
  for (int k0 = 0; k0 < n_bands; k0 += DB_BATCH) {
    float p[DB_BATCH];
#pragma unroll
    for (int k = 0; k < DB_BATCH; ++k)
      if (k0 + k < n_bands) p[k] = partials[(long long)(k0 + k) * F + c];
#pragma unroll
    for (int k = 0; k < DB_BATCH; ++k)
      if (k0 + k < n_bands) s = __fadd_rn(s, p[k]);
  }
  db[c] = from_f<B>(s);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

dim3 grid_of(int N, int F) {
  const int cols = ceil_div(F, NT);
  return dim3(cols < 1024 ? cols : 1024, N < 65535 ? N : 65535);
}

template <typename E>
cudaError_t launch(int bwd, const void* x, const float* b, const void* g, void* out, int N, int F,
                   cudaStream_t s) {
  const dim3 grid = grid_of(N, F);
  if (bwd)
    bias_gelu_bwd_kernel<E><<<grid, NT, 0, s>>>(static_cast<const E*>(x), b, static_cast<const E*>(g),
                                                static_cast<float*>(out), N, F);
  else
    bias_gelu_fwd_kernel<E><<<grid, NT, 0, s>>>(static_cast<const E*>(x), b, static_cast<E*>(out), N, F);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// SMs of the current device (cached a device).
int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 1;
}

template <typename E, typename B>
cudaError_t launch_vec(int bwd, const void* x, const void* b, const void* g, void* out, float* partials,
                       void* db, int N, int F, int rows_per_band, int n_bands, cudaStream_t s) {
  constexpr int V = Pack<E>::V;
  if (F % V != 0) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(out) || (bwd && !aligned16(g))) return cudaErrorMisalignedAddress;
  const dim3 block(VT, VR);
  const int col_blocks = ceil_div(F / V, VT);
  if (!bwd) {
    // One wave: each block walks `passes` blocks of VR * VU rows, so every
    // block of the grid is resident at once and has the same work.
    const long long row_blocks = ceil_div(N, VR * VU);
    const long long resident = (long long)FWD_BLOCKS_PER_SM * sm_count();
    const long long passes = (row_blocks * col_blocks + resident - 1) / resident;
    const long long gy = (row_blocks + passes - 1) / passes;
    if (N > 0)
      bias_gelu_fwd_vec_kernel<E, B><<<dim3(col_blocks, gy < 65535 ? (int)gy : 65535), block, 0, s>>>(
          static_cast<const E*>(x), static_cast<const B*>(b), static_cast<E*>(out), N, F);
    return cudaGetLastError();
  }
  if (rows_per_band <= 0 || n_bands != ceil_div(N, rows_per_band) || n_bands > 65535) return cudaErrorInvalidValue;
  if (N > 0)
    bias_gelu_bwd_vec_kernel<E, B><<<dim3(col_blocks, n_bands), block, 0, s>>>(
        static_cast<const E*>(x), static_cast<const B*>(b), static_cast<const E*>(g), static_cast<E*>(out),
        partials, N, F, rows_per_band);
  bias_gelu_db_kernel<B><<<ceil_div(F, DB_NT), DB_NT, 0, s>>>(partials, static_cast<B*>(db), n_bands, F);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_vec_b(int b_dtype, int bwd, const void* x, const void* b, const void* g, void* out,
                         float* partials, void* db, int N, int F, int rows_per_band, int n_bands, cudaStream_t s) {
  switch (b_dtype) {
    case 0: return launch_vec<E, float>(bwd, x, b, g, out, partials, db, N, F, rows_per_band, n_bands, s);
    case 1: return launch_vec<E, __half>(bwd, x, b, g, out, partials, db, N, F, rows_per_band, n_bands, s);
    case 2: return launch_vec<E, __nv_bfloat16>(bwd, x, b, g, out, partials, db, N, F, rows_per_band, n_bands, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Route "simt". dtype: 0 fp32, 1 fp16, 2 bf16, of x (and g, and the forward's
// out). x [N, F], g [N, F] and out [N, F] are contiguous row-major; b is fp32
// [F]. bwd = 0: out = gelu(x + b) in x's dtype (g unused, may be null);
// bwd = 1: out = g * gelu'(x + b) in fp32. Returns a cudaError_t (0 = launched).
int smp_bias_gelu(int dtype, int bwd, const void* x, const float* b, const void* g, void* out, int N,
                  int F, void* stream) {
  if (N < 0 || F < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(bwd, x, b, g, out, N, F, s);
    case 1: return (int)launch<__half>(bwd, x, b, g, out, N, F, s);
    case 2: return (int)launch<__nv_bfloat16>(bwd, x, b, g, out, N, F, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Route "vec". dtype as above, of x, g and out; b_dtype (the same codes) of b
// and db. x, g and out [N, F] contiguous row-major on 16-byte aligned bases,
// F * sizeof(x) a multiple of 16; b [F] contiguous (any alignment).
// bwd = 0: out = gelu(x + b) in x's dtype (g, partials, db unused).
// bwd = 1: out = dx = g * gelu'(x + b) rounded to x's dtype; partials fp32
// [n_bands, F] scratch, n_bands = ceil(N / rows_per_band); db [F] in b's
// dtype. Refuses (cudaErrorInvalidValue, cudaErrorMisalignedAddress) what it
// cannot take. Returns a cudaError_t (0 = launched).
int smp_bias_gelu_vec(int dtype, int b_dtype, int bwd, const void* x, const void* b, const void* g, void* out,
                      float* partials, void* db, int N, int F, int rows_per_band, int n_bands, void* stream) {
  if (N < 0 || F <= 0) return (int)(F == 0 && N >= 0 ? cudaSuccess : cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_vec_b<float>(b_dtype, bwd, x, b, g, out, partials, db, N, F, rows_per_band, n_bands, s);
    case 1: return (int)launch_vec_b<__half>(b_dtype, bwd, x, b, g, out, partials, db, N, F, rows_per_band, n_bands, s);
    case 2:
      return (int)launch_vec_b<__nv_bfloat16>(b_dtype, bwd, x, b, g, out, partials, db, N, F, rows_per_band,
                                              n_bands, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
