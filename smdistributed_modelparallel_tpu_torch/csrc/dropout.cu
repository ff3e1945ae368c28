// Threefry random bits and dropout for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces: no Pallas kernel. The JAX package draws flax's nn.Dropout
// (smdistributed_modelparallel_tpu/nn/transformer.py:530, :670, :1266;
// models/transformer_lm.py:181), the plain attention path's dropout
// (ops/attention.py:203-206) and the sampler's Gumbel draw
// (generation.py:76, jax.random.categorical) from jax.random, which XLA
// lowers to threefry2x32 fused with the select. Python wrappers and plain
// PyTorch versions: smdistributed_modelparallel_tpu_torch/ops/dropout.py.
//
// What they compute (jax 0.9, jax_threefry_partitionable on): element i of
// jax.random.bits(key, shape) is the Threefry-2x32 hash (20 rounds, key
// schedule k0, k1, k0 ^ k1 ^ 0x1BD11BDA) of the counter (i >> 32, i &
// 0xFFFFFFFF), its two output words XORed; i is the flat row-major index.
//   smp_threefry_bits: those uint32 bits for n elements under an index map:
//                      local element i is global element offset + (i / run)
//                      * stride + i % run (run = n: the flat range [offset,
//                      offset + n)), so a shard draws its part of a global
//                      array: a tp rank's heads of [B, H, T, S] probabilities
//                      are B runs of (H/tp)*T*S at stride H*T*S, its T block
//                      of [B, T, D] B runs of (T/tp)*D at stride T*D.
//   smp_dropout_fwd:   over the same map, keep = uniform < thresh, uniform = float bits with
//                      exponent 1 and the top 23 random bits as mantissa,
//                      minus 1 (jax.random.uniform), thresh = fp32(1 - rate)
//                      (jax.random.bernoulli); y = keep ? x / kp : 0 with kp
//                      = 1 - rate rounded to x's dtype and the quotient an
//                      IEEE fp32 division rounded once to x's dtype (flax's
//                      select(mask, x / keep_prob, 0)); mask = keep (1 byte).
//   smp_dropout_bwd:   dx = keep ? dy / kp : 0, keep read from the forward's
//                      mask (a backward that recomputed the bits from the key
//                      took 0.0087 ms against this one's 0.0047 at [2048, 768]
//                      bf16 on an H100, so only the mask is kept).
// The division is __fdiv_rn and the subtraction exact, so every output bit
// equals the plain version's.
//
// Design: one thread an element (a 64-bit grid-stride loop), the rotations
// as funnel shifts, no shared memory; the key and the constants arrive as
// kernel arguments, so the hash is registers only and each warp's loads and
// stores are contiguous. The index map is the grid's y dimension (a run a row
// of blocks), so a mapped element costs one add more than a flat draw and no
// division; a flat range launches the kernels' flat instantiation, the plain
// loop. The hash binds the forward and smp_threefry_bits;
// chip_smoke.py bounds them by the integer instructions that cuobjdump
// counts in their compiled loops, by pipe.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks of 256 threads an SM: a full H100 wave

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define SMP_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;

// jax.random.bits' uint32 for the 64-bit counter c under the key (k0, k1).
__device__ __forceinline__ uint32_t threefry_bits32(uint32_t k0, uint32_t k1, uint64_t c) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(c >> 32) + k0;
  uint32_t x1 = (uint32_t)c + k1;
  SMP_ROUND(13) SMP_ROUND(15) SMP_ROUND(26) SMP_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  SMP_ROUND(17) SMP_ROUND(29) SMP_ROUND(16) SMP_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  SMP_ROUND(13) SMP_ROUND(15) SMP_ROUND(26) SMP_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  SMP_ROUND(17) SMP_ROUND(29) SMP_ROUND(16) SMP_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  SMP_ROUND(13) SMP_ROUND(15) SMP_ROUND(26) SMP_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef SMP_ROUND

// jax.random.bernoulli(key, p)'s draw for the counter: uniform < thresh.
__device__ __forceinline__ bool keep_bit(uint32_t k0, uint32_t k1, uint64_t c, float thresh) {
  const float u = __fsub_rn(__uint_as_float((threefry_bits32(k0, k1, c) >> 9) | 0x3F800000u), 1.0f);
  return u < thresh;
}

template <typename E>
__device__ __forceinline__ float to_f32(E v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// The index map as a grid: run b of nruns (blockIdx.y, then strides of
// gridDim.y) starts at local element b * run and global counter offset + b *
// stride; the blocks along x stride through the run. MAPPED false compiles the
// flat range (one run, a 1-D grid) to the plain grid-stride loop.
template <bool MAPPED>
__global__ void __launch_bounds__(NT) threefry_bits_kernel(uint32_t* __restrict__ out, uint32_t k0, uint32_t k1,
                                                          int64_t offset, int64_t nruns, int64_t run,
                                                          int64_t stride) {
  if (!MAPPED) {
    for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < run; i += (int64_t)gridDim.x * NT) {
      out[i] = threefry_bits32(k0, k1, (uint64_t)(offset + i));
    }
    return;
  }
  for (int64_t b = blockIdx.y; b < nruns; b += gridDim.y) {
    uint32_t* __restrict__ o = out + b * run;
    const uint64_t base = (uint64_t)(offset + b * stride);
    for (int64_t j = (int64_t)blockIdx.x * NT + threadIdx.x; j < run; j += (int64_t)gridDim.x * NT) {
      o[j] = threefry_bits32(k0, k1, base + (uint64_t)j);
    }
  }
}

template <typename E, bool MAPPED>
__global__ void __launch_bounds__(NT) dropout_fwd_kernel(const E* __restrict__ x, E* __restrict__ y,
                                                        uint8_t* __restrict__ mask, uint32_t k0, uint32_t k1,
                                                        int64_t offset, int64_t nruns, int64_t run, int64_t stride,
                                                        float thresh, float kp) {
  if (!MAPPED) {
    for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < run; i += (int64_t)gridDim.x * NT) {
      const bool keep = keep_bit(k0, k1, (uint64_t)(offset + i), thresh);
      y[i] = keep ? from_f32<E>(__fdiv_rn(to_f32<E>(x[i]), kp)) : from_f32<E>(0.0f);
      mask[i] = keep;
    }
    return;
  }
  for (int64_t b = blockIdx.y; b < nruns; b += gridDim.y) {
    const E* __restrict__ xb = x + b * run;
    E* __restrict__ yb = y + b * run;
    uint8_t* __restrict__ mb = mask + b * run;
    const uint64_t base = (uint64_t)(offset + b * stride);
    for (int64_t j = (int64_t)blockIdx.x * NT + threadIdx.x; j < run; j += (int64_t)gridDim.x * NT) {
      const bool keep = keep_bit(k0, k1, base + (uint64_t)j, thresh);
      yb[j] = keep ? from_f32<E>(__fdiv_rn(to_f32<E>(xb[j]), kp)) : from_f32<E>(0.0f);
      mb[j] = keep;
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(NT) dropout_bwd_kernel(const E* __restrict__ dy, E* __restrict__ dx,
                                                        const uint8_t* __restrict__ mask, int64_t n, float kp) {
  for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < n; i += (int64_t)gridDim.x * NT) {
    dx[i] = mask[i] != 0 ? from_f32<E>(__fdiv_rn(to_f32<E>(dy[i]), kp)) : from_f32<E>(0.0f);
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + NT - 1) / NT;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

// The grid of an index map: up to a full wave of blocks in all, as many runs
// side by side along y as it holds (at most 65535), the rest along each run.
dim3 map_grid(int64_t nruns, int64_t run) {
  const int64_t total = grid_for(nruns * run);
  int64_t gy = nruns < total ? nruns : total;
  if (gy > 65535) gy = 65535;
  int64_t gx = total / gy;
  const int64_t per_run = (run + NT - 1) / NT;
  if (gx > per_run) gx = per_run;
  return dim3((unsigned)(gx > 0 ? gx : 1), (unsigned)gy);
}

template <typename E>
cudaError_t launch_fwd(const void* x, void* y, uint8_t* mask, uint32_t k0, uint32_t k1, int64_t n, int64_t offset,
                       int64_t run, int64_t stride, float thresh, float kp, cudaStream_t s) {
  if (run == n) {
    dropout_fwd_kernel<E, false><<<grid_for(n), NT, 0, s>>>(static_cast<const E*>(x), static_cast<E*>(y), mask, k0,
                                                            k1, offset, 1, n, n, thresh, kp);
  } else {
    dropout_fwd_kernel<E, true><<<map_grid(n / run, run), NT, 0, s>>>(static_cast<const E*>(x), static_cast<E*>(y),
                                                                      mask, k0, k1, offset, n / run, run, stride,
                                                                      thresh, kp);
  }
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_bwd(const void* dy, void* dx, const uint8_t* mask, int64_t n, float kp, cudaStream_t s) {
  dropout_bwd_kernel<E><<<grid_for(n), NT, 0, s>>>(static_cast<const E*>(dy), static_cast<E*>(dx), mask, n, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [n] uint32: the bits of jax.random.bits((k0, k1), shape) at global
// elements offset + (i / run) * stride + i % run (run = n: the flat range).
// Returns a cudaError_t (0 = launched).
int smp_threefry_bits(uint32_t* out, uint32_t k0, uint32_t k1, long long offset, long long n, long long run,
                      long long stride, void* stream) {
  if (n < 0 || offset < 0 || run <= 0 || run > n || n % run != 0 || stride < run) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (run == n) {
    threefry_bits_kernel<false><<<grid_for(n), NT, 0, s>>>(out, k0, k1, offset, 1, n, n);
  } else {
    threefry_bits_kernel<true><<<map_grid(n / run, run), NT, 0, s>>>(out, k0, k1, offset, n / run, run, stride);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 fp32, 1 fp16, 2 bf16 of x and y; x, y [n] and mask [n] (uint8)
// contiguous, element i at global counter offset + (i / run) * stride + i %
// run. thresh = fp32(1 - rate); kp = 1 - rate rounded to x's dtype.
int smp_dropout_fwd(int dtype, const void* x, void* y, uint8_t* mask, uint32_t k0, uint32_t k1, long long n,
                    long long offset, long long run, long long stride, float thresh, float kp, void* stream) {
  if (n < 0 || mask == nullptr || offset < 0 || run <= 0 || run > n || n % run != 0 || stride < run) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(x, y, mask, k0, k1, n, offset, run, stride, thresh, kp, s);
    case 1: return (int)launch_fwd<__half>(x, y, mask, k0, k1, n, offset, run, stride, thresh, kp, s);
    case 2: return (int)launch_fwd<__nv_bfloat16>(x, y, mask, k0, k1, n, offset, run, stride, thresh, kp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dx = mask ? dy / kp : 0 (dy, dx [n] of dtype, mask [n] uint8, contiguous).
int smp_dropout_bwd(int dtype, const void* dy, void* dx, const uint8_t* mask, long long n, float kp, void* stream) {
  if (n < 0 || mask == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(dy, dx, mask, n, kp, s);
    case 1: return (int)launch_bwd<__half>(dy, dx, mask, n, kp, s);
    case 2: return (int)launch_bwd<__nv_bfloat16>(dy, dx, mask, n, kp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
