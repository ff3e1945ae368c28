// The health sentinel's reduction for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces: no Pallas kernel. The JAX package's sentinel
// (smdistributed_modelparallel_tpu/utils/health.py:132-162, HealthCollector.
// add_tree / add_stacked, packed by pack() at :210-225) is a set of
// reductions that XLA fuses into the compiled step program. The eager port
// has no such fusion: in plain PyTorch each tensor costs about six launches
// (cast, isfinite, not, sum, abs/where, amax), some 900 a GPT-2 124M step.
// Python wrapper and plain PyTorch version:
// smdistributed_modelparallel_tpu_torch/ops/health_reduce.py.
//
// What it computes: the health word [K, 3] fp32 of K entries. An entry is a
// list of leaves; a leaf is one or more segments (contiguous fp32, bf16 or
// fp16 runs of memory) that share its count slots. A tree entry has one
// count slot a leaf; a stacked entry (num_mb > 0) has num_mb slots a leaf,
// one a microbatch, and its segments are the leaf's rows. Row k of the word:
//   [0] the non-finite elements: each leaf's (or each leaf-microbatch's)
//       count is exact (a 64-bit integer), converted to fp32 once, and the
//       fp32 values are added in leaf order (stacked: per[mb] over the
//       leaves, then the per[mb] in microbatch order), as the JAX package's
//       jnp.sum(~fin).astype(f32) accumulates;
//   [1] the largest finite |x| over the entry (0 when there is none);
//   [2] stacked: the first microbatch whose per[mb] > 0, or -1; tree: -1.
//
// Bound: the bytes read. Every element is read once, from device memory
// (GPT-2 124M's fp32 gradients are 497 MB, about 0.15 ms at 3.35 TB/s).
//
// Design: the host flattens every segment into a table (one int64 buffer,
// uploaded once and cached by the segments' addresses) and cuts each
// segment into chunks of CHUNK elements; a chunk prefix sum lets a block
// find its segment by binary search. Blocks walk the chunks grid-stride with
// 16-byte vector loads (where the chunk's address is 16-byte aligned;
// scalar loads otherwise), reduce the count and the abs-max in the block,
// and add them with one atomicAdd (uint64 count slot) and one atomicMax
// (abs-max as the uint32 bits of a non-negative float, whose order is the
// float order). The last block to finish (a ticket counter after a
// __threadfence) writes the word: one launch, no second pass.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr long long CHUNK = 16384;        // elements a chunk
constexpr int MAX_BLOCKS = 132 * 8;       // 8 blocks of 256 threads an SM

// Table layout (int64), offsets in elements:
//   segs   [S][4]: pointer, element count, dtype | entry << 8, count slot
//   prefix [S + 1]: cumulative chunks of the segments
//   leaf   [L]: a leaf's first count slot
//   ebegin [K + 1]: an entry's leaves are leaf[ebegin[k] .. ebegin[k + 1])
//   enmb   [K]: an entry's microbatches (0: a tree entry)
struct Table {
  const long long* segs;
  const long long* prefix;
  const long long* leaf;
  const long long* ebegin;
  const long long* enmb;
  int S, K;
};

__device__ __forceinline__ void take(float v, unsigned& bad, float& mx) {
  if (isfinite(v)) {
    mx = fmaxf(mx, fabsf(v));
  } else {
    ++bad;
  }
}

__device__ __forceinline__ float to_f32(const void* p, long long i, int dtype) {
  if (dtype == 0) return static_cast<const float*>(p)[i];
  if (dtype == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// One 16-byte vector: 4 fp32 or 8 half values.
__device__ __forceinline__ void take_vec(const uint4& q, int dtype, unsigned& bad, float& mx) {
  if (dtype == 0) {
    take(__uint_as_float(q.x), bad, mx);
    take(__uint_as_float(q.y), bad, mx);
    take(__uint_as_float(q.z), bad, mx);
    take(__uint_as_float(q.w), bad, mx);
    return;
  }
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned short lo = static_cast<unsigned short>(w[j] & 0xFFFFu);
    const unsigned short hi = static_cast<unsigned short>(w[j] >> 16);
    if (dtype == 1) {
      take(__half2float(__ushort_as_half(lo)), bad, mx);
      take(__half2float(__ushort_as_half(hi)), bad, mx);
    } else {
      take(__bfloat162float(__ushort_as_bfloat16(lo)), bad, mx);
      take(__bfloat162float(__ushort_as_bfloat16(hi)), bad, mx);
    }
  }
}

__device__ __forceinline__ int find_segment(const long long* prefix, int S, long long c) {
  int lo = 0, hi = S - 1;  // the last s with prefix[s] <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Block sums of `bad` and maxima of `mx`; the result is valid in thread 0.
__device__ __forceinline__ void block_reduce(unsigned& bad, float& mx) {
  __shared__ unsigned s_bad[NT / 32];
  __shared__ float s_mx[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_down_sync(0xFFFFFFFFu, bad, o);
    mx = fmaxf(mx, __shfl_down_sync(0xFFFFFFFFu, mx, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_bad[warp] = bad;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    bad = lane < NT / 32 ? s_bad[lane] : 0u;
    mx = lane < NT / 32 ? s_mx[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      bad += __shfl_down_sync(0xFFFFFFFFu, bad, o);
      mx = fmaxf(mx, __shfl_down_sync(0xFFFFFFFFu, mx, o));
    }
  }
  __syncthreads();  // s_bad / s_mx are reused by the next chunk
}

__global__ void __launch_bounds__(NT) health_reduce_kernel(Table t, long long total_chunks,
                                                           unsigned long long* counts, unsigned* absmax,
                                                           unsigned* ticket, float* word) {
  for (long long c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    const int s = find_segment(t.prefix, t.S, c);
    const long long* seg = t.segs + 4LL * s;
    const char* base = reinterpret_cast<const char*>(static_cast<uintptr_t>(seg[0]));
    const long long n = seg[1];
    const int dtype = static_cast<int>(seg[2] & 0xFF);
    const int entry = static_cast<int>(seg[2] >> 8);
    const long long slot = seg[3];
    const long long start = (c - t.prefix[s]) * CHUNK;
    const long long len = n - start < CHUNK ? n - start : CHUNK;
    const int es = dtype == 0 ? 4 : 2;
    const char* p = base + start * es;
    unsigned bad = 0u;
    float mx = 0.f;
    if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
      const int per = 16 / es;
      const long long nvec = len / per;
      const uint4* v = reinterpret_cast<const uint4*>(p);
      for (long long i = threadIdx.x; i < nvec; i += NT) take_vec(__ldg(v + i), dtype, bad, mx);
      for (long long i = nvec * per + threadIdx.x; i < len; i += NT) take(to_f32(p, i, dtype), bad, mx);
    } else {
      for (long long i = threadIdx.x; i < len; i += NT) take(to_f32(p, i, dtype), bad, mx);
    }
    block_reduce(bad, mx);
    if (threadIdx.x == 0) {
      if (bad) atomicAdd(counts + slot, static_cast<unsigned long long>(bad));
      if (mx > 0.f) atomicMax(absmax + entry, __float_as_uint(mx));
    }
  }
  // The last block to arrive writes the word.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = threadIdx.x; k < t.K; k += NT) {
    const long long b = t.ebegin[k], e = t.ebegin[k + 1], nmb = t.enmb[k];
    float bad = 0.f, first = -1.f;
    if (nmb == 0) {
      for (long long l = b; l < e; ++l) bad += __ull2float_rn(__ldcg(counts + t.leaf[l]));
    } else {
      for (long long mb = 0; mb < nmb; ++mb) {
        float per = 0.f;
        for (long long l = b; l < e; ++l) per += __ull2float_rn(__ldcg(counts + t.leaf[l] + mb));
        bad += per;
        if (first < 0.f && per > 0.f) first = static_cast<float>(mb);
      }
      if (!(bad > 0.f)) first = -1.f;
    }
    word[3 * k + 0] = bad;
    word[3 * k + 1] = __uint_as_float(__ldcg(absmax + k));
    word[3 * k + 2] = first;
  }
}

}  // namespace

extern "C" {

// table: the int64 layout above on the device (S segments, K entries, L
// leaves); scratch: num_slots uint64 counts, then K uint32 abs-max bits,
// then one uint32 ticket (zeroed here, on the stream); word [K, 3] fp32.
// Returns a cudaError_t (0 = launched).
int smp_health_reduce(const long long* table, int S, int K, int L, long long total_chunks, long long num_slots,
                      void* scratch, float* word, void* stream) {
  if (S < 0 || K <= 0 || L < 0 || total_chunks < 0 || num_slots < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)num_slots * 8 + (size_t)K * 4 + 4;
  cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, st);
  if (err != cudaSuccess) return (int)err;
  Table t;
  t.segs = table;
  t.prefix = table + 4LL * S;
  t.leaf = t.prefix + S + 1;
  t.ebegin = t.leaf + L;
  t.enmb = t.ebegin + K + 1;
  t.S = S;
  t.K = K;
  auto* counts = static_cast<unsigned long long*>(scratch);
  auto* absmax = reinterpret_cast<unsigned*>(counts + num_slots);
  unsigned* ticket = absmax + K;
  const long long want = total_chunks > 0 ? total_chunks : 1;
  const int grid = want < MAX_BLOCKS ? static_cast<int>(want) : MAX_BLOCKS;
  health_reduce_kernel<<<grid, NT, 0, st>>>(t, total_chunks, counts, absmax, ticket, word);
  return (int)cudaGetLastError();
}

long long smp_health_reduce_chunk() { return CHUNK; }

const char* smp_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
