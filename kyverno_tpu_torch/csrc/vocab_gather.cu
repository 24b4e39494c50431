// K5 vocab_gather: the vocabulary gathers of the background scan.
//
// Replaces kyverno_tpu/tpu/evaluator.py:LaneView.__getitem__ (144):
//   dense lane  = jnp.take(vocab_<lane>, row_idx)       (V,) by (n, Rb)
//   pool        = jnp.take(pool_svocab, pool_sidx)      (Sv, W) by (n, K)
//   pool_len    = jnp.take(pool_slen, pool_sidx)        (Sv,) by (n, K)
// with jnp.take's index rule: an index in [-V, 0) wraps, one outside
// [-V, V) gives the fill value (255 for uint8, 0xFFFFFFFF for uint32,
// INT_MIN for int32, NaN for float32; the caller passes the bit
// pattern per lane).
//
// Bound: bytes. The vocabularies are small (a few MB at most, they
// stay in L2), so the cost is reading the index table once and
// writing every dense cell once.
//
// Design: entry 1 gathers many lanes in one launch: one thread per
// (resource, row) cell reads its index once and loops over a lane
// table passed by value (source, destination, element size, fill), so
// every lane's writes are coalesced. Entry 2 copies pool rows with
// 16-byte loads and stores, one thread per 16-byte chunk (byte copies
// when the row width or a pointer is not 16-byte aligned); the chunk-0
// thread of a cell also writes its length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 40;

struct LaneTable {
  const void* src[kMaxLanes];
  void* dst[kMaxLanes];
  uint32_t fill[kMaxLanes];
  int elem[kMaxLanes];  // element size in bytes: 1 or 4
  int n;
};

__device__ __forceinline__ long long load_index(const void* idx, int width,
                                                long long i) {
  if (width == 1) return ((const uint8_t*)idx)[i];
  if (width == 2) return ((const uint16_t*)idx)[i];
  return ((const int32_t*)idx)[i];
}

// jnp.take: [-V, 0) wraps; outside [-V, V) -> -1 (fill)
__device__ __forceinline__ long long resolve(long long j, long long V) {
  if (j < 0) j += V;
  return (j >= 0 && j < V) ? j : -1;
}

__global__ void lane_gather_kernel(LaneTable t, const void* __restrict__ idx,
                                   int width, long long cells, long long V) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += step) {
    const long long j = resolve(load_index(idx, width, i), V);
    for (int l = 0; l < t.n; ++l) {
      if (t.elem[l] == 1) {
        ((uint8_t*)t.dst[l])[i] =
            j >= 0 ? ((const uint8_t*)t.src[l])[j] : (uint8_t)t.fill[l];
      } else {
        ((uint32_t*)t.dst[l])[i] =
            j >= 0 ? ((const uint32_t*)t.src[l])[j] : t.fill[l];
      }
    }
  }
}

// one thread per chunk of a pool row; chunk = 16 bytes (vec) or 1 byte
__global__ void row_gather_kernel(const uint8_t* __restrict__ svocab,
                                  const int32_t* __restrict__ slen,
                                  const void* __restrict__ idx, int width,
                                  long long cells, long long V, int W,
                                  int chunks, int vec, uint8_t* __restrict__ out,
                                  int32_t* __restrict__ out_len) {
  const long long total = cells * chunks;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long cell = t / chunks;
    const int part = (int)(t - cell * chunks);
    const long long j = resolve(load_index(idx, width, cell), V);
    if (out != nullptr) {
      if (vec) {
        const uint4 fill = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                      0xFFFFFFFFu);
        ((uint4*)out)[t] =
            j >= 0 ? ((const uint4*)(svocab + j * W))[part] : fill;
      } else {
        out[t] = j >= 0 ? svocab[j * W + part] : (uint8_t)0xFF;
      }
    }
    if (out_len != nullptr && part == 0)
      out_len[cell] = j >= 0 ? slen[j] : (int32_t)0x80000000;
  }
}

int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 132 * 32) b = 132 * 32;  // grid-stride beyond 32 blocks an SM
  return (int)b;
}

}  // namespace

extern "C" int vocab_gather(const void* srcs, const void* dsts,
                            const void* elems, const void* fills, int nlanes,
                            const void* idx, int width, long long cells,
                            long long V, void* stream) {
  if (nlanes < 1 || nlanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  LaneTable t;
  for (int l = 0; l < nlanes; ++l) {
    t.src[l] = ((const void* const*)srcs)[l];
    t.dst[l] = ((void* const*)dsts)[l];
    t.elem[l] = ((const int*)elems)[l];
    t.fill[l] = ((const uint32_t*)fills)[l];
  }
  t.n = nlanes;
  const int threads = 256;
  lane_gather_kernel<<<blocks_for(cells, threads), threads, 0,
                       (cudaStream_t)stream>>>(t, idx, width, cells, V);
  return (int)cudaGetLastError();
}

extern "C" int vocab_gather_rows(const void* svocab, const void* slen,
                                 const void* idx, int width, long long cells,
                                 long long V, int W, void* out, void* out_len,
                                 void* stream) {
  const int vec = (W % 16 == 0) && ((uintptr_t)svocab % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const int chunks = out == nullptr ? 1 : (vec ? W / 16 : W);
  const int threads = 256;
  row_gather_kernel<<<blocks_for(cells * chunks, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)svocab, (const int32_t*)slen, idx, width, cells, V, W,
      chunks, vec, (uint8_t*)out, (int32_t*)out_len);
  return (int)cudaGetLastError();
}
