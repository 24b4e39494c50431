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
// Entry 1 (the row lanes) gathers every lane of a tile in one launch.
// The host sorts the lanes into a 1-byte group and a 4-byte group
// (kernels.VocabPlan). A thread owns one vector of consecutive cells: 16
// for a 1-byte lane, 4 for a 4-byte lane, so each lane's part is one
// 16-byte store. It loads the vector's indices once (16-byte loads where
// aligned) and keeps them in registers over its group's lanes, issuing
// the gathers of kIssue elements (several lanes) into registers before
// any of their stores, so that many L2 reads are in flight a thread.
// A group is cut into chunks of kThreads vectors; a grid no larger than
// the card holds resident loops over both groups' chunks (the 1-byte
// group's first). The last vector of a lane, when the cell count is no
// multiple of the vector, and an index view that is not aligned take
// scalar loads and stores in the same kernel.
//
// Entry 2 copies pool rows with 16-byte loads and stores, one thread
// per 16-byte chunk (byte copies when the row width or a pointer is not
// 16-byte aligned); the chunk-0 thread of a cell also writes its
// length.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The SM count is an attribute of a device, so it is kept per device
// ordinal (cudaGetDevice), never once a process.
constexpr int kMaxDevices = 64;

// the current device's ordinal, or -1 when it cannot be read or is past
// kMaxDevices
int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

constexpr int kMaxLanes = 40;
constexpr int kThreads = 256;
constexpr int kIssue = 32;  // gathers a thread issues before its stores

// The lanes in the host's order: the 1-byte group's n1, then the 4-byte
// group's (either group may be empty).
struct LaneTable {
  const void* src[kMaxLanes];
  void* dst[kMaxLanes];
  uint32_t fill[kMaxLanes];
  int n1, n;                   // 1-byte lanes, all lanes
  long long chunks1, chunks;   // the 1-byte group's chunks, both groups'
};

// jnp.take: [-V, 0) wraps; outside [-V, V) -> -1 (fill)
__device__ __forceinline__ long long resolve(long long j, long long V) {
  if (j < 0) j += V;
  return (j >= 0 && j < V) ? j : -1;
}

__device__ __forceinline__ long long load_index(const void* idx, int width,
                                                long long i) {
  if (width == 1) return ((const uint8_t*)idx)[i];
  if (width == 2) return ((const uint16_t*)idx)[i];
  return ((const int32_t*)idx)[i];
}

// The C indices of the vector at cell c0 (IW bytes each), resolved; a
// cell past the end resolves to -1 and is never stored.
template <int C, int IW>
__device__ __forceinline__ void vector_indices(const void* __restrict__ idx,
                                               long long c0, long long cells,
                                               long long V, int (&j)[C]) {
  constexpr int B = C * IW;             // bytes of the vector's indices
  constexpr int A = B < 16 ? B : 16;    // the widest load's alignment
  const uint8_t* p = (const uint8_t*)idx + c0 * IW;
  if (c0 + C <= cells && ((uintptr_t)p % A) == 0) {
    uint32_t w[B / 4];
    if constexpr (B == 4) {
      w[0] = *(const uint32_t*)p;
    } else if constexpr (B == 8) {
      const uint2 v = *(const uint2*)p;
      w[0] = v.x; w[1] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < B / 16; ++k) {
        const uint4 v = ((const uint4*)p)[k];
        w[4 * k] = v.x; w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      long long raw;
      if constexpr (IW == 1) raw = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
      else if constexpr (IW == 2) raw = (w[i / 2] >> (16 * (i % 2))) & 0xFFFFu;
      else raw = (int32_t)w[i];
      j[i] = (int)resolve(raw, V);
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i)
      j[i] = c0 + i < cells ? (int)resolve(load_index(idx, IW, c0 + i), V)
                            : -1;
  }
}

// One thread's vector over the lanes [first, last) of one group: kIssue
// / C lanes' gathers in registers, then their stores.
template <int E, int IW>
__device__ __forceinline__ void group_vector(const LaneTable& t, int first,
                                             int last, long long v,
                                             const void* __restrict__ idx,
                                             long long cells, long long V) {
  using T = typename std::conditional<E == 1, uint8_t, uint32_t>::type;
  constexpr int C = 16 / E;      // cells a vector: one 16-byte store
  constexpr int L = kIssue / C;  // lanes a step
  const long long c0 = v * C;
  if (c0 >= cells) return;
  int j[C];
  vector_indices<C, IW>(idx, c0, cells, V, j);
  const bool full = c0 + C <= cells;
  for (int l0 = first; l0 < last; l0 += L) {
    T val[L][C];
#pragma unroll
    for (int q = 0; q < L; ++q) {
      if (l0 + q < last) {
        const T* __restrict__ src = (const T*)t.src[l0 + q];
        const T fill = (T)t.fill[l0 + q];
#pragma unroll
        for (int i = 0; i < C; ++i)
          val[q][i] = j[i] >= 0 ? __ldg(src + j[i]) : fill;
      }
    }
#pragma unroll
    for (int q = 0; q < L; ++q) {
      if (l0 + q >= last) break;
      T* __restrict__ dst = (T*)t.dst[l0 + q] + c0;
      if (full) {
        uint4 w;
        if constexpr (E == 1) {
          uint32_t p[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            p[k] = (uint32_t)val[q][4 * k] |
                   ((uint32_t)val[q][4 * k + 1] << 8) |
                   ((uint32_t)val[q][4 * k + 2] << 16) |
                   ((uint32_t)val[q][4 * k + 3] << 24);
          w = make_uint4(p[0], p[1], p[2], p[3]);
        } else {
          w = make_uint4(val[q][0], val[q][1], val[q][2], val[q][3]);
        }
        *(uint4*)dst = w;
      } else {
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (c0 + i < cells) dst[i] = val[q][i];
      }
    }
  }
}

// A grid-stride loop over both groups' chunks: at each step the grid
// works on adjacent chunks, mostly of one group.
template <int IW>
__global__ void __launch_bounds__(kThreads)
    lane_gather_kernel(const __grid_constant__ LaneTable t,
                       const void* __restrict__ idx, long long cells,
                       long long V) {
  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    if (c < t.chunks1)  // the same for the whole block
      group_vector<1, IW>(t, 0, t.n1, c * kThreads + threadIdx.x, idx,
                          cells, V);
    else
      group_vector<4, IW>(t, t.n1, t.n,
                          (c - t.chunks1) * kThreads + threadIdx.x, idx,
                          cells, V);
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

using Kernel = void (*)(const LaneTable, const void*, long long, long long);

Kernel kernel_for(int width) {
  return width == 1 ? lane_gather_kernel<1>
         : width == 2 ? lane_gather_kernel<2> : lane_gather_kernel<4>;
}

// The card's SMs x the blocks of this kernel an SM holds.
int resident_blocks(Kernel k) {
  static int sms_of[kMaxDevices] = {};
  const int dev = current_device();
  int sms = dev < 0 ? 0 : sms_of[dev];
  if (dev >= 0 && sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms_of[dev] = sms;
  }
  if (sms < 1) sms = 1;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// Entry 1. srcs / dsts / fills: the lanes in the plan's order, the n1
// 1-byte lanes first; chunks1 / chunks4: each group's chunks of kThreads
// vectors (0 for an empty group).
extern "C" int vocab_gather(const void* srcs, const void* dsts,
                            const void* fills, int nlanes, int n1,
                            long long chunks1, long long chunks4,
                            const void* idx, int width, long long cells,
                            long long V, void* stream) {
  if (nlanes < 1 || nlanes > kMaxLanes || n1 < 0 || n1 > nlanes ||
      (width != 1 && width != 2 && width != 4) ||
      (chunks1 > 0) != (n1 > 0) || (chunks4 > 0) != (n1 < nlanes))
    return (int)cudaErrorInvalidValue;
  LaneTable t;
  for (int l = 0; l < nlanes; ++l) {
    t.src[l] = ((const void* const*)srcs)[l];
    t.dst[l] = ((void* const*)dsts)[l];
    t.fill[l] = ((const uint32_t*)fills)[l];
  }
  t.n1 = n1;
  t.n = nlanes;
  t.chunks1 = chunks1;
  t.chunks = chunks1 + chunks4;
  const Kernel k = kernel_for(width);
  long long blocks = resident_blocks(k);
  if (blocks > t.chunks) blocks = t.chunks;
  k<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(t, idx, cells, V);
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
