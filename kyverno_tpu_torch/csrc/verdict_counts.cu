// K4 verdict_counts: the per-rule verdict-class histogram.
//
// Replaces the counts of kyverno_tpu/tpu/evaluator.py:build_program.run,
// (table == c).sum(axis=1) for c in 0..6 over the (rules, N) int32
// verdict table. A value outside 0..6 is counted in no class.
//
// With a non-null ``out8`` the same pass also writes the table as
// uint8 (the cast of kyverno_tpu/parallel/sharding.py:101-111, the
// background scan's step: the counts are taken on int32, the codes
// 0..6 fit in a byte, and the 4x smaller table is what is read back).
//
// Bound: reading the table once (4 bytes a cell, plus 1 written with
// ``out8``); the 28 bytes a rule written are noise. At the main path's
// shapes (66 rules of 8,192 or 16,384 cells) that is 2-4 MB: a few
// hundred nanoseconds, so what is left is the launch, one round of
// loads and the reduction, and no thread may wait on a chain of loads.
//
// Design (kernels.verdict_counts_plan picks C, the block size and the
// form):
// - a rule's row is split over a thread-block cluster of C <= 8 blocks
//   (grid = rules x C, cluster dims (C, 1, 1)), C and the block size
//   chosen so that a thread's kLoads loads cover its share of the row:
//   C = 8 blocks of 128 threads at N = 16,384. A row that one block of
//   512 threads covers so (N <= 8,192) is one block's: on an H100 one
//   block of 512 threads a rule runs faster there than any cluster of
//   the same threads (profile_ab.py's K4 plan sweep), the cluster's
//   barrier and remote stores costing more than the SMs it adds;
// - vector form (N % 4 == 0, the table 16-byte aligned, ``out8`` 4-byte
//   aligned): a thread reads 4 cells in one 16-byte load and, with
//   ``out8``, writes them as one 4-byte store; the cluster's threads
//   interleave (coalesced), four loads issued before any is counted;
// - scalar form (anything else): the same walk a cell at a time;
// - the seven counts are reduced in the warp (__reduce_add_sync), then
//   in the block by warp 0 through shared memory, then across the
//   cluster: each block stores its partials into block rank 0's shared
//   memory (distributed shared memory), and rank 0 adds them and writes
//   the rule's counts. No global atomic, no zero-fill;
// - one cluster barrier, split: its first phase is arrived at the
//   kernel's start (relaxed) and waited for only before the first
//   remote store, so the wait for every block to start hides behind
//   the loads; in the second a peer arrives (release) after its store
//   and leaves, and only rank 0 waits; C = 1 takes no barrier at all.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClasses = 7;
constexpr int kMaxWarps = 32;
constexpr int kMaxCluster = 8;
constexpr int kLoads = 4;  // 16-byte loads in flight a thread

__device__ __forceinline__ void tally(int v, int (&local)[kClasses]) {
#pragma unroll
  for (int c = 0; c < kClasses; ++c) local[c] += (v == c);
}

__device__ __forceinline__ void tally4(const int4 v, int (&local)[kClasses]) {
  tally(v.x, local);
  tally(v.y, local);
  tally(v.z, local);
  tally(v.w, local);
}

__device__ __forceinline__ uchar4 narrow(const int4 v) {
  return make_uchar4((unsigned char)v.x, (unsigned char)v.y,
                     (unsigned char)v.z, (unsigned char)v.w);
}

// barrier.cluster in two halves (PTX): an arrive that orders nothing
// (the kernel's start), an arrive that releases this thread's stores,
// and a wait that acquires every arrived thread's
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

template <bool kVector>
__global__ void verdict_counts_kernel(const int32_t* __restrict__ table,
                                      long long N, int32_t* __restrict__ out,
                                      uint8_t* __restrict__ out8) {
  __shared__ int32_t warp_part[kMaxWarps][kClasses];
  // rank 0's: each block's partials, pushed into it by the block
  __shared__ int32_t cluster_part[kMaxCluster][kClasses];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // every block has started once this phase completes, so a peer may
  // then write into rank 0's shared memory; the loads below hide it
  if (C > 1) cluster_arrive_relaxed();
  const long long rule = blockIdx.x / C;
  const long long stride = (long long)C * blockDim.x;
  const long long first = (long long)rank * blockDim.x + threadIdx.x;
  int local[kClasses];
#pragma unroll
  for (int c = 0; c < kClasses; ++c) local[c] = 0;
  const int32_t* row = table + rule * N;
  uint8_t* row8 = out8 == nullptr ? nullptr : out8 + rule * N;
  if (kVector) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    uchar4* row84 = reinterpret_cast<uchar4*>(row8);
    const long long V = N >> 2;
    // kLoads loads issued before any is counted; a vector past the row
    // reads as -1, which no class counts
    for (long long i = first; i < V; i += kLoads * stride) {
      int4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const long long j = i + k * stride;
        v[k] = j < V ? __ldg(row4 + j) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const long long j = i + k * stride;
        if (row84 != nullptr && j < V) row84[j] = narrow(v[k]);
        tally4(v[k], local);
      }
    }
  } else {
    for (long long j = first; j < N; j += stride) {
      const int v = __ldg(row + j);
      if (row8 != nullptr) row8[j] = (uint8_t)v;
      tally(v, local);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    const int s = __reduce_add_sync(0xFFFFFFFFu, local[c]);
    if (lane == 0) warp_part[warp][c] = s;
  }
  __syncthreads();
  // warp 0 adds the warps' partials, lane c ends with class c's
  int s = 0;
  if (warp == 0) {
    const int warps = (int)(blockDim.x >> 5);
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      const int t = __reduce_add_sync(
          0xFFFFFFFFu, lane < warps ? warp_part[lane][c] : 0);
      if (lane == c) s = t;
    }
  }
  if (C == 1) {
    if (threadIdx.x < kClasses) out[rule * kClasses + threadIdx.x] = s;
    return;
  }
  cluster_wait();  // every block has started
  if (threadIdx.x < kClasses)
    *cluster.map_shared_rank(&cluster_part[rank][threadIdx.x], 0) = s;
  // a peer leaves after its arrive; rank 0 waits for every block's
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait();
  if (threadIdx.x < kClasses) {
    int total = 0;
    for (int r = 0; r < C; ++r) total += cluster_part[r][threadIdx.x];
    out[rule * kClasses + threadIdx.x] = total;
  }
}

}  // namespace

// A cluster launch (cudaLaunchKernelEx): C blocks a rule, ``threads``
// a block (a multiple of 32, at most 1,024), the vector form when
// ``vector`` is nonzero. Returns the launch's error, else
// cudaGetLastError().
extern "C" int verdict_counts(const void* table, int rules, long long N,
                              void* out, void* out8, int C, int threads,
                              int vector, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rules * (unsigned)C, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // C = 1: a plain launch, no cluster
  const int32_t* t = (const int32_t*)table;
  cudaError_t e =
      vector ? cudaLaunchKernelEx(&cfg, verdict_counts_kernel<true>, t, N,
                                  (int32_t*)out, (uint8_t*)out8)
             : cudaLaunchKernelEx(&cfg, verdict_counts_kernel<false>, t, N,
                                  (int32_t*)out, (uint8_t*)out8);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error
    return (int)e;
  }
  return (int)cudaGetLastError();
}
