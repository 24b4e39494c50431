// K4 verdict_counts: the per-rule verdict-class histogram.
//
// Replaces the counts of kyverno_tpu/tpu/evaluator.py:build_program.run,
// (table == c).sum(axis=1) for c in 0..6 over the (rules, N) int32
// verdict table.
//
// With a non-null ``out8`` the same pass also writes the table as
// uint8 (the cast of kyverno_tpu/parallel/sharding.py:101-111, the
// background scan's step: the counts are taken on int32, the codes
// 0..6 fit in a byte, and the 4x smaller table is what is read back).
//
// Design: one block per rule; each thread strides over the rule's N
// columns (coalesced) keeping seven private counters in registers,
// then adds them into seven shared counters. Bound: reading the table
// once (4 bytes a cell, plus 1 written with ``out8``); the 28 bytes a
// rule written are noise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClasses = 7;

__global__ void verdict_counts_kernel(const int32_t* __restrict__ table,
                                      long long N, int32_t* __restrict__ out,
                                      uint8_t* __restrict__ out8) {
  __shared__ int32_t acc[kClasses];
  if (threadIdx.x < kClasses) acc[threadIdx.x] = 0;
  __syncthreads();
  int local[kClasses];
#pragma unroll
  for (int c = 0; c < kClasses; ++c) local[c] = 0;
  const int32_t* row = table + (long long)blockIdx.x * N;
  uint8_t* row8 = out8 == nullptr ? nullptr : out8 + (long long)blockIdx.x * N;
  for (long long j = threadIdx.x; j < N; j += blockDim.x) {
    const int v = row[j];
    if (row8 != nullptr) row8[j] = (uint8_t)v;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) local[c] += (v == c);
  }
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    if (local[c]) atomicAdd(&acc[c], local[c]);
  }
  __syncthreads();
  if (threadIdx.x < kClasses)
    out[(long long)blockIdx.x * kClasses + threadIdx.x] = acc[threadIdx.x];
}

}  // namespace

extern "C" int verdict_counts(const void* table, int rules, long long N,
                              void* out, void* out8, void* stream) {
  verdict_counts_kernel<<<rules, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, N, (int32_t*)out, (uint8_t*)out8);
  return (int)cudaGetLastError();
}
