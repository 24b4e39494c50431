// K6 hash_match: 64-bit hash equality row masks.
//
// Replaces kyverno_tpu/tpu/evaluator.py:Ctx._mask / heq / hset
// (222-244): over the (n, R) hash lanes <lane>_hi / <lane>_lo,
//   out[i] = OR_k (hi[i] == H_k && lo[i] == L_k)   [&& valid[i]]
// for one constant (heq), a set of any size (hset; the empty set gives
// all false) or one constant AND the row-valid lane (_mask). The lanes
// are the uint32 hashes seen as int32 bit patterns, and the constants
// are folded to the same patterns, so only equality is ever tested.
//
// Bound: bytes (8 bytes of hash lanes, 1 of valid, 1 of output a
// cell). Design: one thread per cell, grid-stride, coalesced loads.
// The k (hi, lo) pairs are a small device buffer that the caller keeps
// with its compiled program; every thread reads the same address, so
// the loads broadcast from L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hash_match_kernel(const int32_t* __restrict__ hi,
                                  const int32_t* __restrict__ lo,
                                  const uint8_t* __restrict__ valid,
                                  long long cells,
                                  const int32_t* __restrict__ consts, int k,
                                  uint8_t* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += step) {
    const int32_t h = hi[i];
    const int32_t l = lo[i];
    bool hit = false;
    for (int q = 0; q < k; ++q)
      hit |= (h == consts[2 * q]) & (l == consts[2 * q + 1]);
    if (valid != nullptr) hit &= valid[i] != 0;
    out[i] = hit;
  }
}

}  // namespace

// consts: k (hi, lo) int32 pairs in device memory (k may be 0)
extern "C" int hash_match(const void* hi, const void* lo, const void* valid,
                          long long cells, const void* consts, int k,
                          void* out, void* stream) {
  const int threads = 256;
  long long blocks = (cells + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  hash_match_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (const uint8_t*)valid, cells,
      (const int32_t*)consts, k, (uint8_t*)out);
  return (int)cudaGetLastError();
}
