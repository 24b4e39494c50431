// K8 first_true_take: the first true row of a mask, and a second mask
// read at that row.
//
// Replaces the argmax / take_along_axis pair of
// kyverno_tpu/tpu/evaluator.py:_eval_wildcard_anchor (628):
//   has[n]    = any(accept[n, :])
//   val_ok[n] = pred[n, argmax(accept[n, :])]
// jnp.argmax gives the first maximum, and 0 when no row is true, so
// val_ok is pred[n, 0] then (kept bit for bit).
//
// Bound: bytes, from the data: for each resource the accept bytes up
// to its first true row (all R when it has none), one 32-byte sector
// of pred, and 2 bytes out; the rest of both masks is never read.
// Design: one warp per resource walks its R rows 32 at a time with
// __ballot_sync and stops at the first warp-word with a set bit;
// __ffs gives the first row. Lane 0 writes both outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void first_true_take_kernel(const uint8_t* __restrict__ accept,
                                       const uint8_t* __restrict__ pred,
                                       long long N, int R,
                                       uint8_t* __restrict__ has,
                                       uint8_t* __restrict__ val_ok) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long n = blockIdx.x * (long long)(blockDim.x / 32) +
                     (threadIdx.x / 32);
       n < N; n += warps) {
    const uint8_t* a = accept + n * R;
    int first = -1;
    for (int base = 0; base < R; base += 32) {
      const int r = base + lane;
      const bool v = r < R && a[r] != 0;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, v);
      if (m != 0u) {  // the same for every lane of the warp
        first = base + __ffs((int)m) - 1;
        break;
      }
    }
    if (lane == 0) {
      has[n] = first >= 0;
      val_ok[n] = pred[n * R + (first >= 0 ? first : 0)] != 0;
    }
  }
}

}  // namespace

extern "C" int first_true_take(const void* accept, const void* pred,
                               long long N, int R, void* has, void* val_ok,
                               void* stream) {
  const int threads = 256;  // 8 warps, one resource each
  long long blocks = (N + 7) / 8;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  first_true_take_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)accept, (const uint8_t*)pred, N, R, (uint8_t*)has,
      (uint8_t*)val_ok);
  return (int)cudaGetLastError();
}
