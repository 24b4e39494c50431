// K7 pool_rows: a pool-slot plane read back per row.
//
// Replaces kyverno_tpu/tpu/evaluator.py:Ctx._rows_from_pool (361):
//   out[n, r] = slot[n, r] >= 0 && plane[n, clip(slot[n, r], 0, K - 1)]
// over an (n, K) bool plane (any strides: it is often a column slice
// of the DFA bank's (n, K, patterns) accepts) and the (n, R) int32
// byte_slot / key_byte_slot lane. Padded and out-of-range rows carry
// slot -1 (or INT_MIN) and read false, as in the reference.
//
// Bound: bytes (4 bytes of slot and 1 byte of output a cell; the plane
// is n * K bytes and stays in L2). Design: a block of 32 x 8 threads
// takes 8 rows at a time (grid-stride over rows), and each warp walks
// one row 32 cells at a time, so loads are coalesced over the slot lane
// and no thread divides a flat cell index by R.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void pool_rows_kernel(const uint8_t* __restrict__ plane,
                                 long long ps0, long long ps1, int K,
                                 const int32_t* __restrict__ slot,
                                 long long N, int R,
                                 uint8_t* __restrict__ out) {
  const long long step = (long long)gridDim.x * kRowsPerBlock;
  for (long long n = (long long)blockIdx.x * kRowsPerBlock + threadIdx.y;
       n < N; n += step) {
    const int32_t* s_row = slot + n * R;
    const uint8_t* p_row = plane + n * ps0;
    uint8_t* o_row = out + n * R;
    for (int r = threadIdx.x; r < R; r += 32) {
      const int s = s_row[r];
      const int c = s < 0 ? 0 : (s > K - 1 ? K - 1 : s);
      o_row[r] = (s >= 0) && p_row[(long long)c * ps1] != 0;
    }
  }
}

}  // namespace

extern "C" int pool_rows(const void* plane, long long ps0, long long ps1,
                         int K, const void* slot, long long N, int R,
                         void* out, void* stream) {
  long long blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  pool_rows_kernel<<<(int)blocks, dim3(32, kRowsPerBlock), 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)plane, ps0, ps1, K, (const int32_t*)slot, N, R,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
