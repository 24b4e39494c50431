// K7 pool_rows: a pool-slot plane read back per row.
//
// Replaces kyverno_tpu/tpu/evaluator.py:Ctx._rows_from_pool (361):
//   out[n, r] = slot[n, r] >= 0 && plane[n, clip(slot[n, r], 0, K - 1)]
// over an (n, K) bool plane (any strides: it is often a column slice
// of the DFA bank's (n, K, patterns) accepts) and the (n, R) int32
// byte_slot / key_byte_slot lane. Padded and out-of-range rows carry
// slot -1 (or INT_MIN) and read false, as in the reference.
//
// Bound: bytes (4 bytes of slot and 1 byte of output a cell, and a
// resource's K plane bytes).
//
// Design: one warp a resource, blocks of kWarps warps, one block per
// kWarps resources (8,192 resources are 1,024 blocks: one wave on 132
// SMs). The warp loads its plane row once, lane k holding
// plane[n, k + 32 w] for each of W words, and folds it with __ballot_sync
// into W 32-bit masks that every lane holds: a cell then reads its bit
// from registers, so no cell makes a dependent plane read. The plane's
// loads and the first slot loads are issued before the ballot, and so
// are in flight together. Each lane loads 4 slots with one 16-byte load
// (a warp covers 128 rows a step, two steps in flight) and stores their
// 4 bools as one 4-byte word. A row count that is no multiple of 4 or
// a slot lane that is not 16-byte aligned takes one slot a lane a step;
// a plane with K above 32 * kMaxWords is read in global memory, a cell
// at a time. All three forms are in this one kernel (W = 0: global).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxWords = 8;  // K <= 256 held in registers

template <int W>
__device__ __forceinline__ uint32_t cell(const uint32_t (&bits)[W > 0 ? W : 1],
                                         const uint8_t* __restrict__ p_row,
                                         long long ps1, int K, int s) {
  const int c = s < 0 ? 0 : (s > K - 1 ? K - 1 : s);
  uint32_t v;
  if constexpr (W == 0) {
    v = p_row[(long long)c * ps1] != 0;
  } else {
    uint32_t w = bits[0];
#pragma unroll
    for (int k = 1; k < W; ++k)
      if ((c >> 5) == k) w = bits[k];
    v = (w >> (c & 31)) & 1u;
  }
  return s >= 0 ? v : 0u;
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    pool_rows_kernel(const uint8_t* __restrict__ plane, long long ps0,
                     long long ps1, int K, const int32_t* __restrict__ slot,
                     long long N, int R, int vec, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp
  const uint8_t* __restrict__ p_row = plane + n * ps0;
  const int32_t* __restrict__ s_row = slot + n * (long long)R;
  uint8_t* __restrict__ o_row = out + n * (long long)R;
  uint8_t pv[W > 0 ? W : 1];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int c = 32 * k + lane;
    pv[k] = c < K ? p_row[(long long)c * ps1] : 0;
  }
  if (vec) {
    const int4* __restrict__ s4 = (const int4*)s_row;
    uint32_t* __restrict__ o4 = (uint32_t*)o_row;
    const int Q = R >> 2;
    int4 a = make_int4(-1, -1, -1, -1), b = a;
    if (lane < Q) a = s4[lane];
    if (lane + 32 < Q) b = s4[lane + 32];
    uint32_t bits[W > 0 ? W : 1];
#pragma unroll
    for (int k = 0; k < W; ++k) bits[k] = __ballot_sync(0xFFFFFFFFu, pv[k]);
    for (int q = lane; q < Q; q += 64) {
      if (q > lane) {
        a = s4[q];
        if (q + 32 < Q) b = s4[q + 32];
      }
      o4[q] = cell<W>(bits, p_row, ps1, K, a.x) |
              cell<W>(bits, p_row, ps1, K, a.y) << 8 |
              cell<W>(bits, p_row, ps1, K, a.z) << 16 |
              cell<W>(bits, p_row, ps1, K, a.w) << 24;
      if (q + 32 < Q)
        o4[q + 32] = cell<W>(bits, p_row, ps1, K, b.x) |
                     cell<W>(bits, p_row, ps1, K, b.y) << 8 |
                     cell<W>(bits, p_row, ps1, K, b.z) << 16 |
                     cell<W>(bits, p_row, ps1, K, b.w) << 24;
    }
  } else {
    int a = lane < R ? s_row[lane] : -1;
    uint32_t bits[W > 0 ? W : 1];
#pragma unroll
    for (int k = 0; k < W; ++k) bits[k] = __ballot_sync(0xFFFFFFFFu, pv[k]);
    for (int r = lane; r < R; r += 32) {
      if (r > lane) a = s_row[r];
      o_row[r] = (uint8_t)cell<W>(bits, p_row, ps1, K, a);
    }
  }
}

template <int W>
void launch(const void* plane, long long ps0, long long ps1, int K,
            const void* slot, long long N, int R, int vec, void* out,
            cudaStream_t st) {
  const long long blocks = (N + kWarps - 1) / kWarps;
  pool_rows_kernel<W><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      (const uint8_t*)plane, ps0, ps1, K, (const int32_t*)slot, N, R, vec,
      (uint8_t*)out);
}

}  // namespace

// words: the 32-bit masks of a plane row held in registers (1, 2, 4 or
// 8, covering K), or 0 to read the plane in global memory; vec: 1 when
// R is a multiple of 4 and the slot lane 16-byte aligned (the 16-byte
// slot loads and 4-byte stores). The host decides both
// (kernels.pool_rows_words, kernels.pool_rows_form).
extern "C" int pool_rows(const void* plane, long long ps0, long long ps1,
                         int K, const void* slot, long long N, int R,
                         int words, int vec, void* out, void* stream) {
  if (K < 1 || N < 1 || R < 1 || words < 0 || words > kMaxWords ||
      (words & (words - 1)) != 0 || (words > 0 && K > 32 * words) ||
      (vec && (R % 4 != 0 || (uintptr_t)slot % 16 != 0 ||
               (uintptr_t)out % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (words) {
    case 1: launch<1>(plane, ps0, ps1, K, slot, N, R, vec, out, st); break;
    case 2: launch<2>(plane, ps0, ps1, K, slot, N, R, vec, out, st); break;
    case 4: launch<4>(plane, ps0, ps1, K, slot, N, R, vec, out, st); break;
    case 8: launch<8>(plane, ps0, ps1, K, slot, N, R, vec, out, st); break;
    default: launch<0>(plane, ps0, ps1, K, slot, N, R, vec, out, st);
  }
  return (int)cudaGetLastError();
}
