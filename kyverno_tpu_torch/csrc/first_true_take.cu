// K8 first_true_take: the first true row of a mask, and a second mask
// read at that row.
//
// Replaces the argmax / take_along_axis pair of
// kyverno_tpu/tpu/evaluator.py:_eval_wildcard_anchor (628):
//   has[n]    = any(accept[n, :])
//   val_ok[n] = pred[n, argmax(accept[n, :])]
// jnp.argmax gives the first maximum, and 0 when no row is true, so
// val_ok is pred[n, 0] then (kept bit for bit). A byte is true when it
// is not 0.
//
// Bound: bytes, from the data: for each resource the accept bytes up
// to its first true row (all R when it has none), one 32-byte sector
// of pred, and 2 bytes out. On the main path (R = 128 or 256, most
// resources with no true row) that is under a microsecond: the kernel's
// cost is its latency, so no load may wait on another load of accept.
//
// Design (kernels.first_true_take_form picks the form):
// - segment form (R % 16 == 0, R <= 512, accept 16-byte aligned): a
//   segment of L lanes owns a resource (L = R / 16 rounded up to a power
//   of two: 8 lanes at R = 128, 16 at R = 256), so a warp serves 32 / L
//   resources. Each lane reads its 16 accept bytes in one 16-byte load
//   and finds its first true byte (__vcmpne4, __ffs); a ballot masked to
//   the segment and __ffs give the segment's first lane with one, and a
//   shuffle brings that lane's byte. Lane 0 of the segment reads the
//   one pred byte at that row (row 0 when none) and writes both
//   outputs;
// - warp walk (any other R or alignment): one warp per resource walks
//   its R rows 32 at a time with __ballot_sync and stops at the first
//   warp-word with a set bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

// the index of the first nonzero byte of 16, or -1
__device__ __forceinline__ int first_byte(const uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned m = __vcmpne4(w[k], 0u);
    if (m != 0u) return 4 * k + ((__ffs((int)m) - 1) >> 3);
  }
  return -1;
}

template <int L>
__global__ void first_true_take_segments(const uint8_t* __restrict__ accept,
                                         const uint8_t* __restrict__ pred,
                                         long long N, int R,
                                         uint8_t* __restrict__ has,
                                         uint8_t* __restrict__ val_ok) {
  constexpr int P = 32 / L;  // resources a warp
  const int lane = threadIdx.x & 31;
  const int seg = lane / L;
  const int sub = lane % L;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  // warp-uniform loop: every lane takes part in the ballot and shuffle
  for (long long w = blockIdx.x * (long long)(blockDim.x / 32) +
                     (threadIdx.x / 32);
       w * P < N; w += warps) {
    const long long n = w * P + seg;
    int f = -1;
    if (n < N && 16 * sub < R)
      f = first_byte(
          __ldg(reinterpret_cast<const uint4*>(accept + n * R) + sub));
    const unsigned ball = __ballot_sync(kFull, f >= 0);
    const unsigned mine =
        L == 32 ? ball : (ball >> (seg * L)) & ((1u << (L & 31)) - 1u);
    const int at = mine != 0u ? __ffs((int)mine) - 1 : 0;
    const int fs = __shfl_sync(kFull, f, seg * L + at);
    if (sub == 0 && n < N) {
      const int row = mine != 0u ? 16 * at + fs : 0;
      has[n] = mine != 0u;
      val_ok[n] = pred[n * R + row] != 0;
    }
  }
}

__global__ void first_true_take_walk(const uint8_t* __restrict__ accept,
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
      const unsigned m = __ballot_sync(kFull, v);
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

template <int L>
void launch_segments(long long N, int R, const uint8_t* accept,
                     const uint8_t* pred, uint8_t* has, uint8_t* val_ok,
                     cudaStream_t stream) {
  const long long per_block = (kThreads / 32) * (32 / L);
  long long blocks = (N + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  first_true_take_segments<L><<<(int)blocks, kThreads, 0, stream>>>(
      accept, pred, N, R, has, val_ok);
}

}  // namespace

// ``lanes``: the segment form's lanes a resource (1, 2, 4, 8, 16 or
// 32), or 0 for the warp walk.
extern "C" int first_true_take(const void* accept, const void* pred,
                               long long N, int R, int lanes, void* has,
                               void* val_ok, void* stream) {
  const uint8_t* a = (const uint8_t*)accept;
  const uint8_t* p = (const uint8_t*)pred;
  uint8_t* h = (uint8_t*)has;
  uint8_t* v = (uint8_t*)val_ok;
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: launch_segments<1>(N, R, a, p, h, v, s); break;
    case 2: launch_segments<2>(N, R, a, p, h, v, s); break;
    case 4: launch_segments<4>(N, R, a, p, h, v, s); break;
    case 8: launch_segments<8>(N, R, a, p, h, v, s); break;
    case 16: launch_segments<16>(N, R, a, p, h, v, s); break;
    case 32: launch_segments<32>(N, R, a, p, h, v, s); break;
    case 0: {
      long long blocks = (N + 7) / 8;  // 8 warps a block, one resource each
      if (blocks > kMaxBlocks) blocks = kMaxBlocks;
      first_true_take_walk<<<(int)blocks, kThreads, 0, s>>>(
          a, p, N, R, h, v);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
