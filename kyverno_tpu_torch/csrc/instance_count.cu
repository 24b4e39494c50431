// K3 instance_count: per-instance counts of true rows.
//
// Replaces kyverno_tpu/tpu/evaluator.py:InstScope.count and
// Inst2Scope.count with Ctx.onehot/onehot2: the f32 one-hot einsums
// "nr,nri->ni" and "nr,nri,nrj->nij" over the scope1/scope2 lanes.
// The counts are integers, never a float product (no TF32 rounding).
//
// One level (instance_count_many). The caller folds valid and the
// [0, I) range into a compact uint8 scope once a batch: scope8 holds
// scope1 where the row is valid and 0 <= scope1 < I, and 0xFF
// elsewhere (I <= 64). A launch takes up to 8 predicates on that
// scope, each through its own row stride (0 for a (1, R) predicate
// broadcast over the batch), and writes per predicate either int32
// counts or the bool "count > 0".
//   - One warp per resource, 8 resources a block. Each lane reads 8
//     rows at a time (one 8-byte load of scope8, one of each
//     predicate); the scope row is loaded once and reused for every
//     predicate.
//   - Counts stay in registers: a 4-bit field per instance, 16 to a
//     64-bit word (so one add a row for I <= 16), moved every 256 rows
//     into 8-bit fields (a lane sees at most R / 32 <= 255 rows), then
//     one warp reduction (__reduce_add_sync) per two instances, their
//     fields widened to 16 bits. "any" ORs a 64-bit instance mask and
//     reduces it with __reduce_or_sync. A warp whose predicate rows are
//     all false skips the work (__any_sync) and writes zeros. No
//     shared memory, no atomics, no block barrier.
// Bound: bytes, P x N x R of predicates + N x R of scope8 + the output.
//
// Two levels (instance_count2): one block per resource, threads stride
// over its R rows and add into I x I int32 counters in shared memory
// with atomicAdd. A row counts when pred and valid are set and both
// scope indices lie in [0, I): padding rows carry -1 and are masked,
// never used as an index. Bound: bytes (10 a row and the counts).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kyverno_tpu_torch/kernels.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kMaxPreds = 8;
constexpr int kWarps = 8;  // resources a block
constexpr unsigned kFull = 0xffffffffu;

struct Preds {
  const uint8_t* pred[kMaxPreds];
  long long stride[kMaxPreds];  // bytes between rows; 0 broadcasts one row
  void* out[kMaxPreds];         // (N, I) int32 counts or bool
};

// 8 consecutive row bytes from r0 (little-endian in a u64); rows at or
// past R read as the bytes of ``pad``.
template <bool VEC>
__device__ __forceinline__ u64 load8(const uint8_t* row, int r0, int R,
                                     u64 pad) {
  if (VEC) return r0 < R ? *reinterpret_cast<const u64*>(row + r0) : pad;
  u64 v = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u64 b = r0 + j < R ? (u64)row[r0 + j] : (pad >> (8 * j)) & 0xFF;
    v |= b << (8 * j);
  }
  return v;
}

constexpr u64 kNibbles = 0x0F0F0F0F0F0F0F0Full;

// Adds one 8-row slice (s8: scope bytes, p8: predicate bytes) into the
// per-instance 4-bit fields ``c4`` (16 instances a word; a lane adds at
// most 8 rows to a field between flushes) or the instance mask ``anyb``.
template <int NA>
__device__ __forceinline__ void add_rows(u64 s8, u64 p8, unsigned I,
                                         bool want_any, u64 (&c4)[NA],
                                         u64& anyb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned s = (unsigned)(s8 >> (8 * j)) & 0xFF;
    const bool live = ((p8 >> (8 * j)) & 0xFF) != 0 && s < I;
    if (want_any) {
      anyb |= (u64)live << (s & 63);
    } else {
      const u64 inc = (u64)live << ((s & 15) * 4);
      if (NA == 1) {
        c4[0] += inc;
      } else {
#pragma unroll
        for (int a = 0; a < NA; ++a)
          c4[a] += (s >> 4) == (unsigned)a ? inc : 0ull;
      }
    }
  }
}

// Moves the 4-bit fields into 8-bit ones: even instances' bytes in e8,
// odd instances' in o8 (a lane's total stays below 256: R <= 8160).
template <int NA>
__device__ __forceinline__ void flush(u64 (&c4)[NA], u64 (&e8)[NA],
                                      u64 (&o8)[NA]) {
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    e8[a] += c4[a] & kNibbles;
    o8[a] += (c4[a] >> 4) & kNibbles;
    c4[a] = 0;
  }
}

// NA: 64-bit words of 4-bit count fields (16 instances each),
// I <= 16 * NA.
template <int NA, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    count_many_kernel(Preds P, int np, unsigned any_mask,
                      const uint8_t* __restrict__ scope8, long long N, int R,
                      int I) {
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  const uint8_t* srow = scope8 + n * R;
  const int r0 = lane * 8;
  // the first 256 rows of the scope and of every predicate, all loads
  // in flight together
  const u64 s_first = load8<VEC>(srow, r0, R, ~0ull);
  u64 p_first[kMaxPreds];
#pragma unroll
  for (int q = 0; q < kMaxPreds; ++q)
    p_first[q] = q < np ? load8<VEC>(P.pred[q] + n * P.stride[q], r0, R, 0ull)
                        : 0ull;
#pragma unroll
  for (int q = 0; q < kMaxPreds; ++q) {
    if (q >= np) break;
    const uint8_t* prow = P.pred[q] + n * P.stride[q];
    const bool want_any = (any_mask >> q) & 1;
    u64 c4[NA], e8[NA], o8[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) c4[a] = e8[a] = o8[a] = 0;
    u64 anyb = 0;
    bool some = __any_sync(kFull, p_first[q] != 0);
    if (some) add_rows<NA>(s_first, p_first[q], I, want_any, c4, anyb);
    for (int r = r0 + 256; r - lane * 8 < R; r += 256) {
      const u64 p8 = load8<VEC>(prow, r, R, 0ull);
      if (!__any_sync(kFull, p8 != 0)) continue;
      some = true;
      if (!want_any) flush<NA>(c4, e8, o8);
      add_rows<NA>(load8<VEC>(srow, r, R, ~0ull), p8, I, want_any, c4, anyb);
    }
    if (want_any) {
      u64 bits = 0;
      if (some)
        bits = (u64)__reduce_or_sync(kFull, (unsigned)anyb) |
               ((u64)__reduce_or_sync(kFull, (unsigned)(anyb >> 32)) << 32);
      uint8_t* o = (uint8_t*)P.out[q] + n * I;
      if (lane < I) o[lane] = (bits >> lane) & 1;
      if (lane + 32 < I) o[lane + 32] = (bits >> (lane + 32)) & 1;
    } else {
      // two instances a reduction: an even and an odd instance's 8-bit
      // fields in the 16-bit halves of one word (a total is at most
      // R <= 8160)
      unsigned mine0 = 0, mine1 = 0;
      if (some) {
        flush<NA>(c4, e8, o8);
#pragma unroll
        for (int j = 0; j < 8 * NA; ++j) {
          if (2 * j >= I) break;
          const int a = j >> 3, b = j & 7;
          const unsigned eh = (unsigned)(b & 4 ? e8[a] >> 32 : e8[a]);
          const unsigned oh = (unsigned)(b & 4 ? o8[a] >> 32 : o8[a]);
          const unsigned tot = __reduce_add_sync(
              kFull, __byte_perm(eh, oh, (b & 3) | ((4 + (b & 3)) << 8)) &
                         0x00FF00FFu);
          const int i = 2 * j;
          const unsigned lo = tot & 0xFFFF, hi = tot >> 16;
          if (lane == (i & 31)) (i < 32 ? mine0 : mine1) = lo;
          if (lane == ((i + 1) & 31)) (i + 1 < 32 ? mine0 : mine1) = hi;
        }
      }
      int32_t* o = (int32_t*)P.out[q] + n * I;
      if (lane < I) o[lane] = (int32_t)mine0;
      if (lane + 32 < I) o[lane + 32] = (int32_t)mine1;
    }
  }
}

template <int NA>
int launch_many(const Preds& P, int np, unsigned any_mask,
                const uint8_t* scope8, long long N, int R, int I, bool vec,
                cudaStream_t stream) {
  const long long blocks = (N + kWarps - 1) / kWarps;
  if (vec)
    count_many_kernel<NA, true><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
        P, np, any_mask, scope8, N, R, I);
  else
    count_many_kernel<NA, false><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
        P, np, any_mask, scope8, N, R, I);
  return (int)cudaGetLastError();
}

__global__ void instance_count2_kernel(const uint8_t* __restrict__ pred,
                                       const int32_t* __restrict__ scope1,
                                       const int32_t* __restrict__ scope2,
                                       const uint8_t* __restrict__ valid,
                                       int R, int I, int32_t* __restrict__ out) {
  extern __shared__ int32_t cnt[];
  const int cells = I * I;
  const long long n = blockIdx.x;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) cnt[c] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const long long o = n * R + r;
    if (!pred[o] || !valid[o]) continue;
    const int a = scope1[o];
    const int b = scope2[o];
    if (a < 0 || a >= I || b < 0 || b >= I) continue;
    atomicAdd(&cnt[a * I + b], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) out[n * cells + c] = cnt[c];
}

}  // namespace

// args: np (1..8) predicate pointers, then their row strides (bytes),
// then their output pointers, read here and passed to the kernel by
// value. any_mask bit q: predicate q writes bool "any".
extern "C" int instance_count_many(const long long* args, int np,
                                   unsigned any_mask, const void* scope8,
                                   long long N, int R, int I, void* stream) {
  if (np < 1 || np > kMaxPreds || I < 1 || I > 64 || R < 1 || R > 32 * 255)
    return (int)cudaErrorInvalidValue;
  Preds P = {};
  bool vec = R % 8 == 0 && ((uintptr_t)scope8 & 7) == 0;
  for (int q = 0; q < np; ++q) {
    P.pred[q] = (const uint8_t*)args[q];
    P.stride[q] = args[np + q];
    P.out[q] = (void*)args[2 * np + q];
    vec = vec && (args[q] & 7) == 0 && P.stride[q] % 8 == 0;
  }
  const uint8_t* s = (const uint8_t*)scope8;
  cudaStream_t st = (cudaStream_t)stream;
  if (I <= 16) return launch_many<1>(P, np, any_mask, s, N, R, I, vec, st);
  if (I <= 32) return launch_many<2>(P, np, any_mask, s, N, R, I, vec, st);
  return launch_many<4>(P, np, any_mask, s, N, R, I, vec, st);
}

extern "C" int instance_count2(const void* pred, const void* scope1,
                               const void* scope2, const void* valid,
                               long long N, int R, int I, void* out,
                               void* stream) {
  instance_count2_kernel<<<(unsigned)N, 256, I * I * sizeof(int32_t),
                           (cudaStream_t)stream>>>(
      (const uint8_t*)pred, (const int32_t*)scope1, (const int32_t*)scope2,
      (const uint8_t*)valid, R, I, (int32_t*)out);
  return (int)cudaGetLastError();
}
