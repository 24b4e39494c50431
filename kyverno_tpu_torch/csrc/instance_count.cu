// K3 instance_count: per-instance counts of true rows.
//
// Replaces kyverno_tpu/tpu/evaluator.py:InstScope.count and
// Inst2Scope.count with Ctx.onehot/onehot2: the f32 one-hot einsums
// "nr,nri->ni" and "nr,nri,nrj->nij" over the scope1/scope2 lanes.
//
// Design: one block per resource, threads stride over its R rows and
// add into I (or I x I) int32 counters in shared memory with
// atomicAdd. A row counts when pred and valid are set and its scope
// index lies in [0, I) (both indices for the two-level count): padding
// rows carry -1 and are masked, never used as an index. The counts are
// integers, never a float product (no TF32 rounding). Bound: the bytes
// read (pred, valid, the scope lanes: 6 or 10 bytes a row) and the
// counts written; the atomics stay inside the SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void instance_count_kernel(const uint8_t* __restrict__ pred,
                                      const int32_t* __restrict__ scope1,
                                      const int32_t* __restrict__ scope2,
                                      const uint8_t* __restrict__ valid,
                                      int R, int I, int32_t* __restrict__ out) {
  extern __shared__ int32_t cnt[];
  const int cells = scope2 != nullptr ? I * I : I;
  const long long n = blockIdx.x;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) cnt[c] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const long long o = n * R + r;
    if (!pred[o] || !valid[o]) continue;
    const int a = scope1[o];
    if (a < 0 || a >= I) continue;
    int cell = a;
    if (scope2 != nullptr) {
      const int b = scope2[o];
      if (b < 0 || b >= I) continue;
      cell = a * I + b;
    }
    atomicAdd(&cnt[cell], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) out[n * cells + c] = cnt[c];
}

}  // namespace

extern "C" int instance_count(const void* pred, const void* scope1,
                              const void* scope2, const void* valid,
                              long long N, int R, int I, void* out,
                              void* stream) {
  const int cells = scope2 != nullptr ? I * I : I;
  instance_count_kernel<<<(unsigned)N, 256, cells * sizeof(int32_t),
                          (cudaStream_t)stream>>>(
      (const uint8_t*)pred, (const int32_t*)scope1, (const int32_t*)scope2,
      (const uint8_t*)valid, R, I, (int32_t*)out);
  return (int)cudaGetLastError();
}
