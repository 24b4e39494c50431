// K1 dfa_scan: the DFA bank scan over padded byte lanes.
//
// Replaces kyverno_tpu/tpu/dfa.py:_scan_fused (stride 2/4, the fused
// premultiplied pad-extended table), dfa.py:_scan_stride1 (one byte per
// step) and dfa.py:nonascii_mask, with the accept lookup of
// dfa.py:bank_match folded into the epilogue.
//
// Design: one thread per (subject, pattern) pair, pattern fastest, so
// the K threads of one subject read the same bytes. The 1024-entry
// pair map lives in shared memory; the transition table (at most
// MAX_BANK_STRIDE_ENTRIES = 8M int32 = 32 MiB) is read from global
// memory and stays resident in the 50 MB L2. The state walks in a
// register. Each step is a data-dependent gather, so the scan is
// bounded by gather latency, not by the bytes it reads: only the live
// bytes of each subject (up to min(len, W)) are read, the tables are
// small.
//
// The column index is the reference's: byte + 256 * (pos >= min(len, W)),
// window padding counts as byte 0 with the pad flag. A pair whose two
// positions are both pad is the identity column ((pad, pad) freezes the
// state, dfa.py finalize), so the loop stops after ceil(min(len, W) / 2)
// pairs; the skipped steps could not change the state.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kyverno_tpu_torch/kernels.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool any_nonascii(const uint8_t* b, int lim) {
  for (int w = 0; w < lim; ++w) {
    if (b[w] >= 0x80) return true;
  }
  return false;
}

__global__ void dfa_scan_fused_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long n_subj, int W, const int32_t* __restrict__ trans,
    const int32_t* __restrict__ pairs_g, const int32_t* __restrict__ starts,
    const uint8_t* __restrict__ accept, int K, int pitch,
    uint8_t* __restrict__ out, uint8_t* __restrict__ nonascii) {
  __shared__ int32_t pairs[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) pairs[i] = pairs_g[i];
  __syncthreads();
  const int Kt = K > 0 ? K : 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_subj * Kt) return;
  const long long s = t / Kt;
  const int k = (int)(t % Kt);
  const uint8_t* b = bytes + s * (long long)W;
  const int len = lens[s];
  const int lc = len < W ? len : W;
  if (nonascii != nullptr && k == 0) nonascii[s] = any_nonascii(b, lc) ? 1 : 0;
  if (K == 0) return;
  int state = starts[k];
  const int live_pairs = lc > 0 ? (lc + 1) / 2 : 0;
  for (int p = 0; p < live_pairs; ++p) {
    const int p0 = 2 * p;
    const int p1 = p0 + 1;
    const int b0 = (p0 < W ? (int)b[p0] : 0) + (p0 >= lc ? 256 : 0);
    const int b1 = (p1 < W ? (int)b[p1] : 0) + (p1 >= lc ? 256 : 0);
    state = trans[state + pairs[b0] + pairs[512 + b1]];
  }
  out[s * K + k] = accept[state / pitch];
}

__global__ void dfa_scan_stride1_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long n_subj, int W, const int32_t* __restrict__ trans, int C,
    const uint8_t* __restrict__ class_map, const int32_t* __restrict__ starts,
    const uint8_t* __restrict__ accept, int K, uint8_t* __restrict__ out,
    uint8_t* __restrict__ nonascii) {
  const int Kt = K > 0 ? K : 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_subj * Kt) return;
  const long long s = t / Kt;
  const int k = (int)(t % Kt);
  const uint8_t* b = bytes + s * (long long)W;
  const int len = lens[s];
  const int lim = len < W ? len : W;
  if (nonascii != nullptr && k == 0) nonascii[s] = any_nonascii(b, lim) ? 1 : 0;
  if (K == 0) return;
  const uint8_t* cm = class_map + (long long)k * 256;
  int state = starts[k];
  for (int w = 0; w < lim; ++w) state = trans[state * C + cm[b[w]]];
  out[s * K + k] = accept[state];
}

constexpr int kThreads = 256;

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int dfa_scan_fused(const void* bytes, const void* lens,
                              long long n_subj, int W, const void* trans,
                              const void* pairs, const void* starts,
                              const void* accept, int K, int pitch,
                              void* out, void* nonascii, void* stream) {
  const long long n = n_subj * (K > 0 ? K : 1);
  dfa_scan_fused_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int32_t*)lens, n_subj, W,
      (const int32_t*)trans, (const int32_t*)pairs, (const int32_t*)starts,
      (const uint8_t*)accept, K, pitch, (uint8_t*)out, (uint8_t*)nonascii);
  return (int)cudaGetLastError();
}

extern "C" int dfa_scan_stride1(const void* bytes, const void* lens,
                                long long n_subj, int W, const void* trans,
                                int C, const void* class_map,
                                const void* starts, const void* accept, int K,
                                void* out, void* nonascii, void* stream) {
  const long long n = n_subj * (K > 0 ? K : 1);
  dfa_scan_stride1_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int32_t*)lens, n_subj, W,
      (const int32_t*)trans, C, (const uint8_t*)class_map,
      (const int32_t*)starts, (const uint8_t*)accept, K, (uint8_t*)out,
      (uint8_t*)nonascii);
  return (int)cudaGetLastError();
}
