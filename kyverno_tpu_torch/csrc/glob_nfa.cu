// K9 glob_nfa: one glob pattern (* and ?) against padded byte subjects.
//
// Replaces kyverno_tpu/tpu/evaluator.py:glob_match (386), the legacy
// per-pattern NFA that serves a glob the DFA bank could not take (a
// full bank, dfa.py:_room). The reference is a lax.scan over the B
// bytes with m+1 boolean state columns (m = pattern length after
// collapsing runs of '*'), reading the answer at position len:
//   out[s] = dp_len[m]  if 0 <= len[s] <= B,  else false.
// '?' consumes one byte that is not 0; '*' consumes any byte, 0
// included; a literal consumes the byte ord(char) & 0xFF.
//
// Design: one thread per subject; the NFA state is a bitset of m+1
// bits in NW 64-bit registers (bit j = dp[j]). The pattern arrives as
// a (257, NW) table built on the host (kernels.glob_table): row c is
// the positions that consume byte c, row 256 the '*' positions. Per
// byte, with T = table[c] and S = table[256]:
//   new = ((dp << 1) & T) | (dp & S)        (consume c, or loop on '*')
//   new |= (new << 1) & S                   (epsilon over '*')
// One closure pass is exact: runs of '*' are collapsed, so two '*'
// positions are never adjacent and a bit never has to travel twice.
// The table lives in shared memory. A thread reads its subject's bytes
// up to len and stops early when the state set is empty.
//
// Bound: bytes (the bytes of each subject the NFA still needs, the
// lengths and the output); the table is 2 KB a word, read once a block.
// Each thread walks its own row, so a warp's byte loads fall on 32
// rows: the simple first version, to be made fast later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kyverno_tpu_torch/kernels.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 257;  // 256 byte rows + the '*' row
typedef unsigned long long u64;

template <int NW>
__device__ __forceinline__ void closure(u64 (&dp)[NW], const u64* star) {
  u64 carry = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const u64 x = dp[k];
    dp[k] = x | (((x << 1) | carry) & star[k]);
    carry = x >> 63;
  }
}

template <int NW>
__global__ void glob_nfa_kernel(const uint8_t* __restrict__ bytes,
                                const int32_t* __restrict__ lens,
                                long long S, int W,
                                const u64* __restrict__ table, int m,
                                uint8_t* __restrict__ out) {
  extern __shared__ u64 tab[];  // kRows * NW
  for (int i = threadIdx.x; i < kRows * NW; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const u64* star = tab + 256 * NW;
  const int aw = m >> 6;
  const u64 abit = 1ull << (m & 63);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < S;
       s += step) {
    const int len = lens[s];
    bool acc = false;
    if (len >= 0 && len <= W) {
      u64 dp[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) dp[k] = k == 0 ? 1ull : 0ull;
      closure<NW>(dp, star);
      const uint8_t* b = bytes + s * (long long)W;
      for (int w = 0; w < len; ++w) {
        const u64* t = tab + (int)b[w] * NW;
        u64 carry = 0, any = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const u64 x = dp[k];
          dp[k] = (((x << 1) | carry) & t[k]) | (x & star[k]);
          carry = x >> 63;
        }
        closure<NW>(dp, star);
#pragma unroll
        for (int k = 0; k < NW; ++k) any |= dp[k];
        if (any == 0) break;  // no state left: no later byte revives one
      }
      acc = (dp[aw] & abit) != 0;
    }
    out[s] = acc ? 1 : 0;
  }
}

template <int NW>
int launch(const uint8_t* bytes, const int32_t* lens, long long S, int W,
           const u64* table, int m, uint8_t* out, cudaStream_t stream) {
  const int threads = 128;
  const size_t smem = sizeof(u64) * kRows * NW;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        glob_nfa_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (S + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  glob_nfa_kernel<NW><<<(int)blocks, threads, smem, stream>>>(
      bytes, lens, S, W, table, m, out);
  return (int)cudaGetLastError();
}

}  // namespace

// nw: the table's words (1, 2, 4, 8, 16 or 32), at least (m + 64) / 64.
extern "C" int glob_nfa(const void* bytes, const void* lens, long long S,
                        int W, const void* table, int nw, int m, void* out,
                        void* stream) {
  const uint8_t* b = (const uint8_t*)bytes;
  const int32_t* l = (const int32_t*)lens;
  const u64* t = (const u64*)table;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nw) {
    case 1: return launch<1>(b, l, S, W, t, m, o, st);
    case 2: return launch<2>(b, l, S, W, t, m, o, st);
    case 4: return launch<4>(b, l, S, W, t, m, o, st);
    case 8: return launch<8>(b, l, S, W, t, m, o, st);
    case 16: return launch<16>(b, l, S, W, t, m, o, st);
    case 32: return launch<32>(b, l, S, W, t, m, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
