// K1 dfa_scan: the DFA bank scan over padded byte lanes.
//
// Replaces kyverno_tpu/tpu/dfa.py:_scan_stride1 (one byte per step),
// dfa.py:_scan_fused (stride 2/4, the fused premultiplied pad-extended
// table) and dfa.py:nonascii_mask, with the accept lookup and the
// column order of dfa.py:bank_match folded into the epilogue.
//
// What bounds it: every step is one data-dependent table gather, so the
// scan is bound by the latency and throughput of the memory that serves
// that gather, not by the bytes it reads. A bank holds thousands of
// patterns (a tenant set: 3,000 patterns, 60,000 states); read from
// global memory, a warp's 32 lanes would gather from 32 patterns' tables
// and cost one L2 sector each a step.
//
// Design: the patterns of one stride group are packed on the host
// (kernels.py:pack_stride1 / pack_fused) into tiles that fit shared
// memory, with pattern-local state ids. The grid is (subject chunk,
// tile). A block copies its tile into shared memory once, then walks
// every (subject, pattern) pair of its chunk with each table read on
// chip. Pairs are numbered pattern fastest, so the lanes of a warp
// share a subject: its length keeps them in step and its bytes are one
// broadcast read, a word at a time through L1 (the wrapper hands over
// rows of ld bytes, a multiple of 4 and at least W, from a 4-byte
// aligned base), and a fused lane folds each byte pair into its column
// (pairs[b0] + pairs[512 + b1], the map in shared memory) as it steps.
// Staging each group of subjects'
// bytes, or their pair-column streams, in shared memory first measured
// slower on an H100: every group cost a round of dependent global
// loads and three barriers (PERF.md, Findings).
//
// A tile (16-byte aligned, a multiple of 16 bytes) begins with four
// int32 fields per pattern, field-major (f[i * P + k]), so the lanes'
// reads of one field are consecutive words:
//   stride 1: f0 rows offset, f1 accept offset, f2 n_classes | start
//             << 16, f3 output column; then the class maps at a
//             260-byte pitch (65 words: 32 patterns' maps fall in 32
//             banks); then each pattern's (states x classes) rows of
//             local ids (uint8, or uint16 past 256 states) and its
//             accept bytes.
//   fused:    f0 table offset, f1 accept offset, f2 local premultiplied
//             start, f3 output column; then each pattern's (states x
//             pitch) table of local premultiplied ids (uint16, or int32
//             past 65,536 entries) and its accept bytes.
// The directory holds (blob offset, bytes, patterns, flags) a tile;
// flag 1 marks the wide entry type and flag 2 a tile too large for
// shared memory, read in place from global memory by the same code.
// The layout's constants are kernels.py's _CM_PITCH, _TILE_WIDE and
// _TILE_GLOBAL; its tile budgets fit kMaxSmem.
//
// The arithmetic is the reference's. Stride 1: state = rows[state * C +
// cm[byte]] for each byte below min(len, W). Fused: the column of pair p
// is pairs[b0] + pairs[512 + b1] with the pad flag (bit 8) set on bytes
// at or past min(len, W); a (pad, pad) pair is the identity (dfa.py
// finalize), so the walk stops after the ceil(min(len, W) / 2) live
// pairs (a word read may add one identity pair) and stride 4's chain
// (which only pads the window) needs no code; the accept is
// accept[state / pitch]. A subject of length 0 takes no step.
//
// The non-ASCII flag (B4, dfa.py:nonascii_mask) costs no load of its
// own: in the directory's first tile, the lane that walks pattern 0 of a
// subject ORs the words it reads (the fused walk masking the bytes of
// its last word at or past min(len, W)) and writes the flag. The walks
// with the flag are instantiations of their own (kFlag), chosen once a
// block, so a launch or a tile without it runs the walk unchanged. A
// family no K1 launch scans takes dfa_nonascii_kernel below.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kyverno_tpu_torch/kernels.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kCmPitch = 260;
constexpr int kWide = 1;
constexpr int kGlobal = 2;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ int clamp_len(int len, int W) {
  return len < 0 ? 0 : (len < W ? len : W);
}

// the high bits of a word's first v bytes (v >= 4: all four), little
// endian: byte i of a word is bits 8i..8i+7
__device__ __forceinline__ uint32_t live_mask(int v) {
  return v >= 4 ? 0x80808080u
                : (v <= 0 ? 0u : 0x80808080u & ((1u << (8 * v)) - 1u));
}

// the block's tile into shared memory, 16 bytes a thread a step
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint8_t* src,
                                           int nbytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d[i] = s[i];
}

// the chunk's (subject, pattern) pairs through one stride-1 tile T
// (shared or global); a subject's live bytes are read a word at a time.
// kFlag: the walk of pattern 0 also writes the subject's non-ASCII flag
// (a separate instantiation, so a walk without it does no added work)
template <typename E, bool kFlag>
__device__ __forceinline__ void walk_stride1(
    const uint8_t* T, int P, const uint8_t* __restrict__ bytes,
    const int32_t* __restrict__ lens, int W, int ld, long long c0, int n,
    uint8_t* __restrict__ out, long long ostride,
    uint8_t* __restrict__ nonascii) {
  const int* f = reinterpret_cast<const int*>(T);
  const uint8_t* cms = T + 16 * P;
  for (int i = threadIdx.x; i < n * P; i += blockDim.x) {
    const int j = i / P;
    const int k = i - j * P;
    const long long s = c0 + j;
    const int lc = clamp_len(__ldg(lens + s), W);
    const uint8_t* b = bytes + s * ld;
    const E* rows = reinterpret_cast<const E*>(T + f[k]);
    const unsigned packed = (unsigned)f[2 * P + k];
    const int C = (int)(packed & 0xFFFFu);
    int state = (int)(packed >> 16);
    const uint8_t* cm = cms + k * kCmPitch;
    uint32_t high = 0;  // the high bits of the live bytes (B4)
    int w = 0;
    for (; w + 4 <= lc; w += 4) {
      const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(b + w));
      if (kFlag) high |= x;
      state = rows[state * C + cm[x & 0xFFu]];
      state = rows[state * C + cm[(x >> 8) & 0xFFu]];
      state = rows[state * C + cm[(x >> 16) & 0xFFu]];
      state = rows[state * C + cm[x >> 24]];
    }
    for (; w < lc; ++w) {
      const uint32_t x = __ldg(b + w);
      if (kFlag) high |= x;
      state = rows[state * C + cm[x]];
    }
    out[s * ostride + f[3 * P + k]] = T[f[P + k] + state];
    if (kFlag && k == 0) nonascii[s] = (high & 0x80808080u) != 0;
  }
}

// the chunk's (subject, pattern) pairs through one fused tile T (shared
// or global), two pairs (a word of the subject) a step. A pair wholly at
// or past min(len, W) is (pad, pad), the identity, so a word's second
// pair may be taken past the live ones, and the bytes of the word past
// W (rows are ld >= W bytes) are read as pad. kFlag as in walk_stride1.
template <typename E, bool kFlag>
__device__ __forceinline__ void walk_fused(
    const uint8_t* T, int P, const int* pairs,
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    int W, int ld, int pitch, long long c0, int n, uint8_t* __restrict__ out,
    long long ostride, uint8_t* __restrict__ nonascii) {
  const int* f = reinterpret_cast<const int*>(T);
  for (int i = threadIdx.x; i < n * P; i += blockDim.x) {
    const int j = i / P;
    const int k = i - j * P;
    const long long s = c0 + j;
    const int lc = clamp_len(__ldg(lens + s), W);
    const uint8_t* b = bytes + s * ld;
    const E* tab = reinterpret_cast<const E*>(T + f[k]);
    int state = f[2 * P + k];
    uint32_t high = 0;  // the high bits of the live bytes (B4)
    for (int p0 = 0; p0 < lc; p0 += 4) {
      const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(b + p0));
      if (kFlag) high |= x & live_mask(lc - p0);
      const int u0 =
          pairs[x & 0xFFu] +
          pairs[512 + ((x >> 8) & 0xFFu) + (p0 + 1 >= lc ? 256 : 0)];
      const int u1 =
          pairs[((x >> 16) & 0xFFu) + (p0 + 2 >= lc ? 256 : 0)] +
          pairs[512 + (x >> 24) + (p0 + 3 >= lc ? 256 : 0)];
      state = (int)tab[state + u0];
      state = (int)tab[state + u1];
    }
    out[s * ostride + f[3 * P + k]] = T[f[P + k] + state / pitch];
    if (kFlag && k == 0) nonascii[s] = (high & 0x80808080u) != 0;
  }
}

// dynamic shared memory: the tile (smem_tile bytes)
__global__ void __launch_bounds__(kThreads, 2) dfa_scan_stride1_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long S, int W, int ld, const uint8_t* __restrict__ blob,
    const int4* __restrict__ dir, int chunk, uint8_t* __restrict__ out,
    long long ostride, uint8_t* __restrict__ nonascii) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int4 d = dir[blockIdx.y];
  const long long c0 = (long long)blockIdx.x * chunk;
  const int n = (int)(S - c0 < chunk ? S - c0 : chunk);
  const bool staged = !(d.w & kGlobal);
  if (staged) stage_tile(smem, blob + d.x, d.y);
  // the flag is written by the walks of the directory's first tile
  const bool flag = nonascii != nullptr && blockIdx.y == 0;
  __syncthreads();
  // a walk of its own for each memory, so that the staged one reads
  // shared memory with shared-memory loads
#define K1_WALK(T, E)                                                        \
  do {                                                                       \
    if (flag)                                                                \
      walk_stride1<E, true>(T, d.z, bytes, lens, W, ld, c0, n, out, ostride, \
                            nonascii);                                       \
    else                                                                     \
      walk_stride1<E, false>(T, d.z, bytes, lens, W, ld, c0, n, out,         \
                             ostride, nonascii);                             \
  } while (0)
  if (staged) {
    if (d.w & kWide) K1_WALK(smem, uint16_t);
    else K1_WALK(smem, uint8_t);
  } else if (d.w & kWide) {
    K1_WALK(blob + d.x, uint16_t);
  } else {
    K1_WALK(blob + d.x, uint8_t);
  }
#undef K1_WALK
}

// dynamic shared memory: the tile (smem_tile bytes), the pair map
// (1024 int32)
__global__ void __launch_bounds__(kThreads) dfa_scan_fused_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long S, int W, int ld, const uint8_t* __restrict__ blob,
    const int4* __restrict__ dir, const int32_t* __restrict__ pairs_g,
    int pitch, int chunk, int smem_tile, uint8_t* __restrict__ out,
    long long ostride, uint8_t* __restrict__ nonascii) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int4 d = dir[blockIdx.y];
  const long long c0 = (long long)blockIdx.x * chunk;
  const int n = (int)(S - c0 < chunk ? S - c0 : chunk);
  const bool staged = !(d.w & kGlobal);
  if (staged) stage_tile(smem, blob + d.x, d.y);
  int* pairs = reinterpret_cast<int*>(smem + smem_tile);
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) pairs[i] = pairs_g[i];
  // the flag is written by the walks of the directory's first tile
  const bool flag = nonascii != nullptr && blockIdx.y == 0;
  __syncthreads();
#define K1_WALK(T, E)                                                       \
  do {                                                                      \
    if (flag)                                                               \
      walk_fused<E, true>(T, d.z, pairs, bytes, lens, W, ld, pitch, c0, n,  \
                          out, ostride, nonascii);                          \
    else                                                                    \
      walk_fused<E, false>(T, d.z, pairs, bytes, lens, W, ld, pitch, c0, n, \
                           out, ostride, nonascii);                         \
  } while (0)
  if (staged) {
    if (d.w & kWide) K1_WALK(smem, int32_t);
    else K1_WALK(smem, uint16_t);
  } else if (d.w & kWide) {
    K1_WALK(blob + d.x, int32_t);
  } else {
    K1_WALK(blob + d.x, uint16_t);
  }
#undef K1_WALK
}

// B4: the non-ASCII flag alone, for a lane family no K1 launch scans (a
// '?' glob on the NFA route). What bounds it: the subjects' live bytes,
// read once. A subject's row (ld bytes, a multiple of 16, from a 16-byte
// aligned base) takes G = min(ld / 16, 32) lanes of a warp, rounded up
// to a power of two; each lane reads 16 bytes a step with one vector
// load (its first beside the length's load, so the two wait together),
// skips the chunks wholly at or past min(len, W), masks the bytes past
// it, and the group's flags combine in one ballot. Neighbouring
// lanes read neighbouring 16 bytes, so a warp's loads are whole
// sectors.
__global__ void __launch_bounds__(256) dfa_nonascii_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
    long long n_subj, int W, int ld, int G, uint8_t* __restrict__ nonascii) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const long long s =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  uint32_t high = 0;
  if (s < n_subj) {
    const int chunks = ld / 16;
    const uint4* row = reinterpret_cast<const uint4*>(bytes + s * ld);
    // the lane's first 16 bytes are loaded beside the length, not after
    // it (the row holds them whatever the length); later ones only while
    // they hold live bytes
    uint4 x = g < chunks ? __ldg(row + g) : make_uint4(0u, 0u, 0u, 0u);
    const int lim = clamp_len(__ldg(lens + s), W);
    for (int c = g; c < chunks && c * 16 < lim; c += G) {
      if (c != g) x = __ldg(row + c);
      const int v = lim - c * 16;
      high |= (x.x & live_mask(v)) | (x.y & live_mask(v - 4)) |
              (x.z & live_mask(v - 8)) | (x.w & live_mask(v - 12));
    }
  }
  const unsigned votes = __ballot_sync(0xFFFFFFFFu, high != 0);
  const unsigned group = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u);
  if (g == 0 && s < n_subj)
    nonascii[s] = ((votes >> (lane & ~(G - 1))) & group) != 0;
}

constexpr int kNonasciiThreads = 256;

// The shared-memory opt-in is an attribute of the current device, so it
// is kept per device ordinal: a second card's first launch opts in again.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  // once a device, outside any stream capture (its first launch)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess) done[dev] = true;
  return (int)e;
}

bool stride1_smem_set[kMaxDevices] = {};
bool fused_smem_set[kMaxDevices] = {};

}  // namespace

extern "C" int dfa_scan_stride1(const void* bytes, const void* lens,
                                long long S, int W, int ld, const void* blob,
                                const void* dir, int n_tiles, int smem_tile,
                                int chunk, void* out, long long ostride,
                                void* nonascii, void* stream) {
  if (smem_tile > kMaxSmem) return (int)cudaErrorInvalidValue;
  int rc = allow_smem(dfa_scan_stride1_kernel, stride1_smem_set);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((S + chunk - 1) / chunk), (unsigned)n_tiles);
  dfa_scan_stride1_kernel<<<grid, kThreads, (size_t)smem_tile,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int32_t*)lens, S, W, ld,
      (const uint8_t*)blob, (const int4*)dir, chunk, (uint8_t*)out, ostride,
      (uint8_t*)nonascii);
  return (int)cudaGetLastError();
}

extern "C" int dfa_scan_fused(const void* bytes, const void* lens,
                              long long S, int W, int ld, const void* blob,
                              const void* dir, int n_tiles, int smem_tile,
                              const void* pairs, int pitch, int chunk,
                              void* out, long long ostride, void* nonascii,
                              void* stream) {
  const int smem = smem_tile + 4096;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int rc = allow_smem(dfa_scan_fused_kernel, fused_smem_set);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((S + chunk - 1) / chunk), (unsigned)n_tiles);
  dfa_scan_fused_kernel<<<grid, kThreads, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int32_t*)lens, S, W, ld,
      (const uint8_t*)blob, (const int4*)dir, (const int32_t*)pairs, pitch,
      chunk, smem_tile, (uint8_t*)out, ostride, (uint8_t*)nonascii);
  return (int)cudaGetLastError();
}

extern "C" int dfa_nonascii(const void* bytes, const void* lens,
                            long long n_subj, int W, int ld, void* nonascii,
                            void* stream) {
  if (ld % 16 != 0 || ld < W) return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < 32 && G * 16 < ld) G *= 2;
  const long long threads = n_subj * G;
  const int blocks = (int)((threads + kNonasciiThreads - 1) / kNonasciiThreads);
  dfa_nonascii_kernel<<<blocks, kNonasciiThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int32_t*)lens, n_subj, W, ld, G,
      (uint8_t*)nonascii);
  return (int)cudaGetLastError();
}
