// K9 glob_nfa: a pack of glob patterns (* and ?) against padded byte
// subjects, in one launch.
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
// The pack: the NFA-route globs of one lane family with the same
// number NW of 64-bit state words (kernels.GlobPack). A byte-class map
// (256 bytes -> C classes: the literal bytes the pack uses, NUL, and
// "no literal") compresses each pattern's table to C + 1 rows of NW
// words: row k holds the positions that consume the bytes of class k,
// row C the '*' positions. Per byte c, with T = table[class[c]] and
// S = table[C]:
//   new = ((dp << 1) & T) | (dp & S)        (consume c, or loop on '*')
//   new |= (new << 1) & S                   (epsilon over '*')
// One closure pass is exact: runs of '*' are collapsed, so two '*'
// positions are never adjacent and a bit never has to travel twice.
//
// Design: a block takes a tile of TS subjects and a tile of PT
// patterns. It stages in shared memory, once: the tables (laid out
// [row][word][pattern], so neighbouring lanes read neighbouring words),
// the class map, the lengths, and the subjects already mapped to class
// ids (16-byte loads; rows padded to an odd number of words). A warp
// steps PG patterns x 32/PG subjects (PG = 32 once the pack has 32
// patterns: the lanes share one subject's class, a broadcast), each
// lane one (subject, pattern) pair, with the '*' row in registers and,
// up to 4 state words, the next byte's table words loading while the
// current one steps; the warp stops when __any_sync finds no lane with
// a state left before its length. Answers go to a [pattern][subject]
// tile in shared memory, written out as contiguous rows of the (P, S)
// plane. Patterns that do not fit shared memory tile over blockIdx.y.
// The subject tile is sized from the card's occupancy so the grid is
// one wave where the subjects allow (512 threads a block up to 4 state
// words, 256 past them).
//
// Bound: the larger of memory (the subjects once, up to the last byte
// any pattern reads; the lengths, the tables and the (P, S) output:
// the pairs read the subjects again from shared memory) and operations
// (about 6 integer operations a state word for each byte a pair steps
// before its state dies or its length ends).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kyverno_tpu_torch/kernels.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemBudget = 200 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxTile = 128;  // subjects a block stages at most

// The shared-memory opt-in and the SM count are attributes of a device,
// so they are kept per device ordinal (cudaGetDevice), never once a process.
constexpr int kMaxDevices = 64;

// the current device's ordinal, or -1 when it cannot be read or is past
// kMaxDevices
int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

// threads a block: 512 while the state fits a few registers
template <int NW>
__host__ __device__ constexpr int threads_for() { return NW <= 4 ? 512 : 256; }

struct Tiling {
  int PG, TS, PT, WS;
  size_t smem;
};

template <int NW>
__device__ __forceinline__ void closure(u64 (&dp)[NW],
                                        const u64 (&star)[NW]) {
  u64 carry = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const u64 x = dp[k];
    dp[k] = x | (((x << 1) | carry) & star[k]);
    carry = x >> 63;
  }
}

// one byte of class row t: consume it, or loop on '*'; then the closure.
// Returns whether any state is left.
template <int NW>
__device__ __forceinline__ bool step(u64 (&dp)[NW], const u64 (&t)[NW],
                                     const u64 (&star)[NW]) {
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
  return any != 0;
}

template <int NW>
__device__ __forceinline__ void load_row(u64 (&t)[NW], const u64* tab,
                                         int row, int pc, int PT) {
#pragma unroll
  for (int k = 0; k < NW; ++k) t[k] = tab[((size_t)row * NW + k) * PT + pc];
}

// shared memory of a block: tables, lengths, accept positions, class
// map, subject tile, answer tile
__host__ __device__ inline size_t smem_bytes(int C1, int NW, int PT, int TS,
                                             int WS) {
  return (size_t)C1 * NW * PT * 8 + (size_t)TS * 4 + (size_t)PT * 4 + 256 +
         (size_t)TS * WS + (size_t)PT * TS;
}

template <int NW>
__global__ void __launch_bounds__(threads_for<NW>())
    glob_pack_kernel(const uint8_t* __restrict__ bytes,
                     const int32_t* __restrict__ lens, long long S, int W,
                     const uint8_t* __restrict__ cmap,
                     const u64* __restrict__ tables,
                     const int32_t* __restrict__ ms, int P, int C1,
                     Tiling tl, uint8_t* __restrict__ out) {
  constexpr int kThreads = threads_for<NW>();
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int PT = tl.PT, TS = tl.TS, WS = tl.WS, PG = tl.PG;
  u64* tab = reinterpret_cast<u64*>(smem);                  // [C1][NW][PT]
  int32_t* slen = reinterpret_cast<int32_t*>(tab + (size_t)C1 * NW * PT);
  int32_t* sm = slen + TS;                                  // [PT]
  uint8_t* cls = reinterpret_cast<uint8_t*>(sm + PT);       // [256]
  uint8_t* subj = cls + 256;                                // [TS][WS]
  uint8_t* acc = subj + (size_t)TS * WS;                    // [PT][TS]

  const long long s0 = (long long)blockIdx.x * TS;
  const int p0 = blockIdx.y * PT;
  const int ts = (int)(S - s0 < TS ? S - s0 : TS);
  const int pt = P - p0 < PT ? P - p0 : PT;
  const int per = C1 * NW;
  for (int i = threadIdx.x; i < pt * per; i += kThreads) {
    const int pl = i / per, rem = i - pl * per;
    tab[rem * PT + pl] = tables[(long long)(p0 + pl) * per + rem];
  }
  for (int i = threadIdx.x; i < pt; i += kThreads) sm[i] = ms[p0 + i];
  for (int i = threadIdx.x; i < 256; i += kThreads) cls[i] = cmap[i];
  for (int i = threadIdx.x; i < ts; i += kThreads) slen[i] = lens[s0 + i];
  __syncthreads();
  // the subjects as class ids, one row per subject; column W holds class
  // 0 so the step after the last byte may read it
  const uint8_t* src = bytes + s0 * W;
  if (W % 16 == 0 && ((uintptr_t)src & 15) == 0) {
    const int vpr = W / 16;
    for (int i = threadIdx.x; i < ts * vpr; i += kThreads) {
      const int r = i / vpr, v = i - r * vpr;
      const uint4 x = reinterpret_cast<const uint4*>(src)[i];
      const unsigned in[4] = {x.x, x.y, x.z, x.w};
      uint32_t* d = reinterpret_cast<uint32_t*>(subj + r * WS + v * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned b = in[q];
        d[q] = cls[b & 0xFF] | (unsigned)cls[(b >> 8) & 0xFF] << 8 |
               (unsigned)cls[(b >> 16) & 0xFF] << 16 |
               (unsigned)cls[b >> 24] << 24;
      }
    }
  } else {
    for (int i = threadIdx.x; i < ts * W; i += kThreads) {
      const int r = i / W;
      subj[r * WS + (i - r * W)] = cls[src[i]];
    }
  }
  for (int r = threadIdx.x; r < ts; r += kThreads) subj[r * WS + W] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int SW = 32 / PG;
  const int pgroups = (pt + PG - 1) / PG, sgroups = (ts + SW - 1) / SW;
  for (int item = warp; item < pgroups * sgroups; item += kWarps) {
    const int pl = (item % pgroups) * PG + lane % PG;
    const int sl = (item / pgroups) * SW + lane / PG;
    const bool active = pl < pt && sl < ts;
    const int pc = active ? pl : 0;
    const int len = active ? slen[sl] : -1;
    const bool in_range = len >= 0 && len <= W;
    const uint8_t* row = subj + (active ? sl : 0) * WS;
    u64 star[NW], dp[NW];
    load_row<NW>(star, tab, C1 - 1, pc, PT);
#pragma unroll
    for (int k = 0; k < NW; ++k) dp[k] = k == 0 ? 1 : 0;
    closure<NW>(dp, star);
    bool alive = in_range;
    if (NW <= 4) {
      // the next byte's table words load while this byte steps
      u64 t[NW];
      load_row<NW>(t, tab, row[0], pc, PT);
      for (int w = 0; __any_sync(kFull, alive && w < len); ++w) {
        if (alive && w < len) {
          u64 next[NW];
          load_row<NW>(next, tab, row[w + 1], pc, PT);
          alive = step<NW>(dp, t, star);
#pragma unroll
          for (int k = 0; k < NW; ++k) t[k] = next[k];
        }
      }
    } else {
      for (int w = 0; __any_sync(kFull, alive && w < len); ++w) {
        if (alive && w < len) {
          u64 t[NW];
          load_row<NW>(t, tab, row[w], pc, PT);
          alive = step<NW>(dp, t, star);  // none left: none revives
        }
      }
    }
    if (active) {
      const int m = sm[pc];
      bool a = false;
#pragma unroll
      for (int k = 0; k < NW; ++k)
        if (k == m / 64) a = (dp[k] >> (m % 64)) & 1;
      acc[pl * TS + sl] = in_range && a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < pt * ts; i += kThreads) {
    const int pl = i / ts, sl = i - pl * ts;
    out[(long long)(p0 + pl) * S + s0 + sl] = acc[pl * TS + sl];
  }
}

// Lane split, subject tile and pattern tile for P patterns of C1 table
// rows over S subjects of W bytes; PT 0 when one pattern does not fit.
// The subject tile makes the grid one wave of the blocks the card holds
// at once, gives every warp an item where that leaves a block for each
// SM, and is at most kMaxTile.
template <int NW>
Tiling tiling(long long S, int P, int C1, int W) {
  constexpr int kWarps = threads_for<NW>() / 32;
  Tiling t;
  t.PG = 1;
  while (t.PG < 32 && t.PG < P) t.PG <<= 1;
  const int SW = 32 / t.PG;
  int words = (W + 1 + 3) / 4;  // column W holds a pad class
  if (words % 2 == 0) ++words;  // odd: rows fall on distinct banks
  t.WS = 4 * words;
  const int pgroups = (P + t.PG - 1) / t.PG;
  const int min_ts = SW * ((kWarps + pgroups - 1) / pgroups);
  auto fit = [&](int ts) {  // patterns a block holds at this tile
    const size_t fixed = smem_bytes(C1, NW, 0, ts, t.WS);
    const size_t per = (size_t)C1 * NW * 8 + 4 + ts;
    long long pt =
        fixed < (size_t)kSmemBudget ? (kSmemBudget - fixed) / per : 0;
    if (pt > P) pt = P;
    if (pt > t.PG && pt < P) pt -= pt % t.PG;
    return (int)pt;
  };
  int ts = min_ts > kMaxTile ? min_ts : kMaxTile;
  while (ts > SW && fit(ts) < 1) ts -= SW;
  t.PT = fit(ts);
  t.TS = ts;
  t.smem = t.PT > 0 ? smem_bytes(C1, NW, t.PT, ts, t.WS) : 0;
  if (t.PT < 1) return t;
  // one wave: as many tiles as the card holds blocks, if that is no
  // fewer subjects a tile than every warp needs
  static int sms_of[kMaxDevices] = {};
  const int dev = current_device();
  int sms = dev < 0 ? 0 : sms_of[dev];
  if (dev >= 0 && sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms_of[dev] = sms;
  }
  if (sms < 1) sms = 1;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, glob_pack_kernel<NW>, threads_for<NW>(), t.smem);
  const long long ytiles = (P + t.PT - 1) / t.PT;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long want = (S * ytiles + slots - 1) / slots;
  if (want < min_ts) want = min_ts;
  // but never fewer blocks than the card has SMs
  const long long spread = (S * ytiles + sms - 1) / sms;
  if (want > spread) want = spread;
  want = (want + SW - 1) / SW * SW;
  if (want < t.TS) {
    t.TS = (int)want;
    t.smem = smem_bytes(C1, NW, t.PT, t.TS, t.WS);
  }
  return t;
}

template <int NW>
int launch(const uint8_t* bytes, const int32_t* lens, long long S, int W,
           const uint8_t* cmap, const void* tables, const int32_t* ms, int P,
           int C1, uint8_t* out, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        glob_pack_kernel<NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const Tiling tl = tiling<NW>(S, P, C1, W);
  if (tl.PT < 1) return (int)cudaErrorInvalidValue;
  const long long bx = (S + tl.TS - 1) / tl.TS;
  const int by = (P + tl.PT - 1) / tl.PT;
  if (bx > 0x7fffffffLL || by > 65535) return (int)cudaErrorInvalidValue;
  glob_pack_kernel<NW>
      <<<dim3((unsigned)bx, (unsigned)by), threads_for<NW>(), tl.smem,
         stream>>>(bytes, lens, S, W, cmap, (const u64*)tables, ms, P, C1,
                   tl, out);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes (S, W) uint8, lens (S,) int32, cmap (256,) uint8 byte -> class,
// tables (P, C1, nw) words with the '*' row last, ms (P,) int32 accept
// positions, out (P, S) bool. nw: 1, 2, 4, 8, 16 or 32 64-bit words.
extern "C" int glob_nfa_pack(const void* bytes, const void* lens,
                             long long S, int W, const void* cmap,
                             const void* tables, const void* ms, int P,
                             int C1, int nw, void* out, void* stream) {
  if (P < 1 || C1 < 2 || C1 > 257 || W < 0) return (int)cudaErrorInvalidValue;
  const uint8_t* b = (const uint8_t*)bytes;
  const int32_t* l = (const int32_t*)lens;
  const uint8_t* c = (const uint8_t*)cmap;
  const int32_t* m = (const int32_t*)ms;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nw) {
    case 1: return launch<1>(b, l, S, W, c, tables, m, P, C1, o, st);
    case 2: return launch<2>(b, l, S, W, c, tables, m, P, C1, o, st);
    case 4: return launch<4>(b, l, S, W, c, tables, m, P, C1, o, st);
    case 8: return launch<8>(b, l, S, W, c, tables, m, P, C1, o, st);
    case 16: return launch<16>(b, l, S, W, c, tables, m, P, C1, o, st);
    case 32: return launch<32>(b, l, S, W, c, tables, m, P, C1, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
