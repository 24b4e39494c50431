// K10 meta_any: the any-of over a match filter's names / namespaces.
//
// Replaces the per-entry loops of kyverno_tpu/tpu/evaluator.py
// _eval_condition_block (1589; loops 1618-1631). For a filter list of
// entries e and a resource n, each entry gives an accept a_f(e, n) in
// lane family f (0 = the resource name, 1 = its namespace) from one of
// two sources:
//   - a plane slot: a column of the family's DFA-bank plane (K1's (N, K)
//     output, resource-major), a row of one of its K9 pack planes
//     ((P, N), entry-major) or a row of the stacked accepts of globs
//     outside the packs ((U, N), entry-major);
//   - a 64-bit hash equality of the family's (N, 2) int32 hash lane
//     with the entry's (hi, lo) pair (an entry with no wildcard).
// The outputs, for names (one family) and namespaces (two):
//   hit[n]  = OR_e a_0(e, n)                         (names)
//           = is_ns[n] ? OR_e a_0(e, n) : OR_e a_1(e, n)  (namespaces)
//   conf[n] = OR_{f,e} (a_f(e, n) && self_f(e))  ||  OR_f (na_f && na_f[n])
// where self marks an over-approximating DFA (its accept is the confirm
// plane) and na_f is the family's non-ASCII mask when any of its
// entries confirms non-ASCII subjects (a confirm_nonascii DFA, an NFA
// glob with '?'). Confirm covers both families whatever is_ns is, as
// the reference's loop appends both families' confirm planes.
//
// The table (kernels.MetaAnyTable.tab, int32, built once per compiled
// program and filter) holds the entries in the form each source reads
// best:
//   - a bank slot's entries become two column masks, accept and self
//     (a byte of 0xff or 0 a column, 16 zero bytes before column 0 and
//     32 after the columns padded to 16): a warp reads a resource's row
//     coalesced, 16 aligned bytes a lane (the row's first and last
//     granules included, whatever the row's offset), and ANDs them with
//     the masks shifted to the row's offset (funnel shifts of mask
//     words); a plane whose columns are not adjacent is read a byte a
//     column;
//   - an entry-major slot's entries are a run of rows (row | self << 31):
//     a thread takes a resource, so a warp reads 32 consecutive
//     resources of one row; the slot's pointer is read once a run;
//   - literals are each family's (hi, lo, self) pairs sorted by (hi, lo):
//     a binary search a resource.
// A block serves a tile of R resources (the host's meta_any_tile) and
// stages the whole table into shared memory once (read from global
// memory in place when it would not fit). Plane slot s is read at
// p[s] + n * sn[s] + idx * se[s] (bytes of bool); the plane pointers
// travel by value in the kernel's parameters (a plane is made anew each
// run), so a CUDA-graph replay reads the planes of its capture.
//
// Bound: bytes — the planes' cells this filter reads, the hash lanes,
// the table and the two (N,) outputs (at the tenant scan shape
// ~2 x 16,384 x 2,997 bank bytes, ~0.03 ms at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 72;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kHead = 8;          // _MA_HEAD in kernels.py
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory opt-in is an attribute of a device, so it is kept per
// device ordinal (cudaGetDevice), never once a process.
constexpr int kMaxDevices = 64;

// the current device's ordinal, or -1 when it cannot be read or is past
// kMaxDevices
int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

struct Planes {
  const uint8_t* p[kMaxPlanes];
  long long sn[kMaxPlanes];  // bytes between resources
  long long se[kMaxPlanes];  // bytes between entries (columns or rows)
  int adj[kMaxPlanes];       // a bank plane's columns adjacent (se == 1)
};

// the 16 mask bytes of columns b .. b + 15 (b = 4 * j + r, r in 0..3,
// b >= -16): five aligned words, funnel-shifted by r bytes
__device__ __forceinline__ uint4 mask16(const uint8_t* m, int b) {
  const int j = b >> 2, r = (b & 3) * 8;
  const unsigned* w = (const unsigned*)m + j;
  const unsigned w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  return make_uint4(__funnelshift_r(w0, w1, r), __funnelshift_r(w1, w2, r),
                    __funnelshift_r(w2, w3, r), __funnelshift_r(w3, w4, r));
}

__device__ __forceinline__ bool any4(uint4 x, uint4 m) {
  return ((x.x & m.x) | (x.y & m.y) | (x.z & m.z) | (x.w & m.w)) != 0;
}

// one resource's row of a bank slot against its masks (a warp; each
// lane's share), into *h (accept) and *cf (self)
__device__ __forceinline__ void bank_row(const uint8_t* row, long long se,
                                         int adj, const uint8_t* cm,
                                         const uint8_t* sm, int ncols,
                                         int lane, bool* h, bool* cf) {
  if (adj) {
    // the aligned 16-byte granules that hold the row: granule k holds
    // columns 16 k - o .. 16 k - o + 15 (those outside the row meet
    // zero mask bytes)
    const int o = (int)((uintptr_t)row & 15);
    const uint4* const g = (const uint4*)(row - o);
    const int granules = (o + ncols + 15) >> 4;
#pragma unroll 4
    for (int k = lane; k < granules; k += 32) {
      const uint4 x = __ldg(g + k);
      *h |= any4(x, mask16(cm, 16 * k - o));
      if (sm != nullptr) *cf |= any4(x, mask16(sm, 16 * k - o));
    }
    return;
  }
  for (int c = lane; c < ncols; c += 32) {
    const bool x = __ldg(row + c * se) != 0;
    *h |= x && cm[c] != 0;
    if (sm != nullptr) *cf |= x && sm[c] != 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    meta_any_kernel(const int* __restrict__ tab, int tab_words, int staged,
                    const __grid_constant__ Planes P,
                    const int32_t* __restrict__ name_h,
                    const int32_t* __restrict__ ns_h,
                    const uint8_t* __restrict__ is_ns,
                    const uint8_t* __restrict__ na_name,
                    const uint8_t* __restrict__ na_ns, int N, int R,
                    uint8_t* __restrict__ hit, uint8_t* __restrict__ conf) {
  extern __shared__ int4 smem4[];
  int* const smem = (int*)smem4;
  // bit f: family f hits; bit 2: confirm
  int* const flags = smem + (staged ? tab_words : 0);
  const int* T = tab;
  if (staged) {
    for (int i = threadIdx.x; i < (tab_words >> 2); i += kThreads)
      smem4[i] = __ldg((const int4*)tab + i);
    T = smem;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) flags[r] = 0;
  __syncthreads();
  const int base = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = T[0], ne = T[1];
  const int4* const runs = (const int4*)(T + T[2]);
  // resource-major slots: a warp a resource's row
  if (nb > 0) {
    for (int r = warp; r < R; r += kWarps) {
      const int n = base + r;
      if (n >= N) break;
      int bits = 0;
      for (int b = 0; b < nb; ++b) {
        const int4 run = runs[b];
        const int s = run.x, ncols = run.z;
        // a mask: 16 zero bytes, the padded columns, 32 zero bytes
        const int pad = (ncols + 15) & ~15;
        const uint8_t* cm = (const uint8_t*)T + run.w;
        const uint8_t* sm = (run.y >> 8) ? cm + pad + 48 : nullptr;
        bool h = false, cf = false;
        bank_row(P.p[s] + (long long)n * P.sn[s], P.se[s], P.adj[s], cm, sm,
                 ncols, lane, &h, &cf);
        if (__any_sync(kFull, h)) bits |= 1 << (run.y & 0xff);
        if (__any_sync(kFull, cf)) bits |= 4;
      }
      if (lane == 0 && bits) atomicOr(&flags[r], bits);
    }
  }
  // entry-major slots and literals: a thread a resource (threads that
  // share a resource split its entries)
  {
    const int split = kThreads / R;
    const int r = threadIdx.x % R, part = threadIdx.x / R;
    const int n = base + r;
    if (n < N) {
      int bits = 0;
      const int* const rows = T + T[3];
      for (int e = 0; e < ne; ++e) {
        const int4 run = runs[nb + e];  // {slot, family, first, count}
        const uint8_t* col = P.p[run.x] + (long long)n * P.sn[run.x];
        const long long se = P.se[run.x];
        bool h = false, cf = false;
#pragma unroll 4
        for (int i = run.z + part; i < run.z + run.w; i += split) {
          const int q = rows[i];
          const bool x = __ldg(col + (long long)(q & 0x7fffffff) * se) != 0;
          h |= x;
          cf |= x && q < 0;
        }
        if (h) bits |= 1 << run.y;
        if (cf) bits |= 4;
      }
      if (part == 0) {
        for (int f = 0; f < 2; ++f) {
          const int cnt = T[5 + 2 * f];
          if (cnt == 0) continue;
          const int4* const lit = (const int4*)(T + T[4 + 2 * f]);
          const int32_t* const hl = f == 0 ? name_h : ns_h;
          const int kh = hl[2 * (long long)n], kl = hl[2 * (long long)n + 1];
          int lo = 0, hi = cnt;  // the first pair >= (kh, kl)
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            const int4 q = lit[mid];
            if (q.x < kh || (q.x == kh && q.y < kl))
              lo = mid + 1;
            else
              hi = mid;
          }
          if (lo < cnt) {
            const int4 q = lit[lo];
            if (q.x == kh && q.y == kl) bits |= (1 << f) | (q.z ? 4 : 0);
          }
        }
      }
      if (bits) atomicOr(&flags[r], bits);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int n = base + r;
    if (n >= N) break;
    const int bits = flags[r];
    bool c = (bits & 4) != 0;
    if (na_name != nullptr) c |= na_name[n] != 0;
    if (na_ns != nullptr) c |= na_ns[n] != 0;
    hit[n] = (is_ns == nullptr || is_ns[n] != 0) ? (bits & 1) != 0
                                                 : (bits & 2) != 0;
    conf[n] = c;
  }
}

}  // namespace

// tab: the (tab_words,) int32 table (MetaAnyTable.tab; tab_words a
// multiple of 4); planes: np plane pointers, then their resource
// strides, their entry strides (bytes) and whether a bank plane's
// columns are adjacent (1 or 0), read here and passed to the kernel by
// value; name_h / ns_h: (N, 2) int32 hash lanes (ns_h with namespace
// entries); is_ns: (N,) bool or null (names: the name family alone);
// na_name / na_ns: (N,) bool non-ASCII masks or null; R resources a
// block (a power of two, 8 to 256); hit / conf: (N,) bool outputs.
extern "C" int meta_any(const void* tab, int tab_words,
                        const long long* planes, int np, const void* name_h,
                        const void* ns_h, const void* is_ns,
                        const void* na_name, const void* na_ns, long long N,
                        int R, void* hit, void* conf, void* stream) {
  if (np < 0 || np > kMaxPlanes || tab_words < kHead || (tab_words & 3) ||
      N < 0 || N > 0x7fffffffLL || R < 8 || R > kThreads || (R & (R - 1)))
    return (int)cudaErrorInvalidValue;
  Planes P = {};
  for (int s = 0; s < np; ++s) {
    P.p[s] = (const uint8_t*)planes[s];
    P.sn[s] = planes[np + s];
    P.se[s] = planes[2 * np + s];
    P.adj[s] = planes[3 * np + s] != 0;
  }
  if (N == 0) return 0;
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        meta_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  // the table staged in shared memory when it fits beside the flags
  const long long staged_bytes = 4LL * tab_words + 4LL * R;
  const int staged = staged_bytes <= kMaxSmem;
  const size_t smem = staged ? (size_t)staged_bytes : (size_t)(4 * R);
  const long long blocks = (N + R - 1) / R;
  meta_any_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)tab, tab_words, staged, P, (const int32_t*)name_h,
      (const int32_t*)ns_h, (const uint8_t*)is_ns, (const uint8_t*)na_name,
      (const uint8_t*)na_ns, (int)N, R, (uint8_t*)hit, (uint8_t*)conf);
  return (int)cudaGetLastError();
}
