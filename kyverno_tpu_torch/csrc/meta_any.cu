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
// Layout: the entry table is (E, 4) int32, {slot or -1, column/row or
// hash hi, hash lo, self}, the name family's entries first, then the
// namespace family's, each sorted by (slot, column); the caller builds
// it once per compiled program and filter. Plane slot s is read at
// p[s] + n * sn[s] + idx * se[s] (bytes of bool): a bank plane has
// sn = K, se = 1, so the lanes of a warp read neighbouring columns of
// one row (one or two 32-byte sectors a step); a pack plane has sn = 1,
// se = N, so a resource's entries there are strided by N and each lane
// reads its own sector, which the neighbouring resources' warps of the
// block read next (the rows stay in L1/L2). The plane pointers travel
// by value in the kernel's parameters (a plane is made anew each run).
//
// Bound: bytes — the planes' cells this filter reads, the hash lanes,
// the entry table and the two (N,) outputs (at the tenant scan shape
// ~2 x 16,384 x 2,997 bank bytes, ~0.03 ms at 3.35 TB/s). Design: one
// warp per resource; its lanes stride over the entries and fold hit and
// confirm with __any_sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 72;
constexpr int kWarps = 8;  // resources a block
constexpr unsigned kFull = 0xffffffffu;

struct Planes {
  const uint8_t* p[kMaxPlanes];
  long long sn[kMaxPlanes];  // bytes between resources
  long long se[kMaxPlanes];  // bytes between entries (columns or rows)
};

__device__ __forceinline__ bool family_any(const int4* __restrict__ ent,
                                           int beg, int end,
                                           const Planes& P, long long n,
                                           int32_t hhi, int32_t hlo,
                                           int lane, bool* conf) {
  bool hit = false;
  for (int e = beg + lane; e < end; e += 32) {
    const int4 q = ent[e];
    bool a;
    if (q.x < 0) {
      a = (q.y == hhi) && (q.z == hlo);
    } else {
      a = P.p[q.x][n * P.sn[q.x] + (long long)q.y * P.se[q.x]] != 0;
    }
    hit |= a;
    *conf |= a && q.w != 0;
  }
  return hit;
}

__global__ void meta_any_kernel(const int4* __restrict__ ent, int e1, int e2,
                                const __grid_constant__ Planes P,
                                const int32_t* __restrict__ name_h,
                                const int32_t* __restrict__ ns_h,
                                const uint8_t* __restrict__ is_ns,
                                const uint8_t* __restrict__ na_name,
                                const uint8_t* __restrict__ na_ns,
                                long long N, uint8_t* __restrict__ hit,
                                uint8_t* __restrict__ conf) {
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  bool cf = false;
  const bool h0 = family_any(ent, 0, e1, P, n, name_h[2 * n],
                             name_h[2 * n + 1], lane, &cf);
  bool h1 = false;
  if (e2 > e1)
    h1 = family_any(ent, e1, e2, P, n, ns_h[2 * n], ns_h[2 * n + 1], lane,
                    &cf);
  const bool any0 = __any_sync(kFull, h0);
  const bool any1 = __any_sync(kFull, h1);
  const bool anyc = __any_sync(kFull, cf);
  if (lane == 0) {
    bool c = anyc;
    if (na_name != nullptr) c |= na_name[n] != 0;
    if (na_ns != nullptr) c |= na_ns[n] != 0;
    hit[n] = (is_ns == nullptr || is_ns[n] != 0) ? any0 : any1;
    conf[n] = c;
  }
}

}  // namespace

// ent: (e2, 4) int32 entries (the name family's in [0, e1), the
// namespace family's in [e1, e2)); planes: np plane pointers, then
// their resource strides, then their entry strides (bytes), read here
// and passed to the kernel by value; name_h / ns_h: (N, 2) int32 hash
// lanes (ns_h only with namespace entries); is_ns: (N,) bool or null
// (names: the name family alone); na_name / na_ns: (N,) bool non-ASCII
// masks or null; hit / conf: (N,) bool outputs.
extern "C" int meta_any(const void* ent, int e1, int e2,
                        const long long* planes, int np, const void* name_h,
                        const void* ns_h, const void* is_ns,
                        const void* na_name, const void* na_ns, long long N,
                        void* hit, void* conf, void* stream) {
  if (np < 0 || np > kMaxPlanes || e1 < 0 || e2 < e1 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (e2 > e1 && ns_h == nullptr) return (int)cudaErrorInvalidValue;
  Planes P = {};
  for (int s = 0; s < np; ++s) {
    P.p[s] = (const uint8_t*)planes[s];
    P.sn[s] = planes[np + s];
    P.se[s] = planes[2 * np + s];
  }
  if (N == 0) return 0;
  const long long blocks = (N + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  meta_any_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int4*)ent, e1, e2, P, (const int32_t*)name_h,
      (const int32_t*)ns_h, (const uint8_t*)is_ns, (const uint8_t*)na_name,
      (const uint8_t*)na_ns, N, (uint8_t*)hit, (uint8_t*)conf);
  return (int)cudaGetLastError();
}
