// K11 class_fold: a rule's class logic as one launch.
//
// Replaces the per-node class folds of kyverno_tpu/tpu/evaluator.py that
// jax.jit traces and XLA fuses: eval_rule (1886; its verdict ladder,
// host/confirm ORs and _glob_fallback), the node folds (_eval_leaf,
// _eval_map 654, _eval_existence, _eval_array_maps, _eval_array_scalar,
// _first_nonpass 590, the wildcard anchor's select) and the condition
// folds (eval_cond_tree 798, _eval_condition_block 1589, eval_match 1682,
// _eval_foreach_deny 1758). The evaluator records that logic on a tape
// (kyverno_tpu_torch/tpu/fold.py) and compiles it once per program into
// a list of instructions; this kernel interprets the list for every
// resource at once.
//
// Values: each is an int over one of three shape kinds, N (a resource),
// NI (a resource's instances) or NIJ (its nested instances). Mapping: a
// group of G lanes per resource n (G = I rounded up to a power of two,
// so a warp serves 32 / G resources: two at the PSS shape, I = 16); lane
// i of the group holds instance i (I <= 32) of an NI value and the J
// entries of an NIJ value (a loop in the thread); an N value is the same
// in every lane of the group. Values live in the warp's slice of shared
// memory: an N value in one word of its group (every lane computes it
// and writes the same value; a __syncwarp before each such write keeps a lane from
// overwriting a word another lane has still to read, as a reused slot
// would be), an NI value in a word a lane, an NIJ value in J words a
// lane, lane words laid out [word][lane] so a warp's accesses never
// conflict. The compiler allocates slots by liveness. Reductions over
// instances (any, all, the prefix ORs of foreach) are warp ballots, cut
// to the group's bits; over J, loops.
//
// Instructions, an int4 each: {op | kind << 8 | f << 16, a, b, c}, kind
// being the result's (any/all read the kind one deeper, expand reads N)
// and f the result's slot unless noted:
//   LOAD   a group of f values read together: the next f rows are
//          {kind, slot, descriptor, 0} (N and NI values)
//   LOADJ  f <- descriptor a (an NIJ value)
//   CONST  f <- a                     NOT f <- !a
//   AND / OR f <- a && b / a || b    EQC / NEC f <- a == b / a != b
//   EQ     f <- a == b (two values)   WHERE f <- a ? b : c
//   FNP    f <- a != 0 ? a : b (a step of the first-non-pass fold)
//   ANY / ALL f <- any / all over the last axis of a
//   EXPAND f <- a (N -> NI)           SCAN / SCANX f <- prefix OR over
//                                       instances, inclusive / exclusive
//   STORE  descriptor b <- a
// A load group issues its reads before it writes any slot, so a warp
// waits on global memory once a group, not once a value.
// Descriptors (inputs, then outputs): pointer, element strides (resource,
// instance, nested) and element width (1: bool/uint8, 4: int32), passed
// by value in a __grid_constant__ block, as K10's planes are, so a
// CUDA-graph replay reads the tensors of its capture. A tape with more
// descriptors than the block holds is split by the compiler into
// launches that hand values on through scratch tensors.
//
// Bound: bytes — each input read once and each output written once (a
// dense PSS run's 66 launches read ~0.9 GB of distinct input bytes at
// N = 16,384). The interpreter's cost is instruction issue: every warp
// decodes a rule's ~150 instructions, tens of machine instructions each,
// so the work scales with warps x instructions; lane groups (more
// resources a warp), one int4 a decode read ahead of its use, small
// slots (an N value takes one word) and grouped loads cut it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIO = 128;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMaxWarps = 8;      // resources a block
constexpr int kLoadGroup = 8;     // LOAD_GROUP in tpu/fold.py
constexpr unsigned kFull = 0xffffffffu;

enum Op {
  LOAD, CONST, NOT, AND, OR, EQC, NEC, EQ, WHERE, FNP, ANY, ALL, EXPAND,
  SCAN, SCANX, STORE, LOADJ
};

struct Io {
  const void* p[kMaxIO];
  long long sn[kMaxIO];  // elements between resources
  int si[kMaxIO];        // between instances
  int sj[kMaxIO];        // between nested instances
  int w[kMaxIO];         // element bytes: 1 or 4
};

__device__ __forceinline__ int ld(const Io& P, int d, long long off) {
  return P.w[d] == 1 ? (int)((const uint8_t*)P.p[d])[off]
                     : ((const int32_t*)P.p[d])[off];
}

__device__ __forceinline__ void st(const Io& P, int d, long long off, int v) {
  if (P.w[d] == 1)
    ((uint8_t*)P.p[d])[off] = (uint8_t)(v != 0);
  else
    ((int32_t*)P.p[d])[off] = v;
}

__global__ void class_fold_kernel(const int4* __restrict__ code, int n_instr,
                                  int n_uniform, int n_lane,
                                  const __grid_constant__ Io P, long long N,
                                  int I, int J, int log2g) {
  extern __shared__ int smem[];
  const int G = 1 << log2g;  // a resource's lanes: I rounded up to 2^k
  const int per = 32 >> log2g;  // resources a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> log2g, gl = lane & (G - 1);
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * per;
  if (first >= N) return;  // whole warps leave together
  // a lane group past N computes on the last resource and stores nothing
  const bool live = first + grp < N;
  const long long n = live ? first + grp : N - 1;
  int* const W = smem + warp * (per * n_uniform + 32 * n_lane);
  int* const U = W + grp * n_uniform;         // the resource's N values
  int* const L = W + per * n_uniform + lane;  // L[word * 32]
  const bool inst = gl < I;
  const unsigned gshift = (unsigned)(grp << log2g);
  const unsigned gmask = G == 32 ? kFull : (1u << G) - 1u;
  int4 h = __ldg(code);
  for (int pc = 0; pc < n_instr;) {
    const int op = h.x & 0xff, kind = (h.x >> 8) & 0xff;
    const int f = (int)((unsigned)h.x >> 16);
    const int a = h.y, b = h.z, c = h.w;
    // the next instruction's read overlaps this one's work
    const int npc = pc + 1 + (op == LOAD ? f : 0);
    const int4 nh = npc < n_instr ? __ldg(code + npc) : h;
    // the result's slot, and the operands' (of the result's kind): an
    // NIJ value's J words are 32 apart
    int* const D = kind == 0 ? U + f : L + f * 32;
    const int* const A = kind == 0 ? U + a : L + a * 32;
    const int* const B = kind == 0 ? U + b : L + b * 32;
    const int* const C = kind == 0 ? U + c : L + c * 32;
    int r = 0;
    bool write = true;  // r goes to *D after the switch
    // an elementwise op: r for an N or NI result, each word of an NIJ one
    auto elem = [&](auto fn) {
      if (kind == 2) {
        for (int u = 0; u < J; ++u) D[u * 32] = fn(u * 32);
        write = false;
      } else {
        r = fn(0);
      }
    };
    switch (op) {
      case LOAD: {
        int v[kLoadGroup];
#pragma unroll
        for (int q = 0; q < kLoadGroup; ++q) {
          if (q < f) {
            const int4 e = __ldg(code + pc + 1 + q);
            const long long base = n * P.sn[e.z];
            v[q] = e.x == 0 ? ld(P, e.z, base)
                   : inst   ? ld(P, e.z, base + (long long)gl * P.si[e.z])
                            : 0;
          }
        }
        __syncwarp();  // every lane has read the N words this group reuses
#pragma unroll
        for (int q = 0; q < kLoadGroup; ++q) {
          if (q < f) {
            const int4 e = __ldg(code + pc + 1 + q);
            if (e.x == 0)
              U[e.y] = v[q];
            else
              L[e.y * 32] = v[q];
          }
        }
        write = false;
        break;
      }
      case LOADJ: {
        const long long base = n * P.sn[a] + (long long)gl * P.si[a];
        for (int j0 = 0; j0 < J; j0 += kLoadGroup) {
          int v[kLoadGroup];
#pragma unroll
          for (int q = 0; q < kLoadGroup; ++q)
            v[q] = (inst && j0 + q < J)
                       ? ld(P, a, base + (long long)(j0 + q) * P.sj[a])
                       : 0;
#pragma unroll
          for (int q = 0; q < kLoadGroup; ++q)
            if (j0 + q < J) D[(j0 + q) * 32] = v[q];
        }
        write = false;
        break;
      }
      case CONST:
        elem([&](int) { return a; });
        break;
      case NOT:
        elem([&](int u) { return (int)(A[u] == 0); });
        break;
      case AND:
        elem([&](int u) { return (int)((A[u] != 0) & (B[u] != 0)); });
        break;
      case OR:
        elem([&](int u) { return (int)((A[u] != 0) | (B[u] != 0)); });
        break;
      case EQC:
        elem([&](int u) { return (int)(A[u] == b); });
        break;
      case NEC:
        elem([&](int u) { return (int)(A[u] != b); });
        break;
      case EQ:
        elem([&](int u) { return (int)(A[u] == B[u]); });
        break;
      case WHERE:
        elem([&](int u) { return A[u] != 0 ? B[u] : C[u]; });
        break;
      case FNP:
        elem([&](int u) { return A[u] != 0 ? A[u] : B[u]; });
        break;
      case ANY:
      case ALL:
        if (kind == 0) {  // NI -> N: the lane group's instances
          const bool v = L[a * 32] != 0;
          const unsigned m = (__ballot_sync(kFull, op == ANY ? (inst && v)
                                                           : (!inst || v)) >>
                              gshift) & gmask;
          r = op == ANY ? (m != 0) : (m == gmask);
        } else {  // NIJ -> NI: the thread's J entries
          r = op == ALL;
          for (int j = 0; j < J; ++j) {
            const bool v = L[(a + j) * 32] != 0;
            r = op == ANY ? (r | v) : (r & v);
          }
        }
        break;
      case EXPAND:
        r = U[a];
        break;
      case SCAN:
      case SCANX: {
        const unsigned m =
            (__ballot_sync(kFull, inst && *A != 0) >> gshift) & gmask;
        const unsigned upto = op == SCAN ? (2u << gl) - 1u : (1u << gl) - 1u;
        r = (m & upto) != 0;
        break;
      }
      case STORE: {
        const long long base = n * P.sn[b];
        if (kind == 0) {
          if (gl == 0 && live) st(P, b, base, *A);
        } else if (inst && live) {
          const long long at = base + (long long)gl * P.si[b];
          for (int u = 0; u < (kind == 2 ? J : 1); ++u)
            st(P, b, at + (long long)u * P.sj[b], A[u * 32]);
        }
        write = false;
        break;
      }
      default:
        write = false;
        break;
    }
    if (write) {
      // an N value's word is shared by the warp's lanes, and may be an
      // operand's: no lane writes it before every lane has read
      if (kind == 0) __syncwarp();
      *D = r;
    }
    pc = npc;
    h = nh;
  }
}

}  // namespace

// code: (n_instr, 4) int32 instructions on the device; n_uniform /
// n_lane: the words of a resource's N values and the lane words of its
// NI / NIJ values; io: n_io descriptor pointers, then their resource,
// instance and nested strides (elements), then their element widths,
// read here and passed by value; N resources, I instances (<= 32), J
// nested instances.
extern "C" int class_fold(const void* code, int n_instr, int n_uniform,
                          int n_lane, const long long* io, int n_io,
                          long long N, int I, int J, void* stream) {
  if (n_io < 0 || n_io > kMaxIO || n_instr < 0 || n_uniform < 0 ||
      n_lane < 0 || N < 0 || I < 1 || I > 32 || J < 0)
    return (int)cudaErrorInvalidValue;
  int log2g = 0;
  while ((1 << log2g) < I) ++log2g;
  const int per = 32 >> log2g;
  const long long per_warp = 4LL * (per * n_uniform + 32LL * n_lane);
  if (per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  Io P = {};
  for (int d = 0; d < n_io; ++d) {
    P.p[d] = (const void*)io[d];
    P.sn[d] = io[n_io + d];
    P.si[d] = (int)io[2 * n_io + d];
    P.sj[d] = (int)io[3 * n_io + d];
    P.w[d] = (int)io[4 * n_io + d];
    if (P.w[d] != 1 && P.w[d] != 4) return (int)cudaErrorInvalidValue;
  }
  if (N == 0 || n_instr == 0) return 0;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        class_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  // as many warps a block as keep a block's slots within 48 KB (an SM
  // then holds several blocks), at least one
  int warps = per_warp > 0 ? (int)((48 * 1024) / per_warp) : kMaxWarps;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const long long warp_n = (N + per - 1) / per;
  const long long blocks = (warp_n + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  class_fold_kernel<<<(unsigned)blocks, warps * 32, warps * per_warp,
                      (cudaStream_t)stream>>>(
      (const int4*)code, n_instr, n_uniform, n_lane, P, N, I, J, log2g);
  return (int)cudaGetLastError();
}
