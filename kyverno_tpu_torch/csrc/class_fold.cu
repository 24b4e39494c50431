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
// group of G lanes per resource n, G in {1, 2, 4, 8, 16, 32} picked by
// the host for each launch (kernels.fold_lanes: one for a tape of N
// values alone, an instance a lane for a tape with NIJ values, else the
// fewest lanes that keep enough warps resident), so a warp serves
// 32 / G resources; lane g
// of the group holds IPL = ceil(I / G) rounded up to a power of two
// consecutive instances g * IPL .. g * IPL + IPL - 1 of an NI value (the
// template argument; those >= I are padding, read from nowhere and false
// in every fold) and their J entries of an NIJ value. So an
// instruction's decode is paid once for IPL elements. Values live in the
// warp's slice of shared memory, laid out [word][lane] so a warp's
// accesses never conflict: an N value in one word a lane (every lane of
// a group computes it and keeps its own copy, so no lane waits on
// another's reads: no barrier), NI and NIJ values in IPL words a lane
// for each of the compiler's lane units (an NI value one unit, an NIJ
// value J). An elementwise step reads all of a run of its words before
// it writes any. Reductions over instances (any, all, the prefix ORs of
// foreach) fold the lane's instances in the thread, then join the
// group's lanes by a ballot cut to the group's bits (none at G = 1);
// over J, loops. Registers bound the resident warps: an instantiation
// takes up to 128 registers a thread (16 warps an SM), as
// kernels.fold_lanes assumes; a cap of 64 spilled and ran slower on
// an H100 (PERF.md). A block stages the code in shared memory once,
// so the next instruction's fetch, on the interpreter's critical path,
// is a shared-memory read that the data streaming through L1 cannot
// evict (global reads in place when it would not fit).
//
// Instructions, an int4 each: {op | kind << 8 | f << 16, a, b, c}, kind
// being the result's (any/all read the kind one deeper, expand reads N)
// and f the result's slot unless noted:
//   LOAD   a group of f values read together: the next f rows are
//          {kind, slot, descriptor, element bytes} (N and NI values)
//   LOADJ  f <- descriptor a of b-byte elements (an NIJ value)
//   CONST  f <- a                     NOT f <- !a
//   AND / OR f <- a && b / a || b    EQC / NEC f <- a == b / a != b
//   EQ     f <- a == b (two values)   WHERE f <- a ? b : c
//   FNP    f <- a != 0 ? a : b (a step of the first-non-pass fold)
//   ANY / ALL f <- any / all over the last axis of a
//   EXPAND f <- a (N -> NI)           SCAN / SCANX f <- prefix OR over
//                                       instances, inclusive / exclusive
//   STORE  descriptor b of c-byte elements <- a
// A load group starts its reads (up to 32 values a lane) before it
// writes any slot, so a warp waits on global memory once a batch, not
// once a value; a lane reads its IPL instances of an NI input as 16-,
// 8- or 4-byte vectors where the host found the descriptor's instances
// adjacent and every lane's run aligned (vec), one element at a time
// otherwise.
// Descriptors (inputs, then outputs): pointer and element strides
// (resource, instance, nested; 32-bit, checked on the host, the
// resource's offset one 32 x 32 -> 64-bit product), passed by value in
// a __grid_constant__ block, as K10's planes are, so a CUDA-graph
// replay reads the tensors of its capture. A tape with more descriptors
// than the block holds is split by the compiler into launches that hand
// values on through scratch tensors.
//
// Bound: bytes — each input read once and each output written once (a
// dense PSS run's 66 launches read ~0.9 GB of distinct input bytes at
// N = 16,384). The interpreter's cost is instruction throughput and shared-
// memory latency: a warp decodes each of a rule's ~170 instructions
// once for 32 / G resources and IPL elements a lane, so G trades
// decodes (fewer at small G) against resident warps to hide latency
// (more at large G); chip_smoke.py sweeps it. Left: every element of
// every step is a shared-memory read and write (bool values take a
// word each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIO = 128;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMaxWarps = 4;      // warps a block (the host picks 1, 2, 4)
constexpr int kLoadGroup = 8;     // LOAD_GROUP in tpu/fold.py
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

enum Op {
  LOAD, CONST, NOT, AND, OR, EQC, NEC, EQ, WHERE, FNP, ANY, ALL, EXPAND,
  SCAN, SCANX, STORE, LOADJ
};

struct Io {
  const void* p[kMaxIO];
  int sn[kMaxIO];  // elements between resources
  int si[kMaxIO];  // between instances
  int sj[kMaxIO];  // between nested instances
  unsigned char vec[kMaxIO];  // a lane's IPL instances read as vectors
};

__device__ __forceinline__ int ld(const void* p, long long off, int w) {
  return w == 1 ? (int)((const uint8_t*)p)[off] : ((const int32_t*)p)[off];
}

__device__ __forceinline__ void st(void* p, long long off, int w, int v) {
  if (w == 1)
    ((uint8_t*)p)[off] = (uint8_t)(v != 0);
  else
    ((int32_t*)p)[off] = v;
}

__device__ __forceinline__ void bytes4(unsigned x, int* v) {
  v[0] = x & 0xff;
  v[1] = (x >> 8) & 0xff;
  v[2] = (x >> 16) & 0xff;
  v[3] = x >> 24;
}

// a lane's IPL instances of an NI input (w-byte elements) at element
// row + i0 (vectors when the host allowed them and no instance is
// padding); padding instances read nothing and are 0
template <int IPL>
__device__ __forceinline__ void load_lane(const Io& P, int d, int w,
                                          long long row, int i0, int nv,
                                          int (&v)[IPL]) {
  const void* base = P.p[d];
  if (P.vec[d] && nv == IPL) {
    if (w == 4) {
      const int32_t* q = (const int32_t*)base + row + i0;
      if constexpr (IPL >= 4) {
#pragma unroll
        for (int k = 0; k < IPL; k += 4) {
          const int4 x = *(const int4*)(q + k);
          v[k] = x.x;
          v[k + 1] = x.y;
          v[k + 2] = x.z;
          v[k + 3] = x.w;
        }
        return;
      } else if constexpr (IPL == 2) {
        const int2 x = *(const int2*)q;
        v[0] = x.x;
        v[1] = x.y;
        return;
      }
    } else {
      const uint8_t* q = (const uint8_t*)base + row + i0;
      if constexpr (IPL >= 16) {
#pragma unroll
        for (int k = 0; k < IPL; k += 16) {
          const uint4 x = *(const uint4*)(q + k);
          bytes4(x.x, v + k);
          bytes4(x.y, v + k + 4);
          bytes4(x.z, v + k + 8);
          bytes4(x.w, v + k + 12);
        }
        return;
      } else if constexpr (IPL >= 4) {
#pragma unroll
        for (int k = 0; k < IPL; k += 4)
          bytes4(*(const unsigned*)(q + k), v + k);
        return;
      }
    }
  }
  const int si = P.si[d];
#pragma unroll
  for (int k = 0; k < IPL; ++k)
    v[k] = k < nv ? ld(base, row + (long long)((i0 + k) * si), w) : 0;
}

template <int IPL>
__global__ void __launch_bounds__(kMaxWarps * 32, 4)
    class_fold_kernel(const int4* __restrict__ gcode, int n_instr,
                      int n_uniform, int n_lane,
                      const __grid_constant__ Io P, int N, int I, int J,
                      int log2g, int staged) {
  extern __shared__ int4 smem4[];
  // the code, staged once a block (so an instruction's fetch, on the
  // interpreter's critical path, is a shared-memory read that the data
  // streaming through L1 cannot evict), then the warps' values
  const int4* code = gcode;
  if (staged) {
    for (int i = threadIdx.x; i < n_instr; i += blockDim.x)
      smem4[i] = __ldg(gcode + i);
    __syncthreads();
    code = smem4;
  }
  int* const smem = (int*)(smem4 + (staged ? n_instr : 0));
  // entries of a load batch: up to 32 values a lane in registers
  constexpr int kB = IPL >= 8 ? 32 / IPL : kLoadGroup;
  constexpr int kU = IPL * 32;  // words of a lane unit in the warp
  constexpr int kRun = IPL >= 16 ? IPL : 16;  // an NIJ step's words a run
  const int G = 1 << log2g;
  const int per = 32 >> log2g;  // resources a warp
  const bool solo = G == 1;     // a lane a resource: no ballot
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> log2g, gl = lane & (G - 1);
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * per;
  if (first >= N) return;  // whole warps leave together
  // a lane group past N computes on the last resource and stores nothing
  const bool live = first + grp < N;
  const int n = live ? (int)(first + grp) : N - 1;
  int* const W = smem + warp * 32 * (n_uniform + IPL * n_lane) + lane;
  int* const U = W;                   // N word u at U[u * 32]
  int* const L = W + 32 * n_uniform;  // lane word w at L[w * 32]
  const int i0 = gl * IPL;
  const int nv = max(0, min(IPL, I - i0));  // the lane's real instances
  const unsigned gshift = (unsigned)(grp << log2g);
  const unsigned gmask = G == 32 ? kFull : (1u << G) - 1u;
  int4 h = code[0];
  for (int pc = 0; pc < n_instr;) {
    const int op = h.x & 0xff, kind = (h.x >> 8) & 0xff;
    const int f = (int)((unsigned)h.x >> 16);
    const int a = h.y, b = h.z, c = h.w;
    // the next instruction's read overlaps this one's work
    const int npc = pc + 1 + (op == LOAD ? f : 0);
    const int4 nh = npc < n_instr ? code[npc] : h;
    // the result's slot, and the operands' (of the result's kind)
    int* const D = kind == 0 ? U + f * 32 : L + f * kU;
    const int* const A = kind == 0 ? U + a * 32 : L + a * kU;
    const int* const B = kind == 0 ? U + b * 32 : L + b * kU;
    const int* const C = kind == 0 ? U + c * 32 : L + c * kU;
    int r = 0;
    bool write = false;  // r goes to *D (an N value) after the switch
    // an elementwise op: r for an N result; for an NI or NIJ one, each
    // run of words read into registers, then written (so the reads of a
    // run are in flight together)
    auto elem = [&](auto fn) {
      if (kind == 0) {
        r = fn(0);
        write = true;
      } else if (kind == 1) {
        int x[IPL];
#pragma unroll
        for (int k = 0; k < IPL; ++k) x[k] = fn(k * 32);
#pragma unroll
        for (int k = 0; k < IPL; ++k) D[k * 32] = x[k];
      } else {
        const int words = J * IPL;
        for (int w0 = 0; w0 < words; w0 += kRun) {
          int x[kRun];
#pragma unroll
          for (int k = 0; k < kRun; ++k)
            if (w0 + k < words) x[k] = fn((w0 + k) * 32);
#pragma unroll
          for (int k = 0; k < kRun; ++k)
            if (w0 + k < words) D[(w0 + k) * 32] = x[k];
        }
      }
    };
    switch (op) {
      case LOAD: {
        for (int q0 = 0; q0 < f; q0 += kB) {
          int v[kB][IPL];
#pragma unroll
          for (int q = 0; q < kB; ++q) {
            if (q0 + q < f) {
              const int4 e = code[pc + 1 + q0 + q];
              const long long row = (long long)n * P.sn[e.z];
              if (e.x == 0)
                v[q][0] = ld(P.p[e.z], row, e.w);
              else
                load_lane<IPL>(P, e.z, e.w, row, i0, nv, v[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < kB; ++q) {
            if (q0 + q < f) {
              const int4 e = code[pc + 1 + q0 + q];
              if (e.x == 0) {
                U[e.y * 32] = v[q][0];
              } else {
#pragma unroll
                for (int k = 0; k < IPL; ++k) L[(e.y * IPL + k) * 32] = v[q][k];
              }
            }
          }
        }
        break;
      }
      case LOADJ: {
        constexpr int kJ = IPL >= 32 ? 1 : 32 / IPL;  // entries a batch
        const long long row = (long long)n * P.sn[a];
        const int si = P.si[a], sj = P.sj[a];
        const void* p = P.p[a];
        for (int j0 = 0; j0 < J; j0 += kJ) {
          int v[kJ][IPL];
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
            for (int k = 0; k < IPL; ++k)
              v[jj][k] = (j0 + jj < J && k < nv)
                             ? ld(p, row + (long long)((i0 + k) * si +
                                                       (j0 + jj) * sj), b)
                             : 0;
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj)
            if (j0 + jj < J) {
#pragma unroll
              for (int k = 0; k < IPL; ++k)
                D[((j0 + jj) * IPL + k) * 32] = v[jj][k];
            }
        }
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
      case ALL: {
        const bool any = op == ANY;
        const int* const S = L + a * kU;  // the source, one kind deeper
        if (kind == 0) {  // NI -> N: the lane's instances, then the group's
          bool v = !any;
#pragma unroll
          for (int k = 0; k < IPL; ++k) {
            if (k < nv) {
              const bool x = S[k * 32] != 0;
              v = any ? (v || x) : (v && x);
            }
          }
          if (solo) {
            r = v;
          } else {
            const unsigned m = (__ballot_sync(kFull, v) >> gshift) & gmask;
            r = any ? (m != 0) : (m == gmask);
          }
          write = true;
        } else {  // NIJ -> NI: each instance's J entries
          int x[IPL];
#pragma unroll
          for (int k = 0; k < IPL; ++k) x[k] = !any;
#pragma unroll 4
          for (int j = 0; j < J; ++j) {
#pragma unroll
            for (int k = 0; k < IPL; ++k) {
              const int y = S[(j * IPL + k) * 32] != 0;
              x[k] = any ? (x[k] | y) : (x[k] & y);
            }
          }
#pragma unroll
          for (int k = 0; k < IPL; ++k) D[k * 32] = x[k];
        }
        break;
      }
      case EXPAND: {
        const int x = U[a * 32];
#pragma unroll
        for (int k = 0; k < IPL; ++k) D[k * 32] = x;
        break;
      }
      case SCAN:
      case SCANX: {
        unsigned bits = 0;  // the lane's true instances
#pragma unroll
        for (int k = 0; k < IPL; ++k)
          if (k < nv && A[k * 32] != 0) bits |= 1u << k;
        bool lower = false;  // a true instance in a lower lane of the group
        if (!solo) {
          const unsigned m =
              (__ballot_sync(kFull, bits != 0) >> gshift) & gmask;
          lower = (m & ((1u << gl) - 1u)) != 0;
        }
#pragma unroll
        for (int k = 0; k < IPL; ++k) {
          const unsigned long long upto =
              op == SCAN ? (2ull << k) - 1ull : (1ull << k) - 1ull;
          D[k * 32] = (int)(lower || (bits & upto) != 0);
        }
        break;
      }
      case STORE: {
        if (!live) break;
        const long long row = (long long)n * P.sn[b];
        void* const p = (void*)P.p[b];
        if (kind == 0) {
          if (gl == 0) st(p, row, c, *A);
        } else {
          const int si = P.si[b], sj = P.sj[b];
#pragma unroll
          for (int k = 0; k < IPL; ++k) {
            if (k < nv) {
              const long long at = row + (long long)((i0 + k) * si);
              if (kind == 1) {
                st(p, at, c, A[k * 32]);
              } else {
                for (int j = 0; j < J; ++j)
                  st(p, at + (long long)(j * sj), c, A[(j * IPL + k) * 32]);
              }
            }
          }
        }
        break;
      }
      default:
        break;
    }
    if (write) *D = r;
    pc = npc;
    h = nh;
  }
}

template <int IPL>
int launch(const int4* code, int n_instr, int n_uniform, int n_lane,
           const Io& P, int N, int I, int J, int log2g, int warps,
           long long per_warp, cudaStream_t stream) {
  // one attribute per instantiation and device
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        class_fold_kernel<IPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const int per = 32 >> log2g;
  const long long warp_n = ((long long)N + per - 1) / per;
  const long long blocks = (warp_n + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the code staged in shared memory when it fits beside the values
  const long long code_bytes = 16LL * n_instr;
  const int staged = code_bytes + warps * per_warp <= kMaxSmem;
  class_fold_kernel<IPL><<<(unsigned)blocks, warps * 32,
                           (size_t)(warps * per_warp +
                                    (staged ? code_bytes : 0)),
                           stream>>>(code, n_instr, n_uniform, n_lane, P, N,
                                     I, J, log2g, staged);
  return (int)cudaGetLastError();
}

}  // namespace

// code: (n_instr, 4) int32 instructions on the device; n_uniform /
// n_lane: the words of a resource's N values and the lane units of its
// NI / NIJ values; io: n_io descriptor pointers, then their resource,
// instance and nested strides (elements, within 32 bits), then their
// vector flags, read here and passed by value; N resources, I instances
// (<= 32), J nested instances; 2^log2g lanes a resource, 2^log2ipl
// instances a lane (2^log2g * 2^log2ipl >= I), warps a block.
extern "C" int class_fold(const void* code, int n_instr, int n_uniform,
                          int n_lane, const long long* io, int n_io,
                          long long N, int I, int J, int log2g, int log2ipl,
                          int warps, void* stream) {
  if (n_io < 0 || n_io > kMaxIO || n_instr < 0 || n_uniform < 0 ||
      n_lane < 0 || N < 0 || N > 0x7fffffffLL || I < 1 || I > 32 || J < 0 ||
      log2g < 0 || log2g > 5 || log2ipl < 0 || log2ipl > 5 ||
      (1 << (log2g + log2ipl)) < I || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const long long per_warp = 4LL * 32 * (n_uniform + (1LL << log2ipl) * n_lane);
  if (warps * per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  Io P = {};
  for (int d = 0; d < n_io; ++d) {
    const long long sn = io[n_io + d], si = io[2 * n_io + d],
                    sj = io[3 * n_io + d];
    if (sn != (int)sn || si != (int)si || sj != (int)sj)
      return (int)cudaErrorInvalidValue;
    P.p[d] = (const void*)io[d];
    P.sn[d] = (int)sn;
    P.si[d] = (int)si;
    P.sj[d] = (int)sj;
    P.vec[d] = io[4 * n_io + d] != 0;
  }
  if (N == 0 || n_instr == 0) return 0;
  const int4* c = (const int4*)code;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)N;
  switch (log2ipl) {
    case 0:
      return launch<1>(c, n_instr, n_uniform, n_lane, P, n, I, J, log2g,
                       warps, per_warp, s);
    case 1:
      return launch<2>(c, n_instr, n_uniform, n_lane, P, n, I, J, log2g,
                       warps, per_warp, s);
    case 2:
      return launch<4>(c, n_instr, n_uniform, n_lane, P, n, I, J, log2g,
                       warps, per_warp, s);
    case 3:
      return launch<8>(c, n_instr, n_uniform, n_lane, P, n, I, J, log2g,
                       warps, per_warp, s);
    case 4:
      return launch<16>(c, n_instr, n_uniform, n_lane, P, n, I, J, log2g,
                        warps, per_warp, s);
    default:
      return launch<32>(c, n_instr, n_uniform, n_lane, P, n, I, J, log2g,
                        warps, per_warp, s);
  }
}
