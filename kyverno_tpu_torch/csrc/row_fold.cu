// K12 row_fold: a rule's row-plane logic as one launch.
//
// Replaces the row-plane layer of kyverno_tpu/tpu/evaluator.py that
// jax.jit traces and XLA fuses into the rule's program (build_program.run
// 1937): the 64-bit hash equalities heq / hset (234; B6), type_is (246),
// the leaf and compare predicates (leaf_row_pred 480, _ord_cmp 519,
// _cmp_pred 537), the typed and collect masks of the node and condition
// evaluators (612-708, 1142-1226) and the reductions of Depth0 (437-443)
// and row_any over each resource's rows. The evaluator records that
// logic on a tape (kyverno_tpu_torch/tpu/rowfold.py) and compiles each
// flush of it into a list of instructions; this kernel interprets the
// list for every resource at once and writes only what is read after:
// the reductions (bool any, int32 count per resource) and the planes K3
// and K8 take (bool (N, R)).
//
// Mapping: a value is a bool (N, R) plane. A group of G lanes serves a
// resource, G = ceil(R / 32) rounded up to a power of two (at most 32;
// kernels.row_lanes), so a warp serves 32 / G resources; lane g of the
// group holds rows g * 32 .. g * 32 + 31 as the bits of one word (W
// words for R > 1,024, word w covering rows from w * 32 * G). Every logic
// step is one bitwise operation a word, an any a ballot cut to the
// group's lanes and a count a __popc summed over them by shuffles. An
// instruction's decode, the interpreter's cost, is paid once for 32 / G
// resources. Bits of padding rows (>= R) are 0 in every value:
// compares, constants and NOT mask them. Values live in the warp's slice
// of shared memory, [slot][word][lane] (a lane reads and writes only its
// own words: no barrier); the compiler allocates slots by liveness. A
// block stages the code in shared memory once when it fits beside the
// values. A group past N computes on resource N - 1 and stores nothing.
//
// Instructions, an int4 each: {op | f << 8, a, b, c}:
//   LANE   group over the 4-byte input a of element type b (1 int32, 2
//          float32): the next c rows are compares {cmp | s << 8, k,
//          scale, 0} writing slot s: cmp 0 x != 0, 1 x == k, 2 x != k,
//          3 x > k, 4 x < k; float32 lanes compare x * scale (k and scale
//          float32 bit patterns, the product rounded to float32)
//   HASH   group of f sets over the hash lane pair a (hi) / b (lo), int32:
//          the next c rows are, per set, {n, s, 0, 0} and ceil(n / 2) rows
//          of (hi, lo) constant pairs; slot s <- OR over the pairs of
//          (hi == H && lo == L)
//   CONST  f <- a (0 or 1)      NOT f <- !a      AND / OR f <- a & b / a | b
//   WHERE  f <- a ? b : c
//   ANY    descriptor b (bool (N,)) <- any row of slot a
//   COUNT  descriptor b (int32 (N,)) <- count of rows of slot a
//   STORE  descriptor b (bool (N, R)) <- slot a
//   BATCH  f uint8 / bool lane groups read together, the only path of a
//          1-byte lane (the host checks it: RowCode): the next f rows are
//          {lane descriptor, its compares m, 0, 0}, then the lanes'
//          compares in order (a of them), {cmp | s << 8, k, 0, 0} as
//          LANE's
// A lane group reads its lane once: a lane's 32 rows as 16-byte vectors
// where the host found the descriptor's rows aligned (vec), one element
// at a time otherwise or at the row's end; every compare of the group is
// taken on the values in registers, uint8 lanes four rows to an
// integer operation (SWAR), 4-byte lanes 16 rows at a time (registers:
// 8 blocks of 4 warps an SM). The compiler puts the uint8 lanes (the K6
// masks and type tags, most of a launch's lanes) first, in batches of
// kBatch whose reads are in flight together.
// Descriptors (inputs, then outputs): pointer and resource stride
// (elements; 0 broadcasts one row to every resource; rows adjacent),
// passed by value in a __grid_constant__ block, so a CUDA-graph replay
// reads the tensors of its capture. A flush with more descriptors than
// the block holds is split by the compiler into launches that each
// recompute their cone from the lanes.
//
// Bound: bytes — each lane read once and each output written once (a
// rule's flushes read the few lanes its predicates touch: the type tag,
// the K6 path masks it reduces, a hash lane pair or two). A launch's
// time grows with the lanes it reads, ~4 us a (16,384, 256) uint8 lane
// on an H100, several times that lane's bytes over the device's rate;
// what holds it there is not measured (PERF.md). A first design held
// one resource a warp (at most 32 rows a lane) and decoded every
// instruction once a resource: 1.5x slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIO = 128;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMaxWarps = 4;      // warps a block
constexpr int kBatch = 4;         // uint8 lanes a batch (ROW_FOLD_BATCH)
constexpr unsigned kFull = 0xffffffffu;

enum Op { LANE, HASH, CONST, NOT, AND, OR, WHERE, ANY, COUNT, STORE, BATCH };
enum Cmp { NZ, EQ, NE, GT, LT };
enum Ty { I32 = 1, F32 = 2 };  // a LANE group's 4-byte lane

struct Io {
  const void* p[kMaxIO];
  long long sn[kMaxIO];       // elements between resources
  unsigned char vec[kMaxIO];  // a lane's 32 rows read (written) as vectors
};

// 16 rows r0 .. r0 + 15 of a 4-byte lane (element offset ``off`` of the
// resource's row 0), half of a lane's word; rows >= R read nothing and
// are 0
__device__ __forceinline__ void load16(const void* base, long long off,
                                       int r0, int R, bool vec,
                                       uint32_t (&x)[16]) {
  const uint32_t* q = (const uint32_t*)base + off + r0;
  if (vec && r0 + 16 <= R) {
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      const uint4 v = *(const uint4*)(q + k);
      x[k] = v.x;
      x[k + 1] = v.y;
      x[k + 2] = v.z;
      x[k + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = r0 + k < R ? q[k] : 0u;
}

// the same 32 rows of a 1-byte lane, packed four to a word (row r0 + 4j
// + b in byte b of word j)
__device__ __forceinline__ void load8(const void* base, long long off,
                                      int r0, int R, bool vec,
                                      uint32_t (&x)[8]) {
  const uint8_t* q = (const uint8_t*)base + off + r0;
  if (vec && r0 + 32 <= R) {
    const uint4 a = *(const uint4*)q, b = *(const uint4*)(q + 16);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = r0 + 4 * j + b;
      if (r < R) w |= (uint32_t)q[4 * j + b] << (8 * b);
    }
    x[j] = w;
  }
}

// the top bit of each byte of m as 4 bits: byte b's bit lands at 28 + b,
// every other product term below or above
__device__ __forceinline__ uint32_t bytes_msb(uint32_t m) {
  return ((m & 0x80808080u) * 0x00204081u) >> 28;
}

// the 32 rows' compare bits of a uint8 lane: four rows an instruction
__device__ __forceinline__ uint32_t compare8(const uint32_t (&x)[8], int cmp,
                                             int k0) {
  // a constant outside a byte compares the same for every row
  if (cmp != NZ && (k0 < 0 || k0 > 255)) {
    const bool all = cmp == NE || (cmp == GT && k0 < 0) ||
                     (cmp == LT && k0 > 255);
    return all ? kFull : 0u;
  }
  const uint32_t c4 = cmp == NZ ? 0u : (uint32_t)k0 * 0x01010101u;
  uint32_t bits = 0;
  if (cmp == GT || cmp == LT) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t m = cmp == GT ? __vcmpgtu4(x[j], c4)
                                   : __vcmpltu4(x[j], c4);
      bits |= bytes_msb(m) << (4 * j);
    }
    return bits;
  }
  // == / != / != 0 in plain integer arithmetic (SWAR; the byte-wise
  // __vcmp*4 intrinsics take several instructions each on sm_90): the
  // top bit of each byte of y is set where the byte of x ^ c4 is nonzero
  const uint32_t flip = cmp == EQ ? 0x80808080u : 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t d = x[j] ^ c4;
    const uint32_t y = (((d & 0x7f7f7f7fu) + 0x7f7f7f7fu) | d) ^ flip;
    bits |= bytes_msb(y) << (4 * j);
  }
  return bits;
}

// 16 rows' compare bits of an int32 or float32 lane
__device__ __forceinline__ uint32_t compare16(const uint32_t (&x)[16], int ty,
                                              int cmp, int k0, int k1) {
  uint32_t bits = 0;
  if (ty == F32) {
    const float c = __int_as_float(k0), s = __int_as_float(k1);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float v = __fmul_rn(__uint_as_float(x[k]), s);
      const bool b = cmp == EQ   ? v == c
                     : cmp == NE ? v != c
                     : cmp == GT ? v > c
                     : cmp == LT ? v < c
                                 : v != 0.0f;
      bits |= (uint32_t)b << k;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int v = (int)x[k];
      const bool b = cmp == EQ   ? v == k0
                     : cmp == NE ? v != k0
                     : cmp == GT ? v > k0
                     : cmp == LT ? v < k0
                                 : v != 0;
      bits |= (uint32_t)b << k;
    }
  }
  return bits;
}

// 8 blocks an SM: at most 64 registers a thread
__global__ void __launch_bounds__(kMaxWarps * 32, 8)
    row_fold_kernel(const int4* __restrict__ gcode, int n_instr, int n_slots,
                    const __grid_constant__ Io P, int N, int R, int W,
                    int log2g, int staged) {
  extern __shared__ int4 smem4[];
  const int4* code = gcode;
  if (staged) {
    for (int i = threadIdx.x; i < n_instr; i += blockDim.x)
      smem4[i] = __ldg(gcode + i);
    __syncthreads();
    code = smem4;
  }
  uint32_t* const vals = (uint32_t*)(smem4 + (staged ? n_instr : 0));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = 1 << log2g;
  const int per = 32 >> log2g;  // resources a warp
  const int grp = lane >> log2g, gl = lane & (G - 1);
  const long long first =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * per;
  if (first >= N) return;  // whole warps leave together
  // a group past N computes on the last resource and stores nothing
  const bool out = first + grp < N;
  const long long n = out ? first + grp : N - 1;
  const unsigned gshift = (unsigned)(grp << log2g);
  const unsigned gmask = G == 32 ? kFull : (1u << G) - 1u;
  // slot s, word w at V[(s * W + w) * 32]
  uint32_t* const V = vals + (size_t)warp * n_slots * W * 32 + lane;
  // the lane's first row in word w, and the bits of its rows below R
  auto row0 = [&](int w) -> int { return (w * G + gl) * 32; };
  auto live = [&](int w) -> uint32_t {
    const int left = R - row0(w);
    return left <= 0 ? 0u : left >= 32 ? kFull : (1u << left) - 1u;
  };
  int4 h = code[0];
  for (int pc = 0; pc < n_instr;) {
    const int op = h.x & 0xff;
    const int f = (int)((unsigned)h.x >> 8);
    // the next instruction's read overlaps this one's work
    const int npc = pc + 1 + (op == LANE || op == HASH ? h.w
                              : op == BATCH        ? f + h.y
                                                   : 0);
    const int4 nh = npc < n_instr ? code[npc] : h;
    switch (op) {
      case LANE: {
        const int d = h.y, ty = h.z, m = h.w;
        const long long off = n * P.sn[d];
        for (int w = 0; w < W; ++w) {
          const uint32_t mask = live(w);
          // a half word at a time
          for (int half = 0; half < 2; ++half) {
            uint32_t x[16];
            load16(P.p[d], off, row0(w) + 16 * half, R, P.vec[d], x);
            for (int q = 0; q < m; ++q) {
              const int4 e = code[pc + 1 + q];
              uint32_t* const dst =
                  V + ((int)((unsigned)e.x >> 8) * W + w) * 32;
              const uint32_t b =
                  (compare16(x, ty, e.x & 0xff, e.y, e.z) << (16 * half)) &
                  mask;
              *dst = half ? *dst | b : b;
            }
          }
        }
        break;
      }
      case BATCH: {
        const int4* const ld = code + pc + 1;  // the lanes
        for (int w = 0; w < W; ++w) {
          const uint32_t mask = live(w);
          uint32_t x[kBatch][8];
#pragma unroll
          for (int l = 0; l < kBatch; ++l) {
            if (l < f) {
              const int d = ld[l].x;
              load8(P.p[d], n * P.sn[d], row0(w), R, P.vec[d], x[l]);
            }
          }
          const int4* e = ld + f;  // the compares, lane by lane
#pragma unroll
          for (int l = 0; l < kBatch; ++l) {
            if (l < f) {
              for (int q = 0; q < ld[l].y; ++q, ++e)
                V[((int)((unsigned)e->x >> 8) * W + w) * 32] =
                    compare8(x[l], e->x & 0xff, e->y) & mask;
            }
          }
        }
        break;
      }
      case HASH: {
        const long long offh = n * P.sn[h.y], offl = n * P.sn[h.z];
        for (int w = 0; w < W; ++w) {
          const uint32_t mask = live(w);
          for (int half = 0; half < 2; ++half) {
            uint32_t hi[16], lo[16];
            const int r0 = row0(w) + 16 * half;
            load16(P.p[h.y], offh, r0, R, P.vec[h.y], hi);
            load16(P.p[h.z], offl, r0, R, P.vec[h.z], lo);
            for (int q = pc + 1; q < npc;) {
              const int4 e = code[q];
              const int cnt = e.x;
              uint32_t bits = 0;
              for (int j = 0; j < cnt; ++j) {
                const int4 pr = code[q + 1 + (j >> 1)];
                const uint32_t H = (uint32_t)((j & 1) ? pr.z : pr.x);
                const uint32_t L = (uint32_t)((j & 1) ? pr.w : pr.y);
#pragma unroll
                for (int k = 0; k < 16; ++k)
                  bits |= (uint32_t)((hi[k] == H) & (lo[k] == L)) << k;
              }
              uint32_t* const dst = V + (e.y * W + w) * 32;
              const uint32_t b = (bits << (16 * half)) & mask;
              *dst = half ? *dst | b : b;
              q += 1 + ((cnt + 1) >> 1);
            }
          }
        }
        break;
      }
      case CONST:
        for (int w = 0; w < W; ++w) V[(f * W + w) * 32] = h.y ? live(w) : 0u;
        break;
      case NOT:
        for (int w = 0; w < W; ++w)
          V[(f * W + w) * 32] = ~V[(h.y * W + w) * 32] & live(w);
        break;
      case AND:
        for (int w = 0; w < W; ++w)
          V[(f * W + w) * 32] = V[(h.y * W + w) * 32] & V[(h.z * W + w) * 32];
        break;
      case OR:
        for (int w = 0; w < W; ++w)
          V[(f * W + w) * 32] = V[(h.y * W + w) * 32] | V[(h.z * W + w) * 32];
        break;
      case WHERE:
        for (int w = 0; w < W; ++w) {
          const uint32_t c = V[(h.y * W + w) * 32];
          V[(f * W + w) * 32] =
              (c & V[(h.z * W + w) * 32]) | (~c & V[(h.w * W + w) * 32]);
        }
        break;
      case ANY: {
        uint32_t v = 0;
        for (int w = 0; w < W; ++w) v |= V[(h.y * W + w) * 32];
        const unsigned b = (__ballot_sync(kFull, v != 0u) >> gshift) & gmask;
        if (out && gl == 0) ((uint8_t*)P.p[h.z])[n * P.sn[h.z]] = b != 0u;
        break;
      }
      case COUNT: {
        int c = 0;
        for (int w = 0; w < W; ++w) c += __popc(V[(h.y * W + w) * 32]);
        for (int o = G >> 1; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
        if (out && gl == 0) ((int32_t*)P.p[h.z])[n * P.sn[h.z]] = c;
        break;
      }
      case STORE: {
        if (out) {
          uint8_t* const base = (uint8_t*)P.p[h.z] + n * P.sn[h.z];
          for (int w = 0; w < W; ++w) {
            const uint32_t v = V[(h.y * W + w) * 32];
            const int r0 = row0(w);
            if (P.vec[h.z] && r0 + 32 <= R) {
              // row r0 + 4j + b's bit to byte b of word j: a nibble
              // spread to the low bits of four bytes
              uint32_t u[8];
#pragma unroll
              for (int j = 0; j < 8; ++j)
                u[j] = (((v >> (4 * j)) & 0xfu) * 0x00204081u) & 0x01010101u;
              *(uint4*)(base + r0) = make_uint4(u[0], u[1], u[2], u[3]);
              *(uint4*)(base + r0 + 16) = make_uint4(u[4], u[5], u[6], u[7]);
            } else {
#pragma unroll
              for (int k = 0; k < 32; ++k)
                if (r0 + k < R) base[r0 + k] = (v >> k) & 1u;
            }
          }
        }
        break;
      }
      default:
        break;
    }
    pc = npc;
    h = nh;
  }
}

}  // namespace

// code: (n_instr, 4) int32 instructions on the device; n_slots: the
// value slots a resource keeps; io: n_io descriptor pointers, then their
// resource strides (elements), then their vector flags, read here and
// passed by value; N resources of R rows, 2^log2g lanes a resource
// (2^log2g = min(32, ceil(R / 32) rounded up to a power of two)); warps
// a block.
extern "C" int row_fold(const void* code, int n_instr, int n_slots,
                        const long long* io, int n_io, long long N, int R,
                        int log2g, int warps, void* stream) {
  static bool opted_in = false;
  if (n_io < 0 || n_io > kMaxIO || n_instr < 0 || n_slots < 1 || N < 0 ||
      N > 0x7fffffffLL || R < 0 || log2g < 0 || log2g > 5 || warps < 1 ||
      warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const int G = 1 << log2g;
  if (G < 32 && R > 32 * G) return (int)cudaErrorInvalidValue;
  const int W = R > 32 * G ? (R + 32 * G - 1) / (32 * G) : 1;
  const long long per_warp = 4LL * 32 * W * n_slots;
  if (warps * per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  Io P = {};
  for (int d = 0; d < n_io; ++d) {
    P.p[d] = (const void*)io[d];
    P.sn[d] = io[n_io + d];
    P.vec[d] = io[2 * n_io + d] != 0;
  }
  if (N == 0 || n_instr == 0) return 0;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const long long per_block = (long long)warps * (32 >> log2g);
  const long long blocks = (N + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the code staged in shared memory when it fits beside the values
  const long long code_bytes = 16LL * n_instr;
  const int staged = code_bytes + warps * per_warp <= kMaxSmem;
  row_fold_kernel<<<(unsigned)blocks, warps * 32,
                    (size_t)(warps * per_warp + (staged ? code_bytes : 0)),
                    (cudaStream_t)stream>>>((const int4*)code, n_instr,
                                            n_slots, P, (int)N, R, W, log2g,
                                            staged);
  return (int)cudaGetLastError();
}
