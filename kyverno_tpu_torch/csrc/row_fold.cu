// K12 row_fold: a rule's row-plane logic as one launch.
//
// Replaces the row-plane layer of kyverno_tpu/tpu/evaluator.py that
// jax.jit traces and XLA fuses into the rule's program (build_program.run
// 1937): the 64-bit hash equalities heq / hset (234; B6), type_is (246),
// the leaf and compare predicates (leaf_row_pred 480, _ord_cmp 519,
// _cmp_pred 537), the typed and collect masks of the node and condition
// evaluators (612-708, 1142-1226) and the reductions of Depth0 (437-443)
// and row_any over each resource's rows. The evaluator records that
// logic on a tape (kyverno_tpu_torch/tpu/rowfold.py) and compiles the
// rule's flush into a list of instructions; this kernel interprets the
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
// block stages the code in shared memory once when it fits.
//
// Staging: a persistent grid whose blocks read lanes only from shared
// memory (one block's layout: an mbarrier a stage, the code, the
// broadcast rows, the ring of stages, the warps' value slots). A block
// serves tiles of T resources (its warps times 32 / G), looping over
// tiles t = blockIdx.x, + gridDim.x, .... The code reads
// each lane in one load instruction (BATCH, LANE, HASH), so a block
// stages a tile's lanes one fill unit at a time: a BATCH's lanes, a
// LANE's lane, or one lane of a HASH (the host lists the units after the
// code: the load table). A fill is one unit's slabs for one tile; fills
// run in the order the block consumes them, tile by tile, unit by unit,
// through a ring of two stages: at each load step, once every warp is
// done with the earlier fills, the next fills up to two ahead are issued
// into the freed stages and the block waits for the step's own (a HASH's
// two), so the next lane is in flight while the current one is compared. Each lane's slab is
// staged by kind (chosen on the host, kernels.row_fold_plan):
//   SLAB   resource stride R: the tile's T * R elements are adjacent,
//          and one thread copies the 16-byte-aligned span that covers
//          them with one bulk copy (cp.async.bulk, completing on the
//          stage's mbarrier); the data begins (address & 15) bytes in
//   ROWS   any other stride (a view of a wider tensor): each resource's
//          row span, 16-byte-aligned, through cp.async by all threads
//          (one commit group a fill), at a pitch of whole 16 bytes
//   BCAST  stride 0: one row every resource reads, bulk-copied once a
//          block with its first fill into an area of its own
// A stage holds the largest unit (four uint8 lanes or one 4-byte lane a
// resource), not a tile's every lane, so a block of T resources needs
// little shared memory and an SM holds many warps: the interpreter's
// latency is hidden by warps, the lanes' by the fills in flight. T is
// chosen for each launch so the ring, the values and the code fit in
// 227 KB. A tile's every lane staged at once (an earlier
// design) left one to three warps an SM at the dense shape.
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
// A lane group reads its lane's 32 rows from shared memory once: as
// 16-byte vectors where they are aligned (the chunks taken in an order
// rotated by lane, so the eight lanes of a quarter warp hit distinct
// banks), as words or bytes otherwise; every compare of the group is
// taken on the values in registers, uint8 lanes four rows to an integer
// operation (SWAR), 4-byte lanes 16 rows at a time. Outputs go straight
// to device memory: ANY and COUNT a byte or word a resource, STORE 16-
// byte vectors where aligned.
// Descriptors (inputs, then outputs): pointer, resource stride
// (elements), and the staging layout, passed by value in a
// __grid_constant__ block, so a CUDA-graph replay reads the tensors of
// its capture. A flush with more descriptors than the block holds is
// split by the compiler into launches that each recompute their cone
// from the lanes.
//
// Bound: bytes — each lane read once and each output written once.
// There is no matrix product, so no wgmma: the Hopper features that fit
// are the bulk copy, the mbarrier and the 227 KB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxIO = 128;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMaxWarps = 8;      // warps a block
constexpr int kBatch = 4;         // uint8 lanes a batch (ROW_FOLD_BATCH)
constexpr int kStages = 2;        // stages of a block's ring of fills
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

enum Op { LANE, HASH, CONST, NOT, AND, OR, WHERE, ANY, COUNT, STORE, BATCH };
enum Cmp { NZ, EQ, NE, GT, LT };
enum Ty { I32 = 1, F32 = 2 };  // a LANE group's 4-byte lane
enum Kind { SLAB, ROWS, BCAST };  // how an input is staged

struct Io {
  const void* p[kMaxIO];
  long long sn[kMaxIO];       // elements between resources
  int boff[kMaxIO];           // BCAST input: its row's offset in the
                              // broadcast area
  unsigned char es[kMaxIO];   // input: element bytes (1 or 4)
  unsigned char kind[kMaxIO]; // input: Kind
  unsigned char vec[kMaxIO];  // STORE output: 16-byte stores
};

// shared memory layout of a block (kernels.row_fold_plan computes it)
struct Layout {
  int code;    // staged code and load table, or -1
  int bcast;   // broadcast rows
  int stage;   // the ring: stage i at stage + i * stage_bytes
  int stage_bytes;
  int vals;    // the warps' value slots
  int T;       // resources a tile
  int n_units; // fill units a tile (the load table's length)
  int rows;    // some input is staged by cp.async (ROWS)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity ``parity`` to complete; a wait of ~2^32
// cycles (seconds: a copy that never lands) traps, so a fault shows as
// a launch error, not a hung device
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// bytes (a multiple of 16) from 16-byte-aligned global src to shared dst
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all commit groups complete but the newest, with ``one``, or all
__device__ __forceinline__ void cp_async_wait(bool one) {
  if (one)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a span's 16-byte-aligned cover: its first aligned address and bytes
__device__ __forceinline__ void cover(uintptr_t a, long long n,
                                      uintptr_t& lo, uint32_t& bytes) {
  lo = a & ~(uintptr_t)15;
  bytes = (uint32_t)(((a + (uintptr_t)n + 15) & ~(uintptr_t)15) - lo);
}

// an input's slab of a tile in a stage: its bytes (0 for a broadcast
// row, staged apart)
__device__ __forceinline__ int slab_bytes(const Io& P, int d, int T, int R) {
  const int es = P.es[d];
  const int row = ((R * es + 15) & ~15) + 16;  // a ROWS resource's pitch
  return P.kind[d] == SLAB ? ((T * R * es + 15) & ~15) + 16
         : P.kind[d] == ROWS ? T * row
                             : 0;
}

// the descriptors of a fill unit (the load table's entry: a load
// instruction's position, and for a HASH which of its lanes, 1 hi or 2
// lo, 0 both), in the order their slabs lie in the stage: BATCH's
// lanes, LANE's lane, or one of HASH's
__device__ __forceinline__ int unit_lanes(const int4* code, int unit,
                                          int (&d)[kBatch]) {
  const int pc = unit & 0xffffff, part = unit >> 24;
  const int4 h = code[pc];
  const int op = h.x & 0xff;
  if (op == BATCH) {
    const int f = (int)((unsigned)h.x >> 8);
    for (int l = 0; l < f; ++l) d[l] = code[pc + 1 + l].x;
    return f;
  }
  d[0] = part == 2 ? h.z : h.y;
  return 1;
}

// Issue fill ``k`` of the block: unit k % n_units of its tile k /
// n_units, into stage k % kStages (with k == 0 also the broadcast rows):
// the bulk copies by thread 0 on the stage's mbarrier, the cp.async rows
// by all threads, in one commit group.
__device__ void issue(const Io& P, const Layout& L, const int4* code,
                      const int* units, uint8_t* smem, uint64_t* bars,
                      int n_in, int k, int N, int R) {
  const int q = k / L.n_units;
  const long long t = blockIdx.x + (long long)q * gridDim.x;
  uint8_t* const stage = smem + L.stage + (k % kStages) * L.stage_bytes;
  uint64_t* const bar = &bars[k % kStages];
  const long long t0 = t * L.T;
  const int cnt = (int)min((long long)L.T, (long long)N - t0);
  int d[kBatch];
  const int nd = unit_lanes(code, units[k - q * L.n_units], d);
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    uintptr_t lo;
    uint32_t b;
    for (int e = 0; e < nd; ++e) {
      if (P.kind[d[e]] != SLAB) continue;
      const int es = P.es[d[e]];
      cover((uintptr_t)P.p[d[e]] + (uintptr_t)(t0 * R * es),
            (long long)cnt * R * es, lo, b);
      total += b;
    }
    if (k == 0)
      for (int i = 0; i < n_in; ++i)
        if (P.kind[i] == BCAST) {
          cover((uintptr_t)P.p[i], (long long)R * P.es[i], lo, b);
          total += b;
        }
    mbar_expect(bar, total);
    int off = 0;
    for (int e = 0; e < nd; ++e) {
      if (P.kind[d[e]] == SLAB) {
        const int es = P.es[d[e]];
        cover((uintptr_t)P.p[d[e]] + (uintptr_t)(t0 * R * es),
              (long long)cnt * R * es, lo, b);
        bulk_copy(stage + off, (const void*)lo, b, bar);
      }
      off += slab_bytes(P, d[e], L.T, R);
    }
    if (k == 0)
      for (int i = 0; i < n_in; ++i)
        if (P.kind[i] == BCAST) {
          cover((uintptr_t)P.p[i], (long long)R * P.es[i], lo, b);
          bulk_copy(smem + L.bcast + P.boff[i], (const void*)lo, b, bar);
        }
  }
  if (L.rows) {
    int off = 0;
    for (int e = 0; e < nd; ++e) {
      const int dd = d[e], es = P.es[dd];
      if (P.kind[dd] == ROWS) {
        const int pitch = ((R * es + 15) & ~15) + 16, chunks = pitch >> 4;
        for (int i = threadIdx.x; i < cnt * chunks; i += blockDim.x) {
          const int j = i / chunks, c = i - j * chunks;
          uintptr_t lo;
          uint32_t b;
          cover((uintptr_t)P.p[dd] + (uintptr_t)((t0 + j) * P.sn[dd] * es),
                (long long)R * es, lo, b);
          if ((uint32_t)c * 16 < b)
            cp_async16(stage + off + j * pitch + c * 16,
                       (const void*)(lo + (uintptr_t)c * 16));
        }
      }
      off += slab_bytes(P, dd, L.T, R);
    }
    cp_async_commit();
  }
}

// resource j's row 0 of input d in shared memory: its slab at ``off``
// in the stage (tile from t0), or its broadcast row
__device__ __forceinline__ const uint8_t* row_base(const Io& P, int d,
                                                   const uint8_t* stage,
                                                   int off,
                                                   const uint8_t* bcast,
                                                   long long t0, int j,
                                                   int R) {
  const int es = P.es[d];
  const uintptr_t base = (uintptr_t)P.p[d];
  if (P.kind[d] == SLAB)
    return stage + off + ((base + (uintptr_t)(t0 * R * es)) & 15) +
           (size_t)j * R * es;
  if (P.kind[d] == ROWS)
    return stage + off + j * (((R * es + 15) & ~15) + 16) +
           ((base + (uintptr_t)((t0 + j) * P.sn[d] * es)) & 15);
  return bcast + P.boff[d] + (base & 15);
}

// 32 rows of a 1-byte lane at q (``left`` of them below R), packed four
// to a word: row 4j + b in byte b of word j. Aligned, the two 16-byte
// chunks are read in the order ``c`` (a lane's rotation) and x holds
// chunk c first: the caller rotates the compare bits back by 16 * c.
__device__ __forceinline__ int lds8(const uint8_t* q, int left, int c,
                                    uint32_t (&x)[8]) {
  if (left >= 32 && ((uintptr_t)q & 15) == 0) {
    const uint4 a = *(const uint4*)(q + 16 * c);
    const uint4 b = *(const uint4*)(q + 16 * (c ^ 1));
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    return c;
  }
  if (left >= 32 && ((uintptr_t)q & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = ((const uint32_t*)q)[j];
    return 0;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * j + b < left) w |= (uint32_t)q[4 * j + b] << (8 * b);
    x[j] = w;
  }
  return 0;
}

// 16 rows of a 4-byte lane at q (``left`` of them below R). With
// ``fast`` (all 16 rows there, q 16-byte aligned) the four 16-byte
// chunks are read rotated by ``rot``: x[4k ..] holds chunk (k + rot) & 3,
// and the caller rotates the compare bits back by 4 * rot.
__device__ __forceinline__ void lds16(const uint8_t* q, int left, bool fast,
                                      int rot, uint32_t (&x)[16]) {
  if (fast) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 v = *(const uint4*)(q + 16 * ((k + rot) & 3));
      x[4 * k] = v.x, x[4 * k + 1] = v.y, x[4 * k + 2] = v.z,
            x[4 * k + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = k < left ? ((const uint32_t*)q)[k] : 0u;
}

__device__ __forceinline__ uint32_t rot16(uint32_t b, int rot) {
  const int s = 4 * rot;
  return ((b << s) | (b >> (16 - s))) & 0xffffu;
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

// at most 128 registers a thread, two blocks of 8 warps an SM (a cap of
// 64 spilled the lanes' registers of a HASH and a BATCH)
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    row_fold_kernel(const int4* __restrict__ gcode, int n_instr, int n_slots,
                    const __grid_constant__ Io P, int n_in, int N, int R,
                    int W, int log2g, const __grid_constant__ Layout L) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* const bars = (uint64_t*)smem;  // one mbarrier a stage
  const long long tiles = ((long long)N + L.T - 1) / L.T;
  if (blockIdx.x >= tiles) return;  // the host's grid has no such block
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the code, then the load table (the fill units, four an int4 row)
  const int n_rows = n_instr + (L.n_units + 3) / 4;
  const int4* code = gcode;
  if (L.code >= 0) {
    int4* const c4 = (int4*)(smem + L.code);
    for (int i = threadIdx.x; i < n_rows; i += blockDim.x)
      c4[i] = __ldg(gcode + i);
    code = c4;
  }
  const int* const units = (const int*)(code + n_instr);
  __syncthreads();
  uint8_t* const bcast = smem + L.bcast;
  // the fills this block consumes: each of its tiles' units; a stage
  // takes fill f once fill f - kStages is consumed
  const int fills =
      L.n_units * (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  int issued = min(fills, kStages);
  for (int f = 0; f < issued; ++f)
    issue(P, L, code, units, smem, bars, n_in, f, N, R);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = 1 << log2g;
  const int per = 32 >> log2g;  // resources a warp
  const int grp = lane >> log2g, gl = lane & (G - 1);
  const unsigned gshift = (unsigned)(grp << log2g);
  const unsigned gmask = G == 32 ? kFull : (1u << G) - 1u;
  // a quarter warp's eight lanes read eight distinct 16-byte chunks
  const int c8 = (lane >> 2) & 1, rot = lane & 3, flip = (lane >> 2) & 1;
  // slot s, word w at V[(s * W + w) * 32]
  uint32_t* const V =
      (uint32_t*)(smem + L.vals) + (size_t)warp * n_slots * W * 32 + lane;
  // the lane's first row in word w, and the bits of its rows below R
  auto row0 = [&](int w) -> int { return (w * G + gl) * 32; };
  auto live = [&](int w) -> uint32_t {
    const int left = R - row0(w);
    return left <= 0 ? 0u : left >= 32 ? kFull : (1u << left) - 1u;
  };

  int k = 0;  // the fill the next load step reads
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long t0 = t * L.T;
    const int cnt = (int)min((long long)L.T, (long long)N - t0);
    // a group past the tile's end computes on stale rows and stores
    // nothing (every warp runs every step: the steps hold barriers)
    const int j = warp * per + grp;
    const bool out = j < cnt;
    const long long n = t0 + j;
    const uint8_t* stage = smem + L.stage;   // the step's (first) fill
    const uint8_t* stage2 = smem + L.stage;  // a HASH's lo lane
    int4 h = code[0];
    for (int pc = 0; pc < n_instr;) {
      const int op = h.x & 0xff;
      const int f = (int)((unsigned)h.x >> 8);
      // the next instruction's read overlaps this one's work
      const int npc = pc + 1 + (op == LANE || op == HASH ? h.w
                                : op == BATCH        ? f + h.y
                                                     : 0);
      if (op == LANE || op == HASH || op == BATCH) {
        // a load step of u fills (a HASH's two lanes are two): once every
        // warp is done with the fills before k, issue up to fill k + 1
        // into their stages, then wait for fills k .. k + u - 1 (one fill
        // past them is in flight at most)
        const int u = op == HASH ? 2 : 1;
        __syncthreads();
        for (; issued < min(fills, k + kStages); ++issued)
          issue(P, L, code, units, smem, bars, n_in, issued, N, R);
        for (int f = k; f < k + u; ++f)
          mbar_wait(&bars[f % kStages], (uint32_t)(f / kStages) & 1u);
        if (L.rows) {
          cp_async_wait(issued > k + u);
          __syncthreads();
        }
        stage = smem + L.stage + (k % kStages) * L.stage_bytes;
        stage2 = smem + L.stage + ((k + 1) % kStages) * L.stage_bytes;
        k += u;
      }
      const int4 nh = npc < n_instr ? code[npc] : h;
      switch (op) {
        case LANE: {
          const int d = h.y, ty = h.z, m = h.w;
          const uint8_t* const rb =
              row_base(P, d, stage, 0, bcast, t0, j, R);
          for (int w = 0; w < W; ++w) {
            const uint32_t mask = live(w);
            for (int hh = 0; hh < 2; ++hh) {
              const int half = hh ^ flip;
              const int r0 = row0(w) + 16 * half;
              const uint8_t* const q = rb + 4 * r0;
              const bool fast = R - r0 >= 16 && ((uintptr_t)q & 15) == 0;
              uint32_t x[16];
              lds16(q, R - r0, fast, rot, x);
              const int rr = fast ? rot : 0;
              for (int e = 0; e < m; ++e) {
                const int4 c = code[pc + 1 + e];
                uint32_t* const dst =
                    V + ((int)((unsigned)c.x >> 8) * W + w) * 32;
                const uint32_t b =
                    (rot16(compare16(x, ty, c.x & 0xff, c.y, c.z), rr)
                     << (16 * half)) &
                    mask;
                *dst = hh ? *dst | b : b;
              }
            }
          }
          break;
        }
        case BATCH: {
          const int4* const ld = code + pc + 1;  // the lanes
          for (int w = 0; w < W; ++w) {
            const uint32_t mask = live(w);
            const int r0 = row0(w);
            uint32_t x[kBatch][8];
            int cr[kBatch];
            int off = 0;  // the lane's slab in the stage
#pragma unroll
            for (int l = 0; l < kBatch; ++l) {
              if (l < f) {
                const int d = ld[l].x;
                cr[l] = lds8(row_base(P, d, stage, off, bcast, t0, j, R) + r0,
                             R - r0, c8, x[l]);
                off += slab_bytes(P, d, L.T, R);
              }
            }
            const int4* e = ld + f;  // the compares, lane by lane
#pragma unroll
            for (int l = 0; l < kBatch; ++l) {
              if (l < f) {
                for (int q = 0; q < ld[l].y; ++q, ++e) {
                  const uint32_t b = compare8(x[l], e->x & 0xff, e->y);
                  V[((int)((unsigned)e->x >> 8) * W + w) * 32] =
                      __funnelshift_l(b, b, 16 * cr[l]) & mask;
                }
              }
            }
          }
          break;
        }
        case HASH: {
          const uint8_t* const bh =
              row_base(P, h.y, stage, 0, bcast, t0, j, R);
          const uint8_t* const bl =
              row_base(P, h.z, stage2, 0, bcast, t0, j, R);
          for (int w = 0; w < W; ++w) {
            const uint32_t mask = live(w);
            for (int hh = 0; hh < 2; ++hh) {
              const int half = hh ^ flip;
              const int r0 = row0(w) + 16 * half;
              const uint8_t *const qh = bh + 4 * r0, *const ql = bl + 4 * r0;
              const bool fast = R - r0 >= 16 &&
                                (((uintptr_t)qh | (uintptr_t)ql) & 15) == 0;
              uint32_t hi[16], lo[16];
              lds16(qh, R - r0, fast, rot, hi);
              lds16(ql, R - r0, fast, rot, lo);
              const int rr = fast ? rot : 0;
              for (int q = pc + 1; q < npc;) {
                const int4 e = code[q];
                const int cnt2 = e.x;
                uint32_t bits = 0;
                for (int i = 0; i < cnt2; ++i) {
                  const int4 pr = code[q + 1 + (i >> 1)];
                  const uint32_t H = (uint32_t)((i & 1) ? pr.z : pr.x);
                  const uint32_t Lo = (uint32_t)((i & 1) ? pr.w : pr.y);
#pragma unroll
                  for (int r = 0; r < 16; ++r)
                    bits |= (uint32_t)((hi[r] == H) & (lo[r] == Lo)) << r;
                }
                uint32_t* const dst = V + (e.y * W + w) * 32;
                const uint32_t b = (rot16(bits, rr) << (16 * half)) & mask;
                *dst = hh ? *dst | b : b;
                q += 1 + ((cnt2 + 1) >> 1);
              }
            }
          }
          break;
        }
        case CONST:
          for (int w = 0; w < W; ++w)
            V[(f * W + w) * 32] = h.y ? live(w) : 0u;
          break;
        case NOT:
          for (int w = 0; w < W; ++w)
            V[(f * W + w) * 32] = ~V[(h.y * W + w) * 32] & live(w);
          break;
        case AND:
          for (int w = 0; w < W; ++w)
            V[(f * W + w) * 32] =
                V[(h.y * W + w) * 32] & V[(h.z * W + w) * 32];
          break;
        case OR:
          for (int w = 0; w < W; ++w)
            V[(f * W + w) * 32] =
                V[(h.y * W + w) * 32] | V[(h.z * W + w) * 32];
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
          const unsigned b =
              (__ballot_sync(kFull, v != 0u) >> gshift) & gmask;
          if (out && gl == 0) ((uint8_t*)P.p[h.z])[n * P.sn[h.z]] = b != 0u;
          break;
        }
        case COUNT: {
          int c = 0;
          for (int w = 0; w < W; ++w) c += __popc(V[(h.y * W + w) * 32]);
          for (int o = G >> 1; o > 0; o >>= 1)
            c += __shfl_xor_sync(kFull, c, o);
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
                for (int i = 0; i < 8; ++i)
                  u[i] = (((v >> (4 * i)) & 0xfu) * 0x00204081u) &
                         0x01010101u;
                *(uint4*)(base + r0) = make_uint4(u[0], u[1], u[2], u[3]);
                *(uint4*)(base + r0 + 16) =
                    make_uint4(u[4], u[5], u[6], u[7]);
              } else {
#pragma unroll
                for (int i = 0; i < 32; ++i)
                  if (r0 + i < R) base[r0 + i] = (v >> i) & 1u;
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
}

cudaError_t opt_in() {
  static bool opted_in[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (opted_in[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      row_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) opted_in[dev] = true;
  return e;
}

}  // namespace

// the blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
// memory an SM holds at once
extern "C" int row_fold_occupancy(int threads, long long smem, int* blocks,
                                  void* stream) {
  (void)stream;
  if (threads < 1 || threads > kMaxWarps * 32 || smem < 0 ||
      smem > kMaxSmem || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, row_fold_kernel, threads, (size_t)smem);
}

// code: (n_instr, 4) int32 instructions on the device, then the load
// table (plan[9] fill units, four an int4 row); n_slots: the value slots
// a resource keeps; io: for each of n_io descriptors (n_in inputs, then
// outputs) its pointer, then the resource strides (elements), element
// bytes, staging kinds, broadcast-area offsets and vector flags, 6 *
// n_io values read here and passed by value; N resources of R rows,
// 2^log2g lanes a resource (min(32, ceil(R / 32) rounded up to a power
// of two)); plan: warps a block, T, grid, the layout's code / broadcast
// / stage / stage bytes / values offsets, the shared memory in all, the
// fill units a tile and whether an input is staged by cp.async
// (kernels.row_fold_plan).
extern "C" int row_fold(const void* code, int n_instr, int n_slots,
                        const long long* io, int n_io, int n_in, long long N,
                        int R, int log2g, const long long* plan,
                        void* stream) {
  if (n_io < 0 || n_io > kMaxIO || n_in < 0 || n_in > n_io || n_instr < 0 ||
      n_slots < 1 || N < 0 || N > 0x7fffffffLL || R < 1 || log2g < 0 ||
      log2g > 5)
    return (int)cudaErrorInvalidValue;
  const int G = 1 << log2g;
  if (G < 32 && R > 32 * G) return (int)cudaErrorInvalidValue;
  const int W = R > 32 * G ? (R + 32 * G - 1) / (32 * G) : 1;
  const long long warps = plan[0], T = plan[1], grid = plan[2];
  const Layout L = {(int)plan[3], (int)plan[4], (int)plan[5], (int)plan[6],
                    (int)plan[7], (int)T, (int)plan[9], (int)plan[10]};
  const long long tiles = (N + T - 1) / T;
  const long long smem = plan[8];
  if (warps < 1 || warps > kMaxWarps || T != warps * (32 >> log2g) ||
      grid < 1 || grid > 0x7fffffffLL || smem > kMaxSmem || smem < 16 ||
      L.vals + warps * 4LL * 32 * W * n_slots > smem || L.code < -1 ||
      (L.code >= 0 && L.code < 8 * kStages) || L.bcast < 8 * kStages ||
      L.stage + (long long)kStages * L.stage_bytes > L.vals ||
      L.stage % 128 || L.n_units < 0 ||
      (long long)L.n_units * ((tiles + grid - 1) / grid) > 0x7fffffffLL ||
      L.stage_bytes % 128 || L.bcast % 16 ||
      (L.code >= 0 && L.code + 16LL * (n_instr + (L.n_units + 3) / 4) >
                          L.bcast))
    return (int)cudaErrorInvalidValue;
  Io P = {};
  for (int d = 0; d < n_io; ++d) {
    P.p[d] = (const void*)io[d];
    P.sn[d] = io[n_io + d];
    P.es[d] = (unsigned char)io[2 * n_io + d];
    P.kind[d] = (unsigned char)io[3 * n_io + d];
    P.boff[d] = (int)io[4 * n_io + d];
    P.vec[d] = io[5 * n_io + d] != 0;
    if (d < n_in &&
        ((P.es[d] != 1 && P.es[d] != 4) || P.kind[d] > BCAST ||
         P.boff[d] % 16 || (P.kind[d] == SLAB && P.sn[d] != R) ||
         (P.kind[d] == BCAST && P.sn[d] != 0)))
      return (int)cudaErrorInvalidValue;
  }
  if (N == 0 || n_instr == 0) return 0;
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  row_fold_kernel<<<(unsigned)grid, (unsigned)warps * 32, (size_t)smem,
                    (cudaStream_t)stream>>>((const int4*)code, n_instr,
                                            n_slots, P, n_in, (int)N, R, W,
                                            log2g, L);
  return (int)cudaGetLastError();
}
