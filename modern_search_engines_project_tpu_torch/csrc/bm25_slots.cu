// Slot-layout BM25 scoring kernels of the hybrid query path, for Hopper.
//
// Replaces the TPU kernels in modern_search_engines_project_tpu/retrieval/bm25_pallas.py:
//   mse_bm25_slots             <- _kernel_slots (:190) with its tail _accum_keyed (:165)
//   mse_bm25_slots_udedup_bf16 <- _kernel_slots_udedup (:241), variant "sublane"
//   mse_bm25_slots_udedup_i8   <- _kernel_slots_udedup_i8 (:289), variant "i8"
//   mse_bm25_slots_udedup_acc  <- _kernel_slots_udedup_acc (:380), variant "acc"
//   mse_bm25_slots_udedup_wide_bf16 <- _kernel_slots_udedup_wide (:327), "wide"
//   mse_bm25_slots_udedup_wide_i8   <- the same with i8=True, "wide_i8"
//
// What they compute.  The doc-slot postings are groups of 512 doc columns;
// column c of group g holds one document's postings stacked down its rows
// (term id int32 pad -1, impact f32 pad 0).  For every (query b, column):
//   plain : m = sum_t qtf[b,t] * (term == tids[b,t])       (query pad -1 -> -2)
//   udedup: m = sum_u w[b,u] * (term == uids[u])           (uids pad -2)
//   score = sum_rows m * impact,  count = sum_rows (m > 0)
//   out[b, g*512 + c] = (count > 0 && score >= 0) ? score : -1     ("keyed")
// The output column order is the class-concatenated order of the groups
// (the caller un-permutes it with col_unperm).  The U-dedup TPU kernels
// take m from a (B,U)@(U,COLS) product of a 0/1 match matrix; the real
// uids are distinct, so a posting matches at most one u and m = w[b, u*]
// ("sublane" converts w to bf16 and "i8" to int8 first, as the TPU kernels
// do; both are exact for the small-integer weights dedup_query_terms
// makes).
//
// Bound on this card: bytes.  The function must read each slot's 4-byte
// term id once, the impact of each MATCHED posting (2-6% of them at the
// bench shapes), the group tables and the queries, and write the keyed
// output once.  At the 100k-doc bench index that is 33.8 MB of term ids,
// and with the output (0.4 / 6.4 / 25.7 MB) 0.0104 / 0.0123 / 0.0184 ms at
// B = 1 (T = 8) / 16 (U = 128) / 64 (U = 256) over the published
// 3.35 TB/s (chip_smoke.py counts it from the run's own inputs).  The
// operations, one lookup per real posting and a multiply-add and a compare
// per query per matched posting, stay below that.
//
// Design.  The first kernels walked each doc column row by row, one thread
// a column: a term-id load, then a dependent impact load, each a device-
// memory round trip, over up to 128 rows, with one 4-byte load in flight a
// thread (latency-bound, 7-14x the bound), and the U-dedup kernels read
// and hashed every posting once per 8 queries.  Here one body serves all
// three kernels (and kernels 5-6, below, with folds of their own):
//   * Work items.  An item is 128 columns of one group (a rectangle of the
//     flat row-major stream, since every group starts at a multiple of 512
//     elements).  Blocks of 512 threads are persistent, as many as fit on
//     the card, and walk the items ranked by their group's depth, deepest
//     first (group_order), in snake order (block b takes items b, 2G-1-b,
//     2G+b, ...), so the long items start first and every block gets a like
//     share of rows.  A block stages its item list in shared memory first.
//   * Term ids arrive asynchronously.  One thread keeps a ring of kStages
//     stages of 16 rows x 128 columns filled with TMA boxes of 8 rows of a
//     2-d tensor map over the whole stream ([rows, 512] int32; tma.cuh),
//     each stage completing on its own mbarrier, kLead stages ahead of the
//     stage being looked up.  A group's depth is a multiple of 8 rows, so
//     its last stage copies only its own boxes.
//   * One lookup per posting for the whole block.  Warp w looks up row w of
//     an arrived stage, 4 columns a thread from one 16-byte load, against a
//     bit filter of the block's distinct ids (one bit an id under a hash of
//     its own, 4,096-32,768 bits): most postings match no query term, and
//     their lookup ends there, with one more shared-memory load.  Only a set
//     bit probes the table (uid_table.cuh).  A match overwrites its term id
//     with its position u, sets its row's bit in the column's row mask and
//     starts an asynchronous 4-byte copy of its impact (cp.async) into an
//     impact tile, so only matched impacts are read, all of a stage's
//     together.  The U-dedup kernels look each posting up once for all of
//     the block's queries (up to 64; more in further query chunks, grid
//     blocks of their own), not once per 8.
//   * The fold, kLag stages behind.  Thread (query group qg, column c) reads
//     its column's row mask and visits only the matched rows, in row order:
//     the weight row of u for its QPT queries comes in one to four shared-
//     memory loads, from the U-dedup weights held transposed [U][chunk]
//     (int8 for "i8", bf16 for "sublane"; rows padded to an odd number of
//     16-byte units, so different ids start in different banks) with a bit
//     mask of the queries each id is present in, or from kernel 1's m[u][q]
//     (f32, uid_table::build_query_table, the table kernel 7 builds).
//   * Bits.  Each (query, column) is the f32 sum acc += m * x in ascending
//     row order, m summed over t in slot order (kernel 1) or w cast as the
//     TPU kernel casts it (kernels 2-3), as the first kernels summed it; a
//     row that matches no query adds 0 * x, which changes nothing, so
//     skipping it keeps the bits (kernel 7 equals kernel 1, and kernel 6
//     equals kernels 2-3, bit for bit).
//
// What bounds them now (kernel_times.py, NVIDIA H100 80GB HBM3, 700 W):
// 0.028 ms at B = 1, 0.036 ms at B = 16 / U = 128, 0.057 ms (i8) at
// B = 64 / U = 256: 2.7 / 2.9 / 3.1x the bound.  The term-id stream
// alone takes most of it, short of the card's bandwidth; on top come the
// set-up of the tables and the lookups: each stage is a chain of dependent
// shared-memory loads (term, filter word, probes of a set bit) behind one
// block barrier.  At B = 64 the fold adds most: a warp runs its 16-query body
// once for each matched row of its busiest column, so its lanes wait on
// the one with most matches.  Registers (-Xptxas -v): 55-56 a thread, no
// spills, on every shared-memory branch; the two device-memory branches
// of 64 queries a block (U > 1024, their weights read from w) take 64 and
// spill 68-80 bytes.
//
// Kernel 5 ("acc") computes the TPU kernel's function: per column,
// X[u, col] = the impact of the posting matching id u (at most one a
// column) and P[u, col] = 1, then S = wq @ x1 + wq @ x2 + wq @ x3 (X split
// three ways into bf16) and C = wp @ P with wq = bf16(w[:B]) and
// wp = bf16(w[B:2B]), the presence rows; keyed on (C, S).  Its first design
// (a block per 64 columns, 131 KB of densely cleared split X and P, plain
// dependent loads, WMMA with the weights reloaded from device memory at
// every k-step) took 22x the bound.  Now it shares the streaming front
// above -- items deepest first, the TMA ring, the filter, one lookup per
// posting for 64 queries, impacts of matched postings only -- and replaces
// the fold: X is very sparse (a column matches a few of the U ids), so each
// stage's matches (u, impact) are appended to their column's list in
// shared memory (all query groups of the column, by shared atomics), and
// when the item ends (or a list could not take another stage) the block
// multiplies the lists out with mma.sync m16n8k16.  Warp v builds the B
// fragments of columns [8 v, 8 v + 8) in registers from the lists: a lane
// queues its column's matches that fall on its k rows once, then, for each
// k16 block that some column of the tile matched, makes the bf16 split of
// the ones in that block; its A fragments of wq and wp, packed in fragment
// order by pack_afrag_kernel, are staged in shared memory once a block and
// read with one 16-byte load a lane.  The three parts of S sum apart and
// meet as (S1 + S2) + S3, as in the plain version; within a part the
// tensor cores sum over u in another order, so kernel 5 is held to its
// plain version to 1e-5 + 1e-6 |score|, keys equal (at the bench shapes
// its output equals the first design's bit for bit).
//
// What bounds kernel 5 now (kernel_times.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.051 ms at B = 16 / U = 128 and 0.115 ms at B = 64 / U = 256
// (0.136 and 0.392 before), 4.1x and 6.3x the bound.  At 64 queries a
// block it runs one block an SM: 171 KB of shared memory (64 KB of A
// fragments, 32.5 KB of column lists, 66 KB of stream) and ~120 registers
// a thread for the 64 accumulators of S1, S2, S3 and C, so the stream has
// half kernel 3's occupancy.  Per-phase clocks of a throwaway copy at
// B = 64 / U = 256: the products and the item ends take ~45% (issue-bound:
// A-fragment loads, mma.sync and the B fragments' making), the lookups
// ~22%, the gathering ~15%.
//
// Kernel 6 ("wide", "wide_i8") computes the TPU kernel's function: a
// posting row's weights mw = bf16(w[:B]) @ MU (f32 sums) or int8(w[:B]) @ MU
// (s32 sums) with MU the row's 0/1 match matrix against the U ids, then,
// per (query, column) in row order, score += mw * x and count += (mw > 0):
// presence is derived from the weight, as on the TPU.  Its first design
// built MU densely (16 columns a block, 8 rows a step, a 0/1 tile over all
// U ids set, multiplied with WMMA and cleared at every step): 2 B U
// tensor-core operations a slot, 95-145x the bound.  Now it shares the
// streaming front above and multiplies only where there is work.  After a
// stage's lookups, warp v takes the n8 tile of columns [8 v, 8 v + 8); at
// step j the B fragment is the one-hot of the j-th match's u in each column
// of the tile (zero where a column has fewer matches), made in registers,
// and mma.sync (m16n8k16 bf16, or m16n8k32 s8) runs only over the k blocks
// that a column's match falls in.  Each lane's C fragment then holds mw
// for four fixed (query, column) pairs of every m16 tile of the block's
// queries, and the lane folds them in registers.  Its A fragments, w[:B]
// cast as the TPU kernel casts it and packed in fragment order by
// pack_afrag_kernel, are staged in shared memory once a block where they
// fit (at U <= 1024 always), else read from device memory.  A one-hot
// column times a small-integer weight is exact in f32 and in s32, so mw is
// the cast weight itself, and the fold is kernels 2-3's acc += m * x in
// ascending row order: "wide" equals "sublane" and "wide_i8" equals "i8"
// bit for bit.  Bound: bytes, as for kernels 2-3; the tensor-core work is
// one mma.sync per m16 tile of the queries for each (step, k block) that
// holds a match, far below the byte bound.
//
// What bounds kernel 6 now (kernel_times.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.046 ms at B = 16 / U = 128 and 0.082 ms at B = 64 / U = 256
// in bf16 (0.83 / 2.67 ms before; 3.8x and 4.4x the bound), two blocks an
// SM (48-64 registers, no spills; 74 KB / 106 KB of shared memory).
// Per-phase clocks of a throwaway copy: the lookups take what they take in
// kernels 2-3, and the products and fold add 0.7-1.6 as much again: a step
// is one-hot words, a ballot and shuffle per k block, the A loads and
// mma.sync, and the fold of 4 (query, column) pairs a lane and m16 tile,
// whatever the number of the tile's columns that matched, and a warp takes
// as many steps as its busiest column has matches.
//
// Any T and any U.  Kernel 1 builds its chunk's table (16 queries) in
// shared memory up to kMaxT term slots a query; beyond, one small kernel
// builds each chunk's table in device memory first.  Kernels 2-3 keep the
// uid table and their weights in shared memory up to uid_table::kSmemMaxU
// distinct ids (in 16-query chunks when 64 queries' bf16 weights do not
// fit); beyond, the table is the one uid_table::build_global makes and each
// matched posting's weights are read from w.  The filter stays in shared
// memory on every branch.  Shared memory is sized from B, T and U at
// launch: 66 KB of ring, impact tiles and row masks a block, plus the
// filter and the tables.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"
#include "uid_table.cuh"

namespace {

constexpr int kCols = 512;        // doc columns per group (SLOT_COLS)
constexpr int kSliceCols = 128;   // doc columns of one work item
constexpr int kSlices = kCols / kSliceCols;
constexpr int kQGroups = 4;       // query groups of a block
constexpr int kThreads = kSliceCols * kQGroups;
constexpr int kBoxRows = 8;       // rows of one TMA box (depths are multiples of 8)
constexpr int kStageRows = 16;    // rows of one ring stage
constexpr int kStages = 5;        // ring depth
constexpr int kLag = 1;           // stages between a stage's lookup and its fold
constexpr int kImpBufs = kLag + 2;  // impact tiles in use or being freed
constexpr int kLead = kStages - kLag - 1;  // stages in flight ahead of the lookup
constexpr int kMaskBufs = kLag + 3;  // row masks: in use, and one cleared ahead
constexpr int kTile = kStageRows * kSliceCols;  // elements of a stage
static_assert(kThreads / 32 == kStageRows, "a warp looks up one row a stage");
constexpr int kMaxT = 64;         // kernel 1: term slots a query in shared memory
constexpr int kMaxU = uid_table::kSmemMaxU;
constexpr int kPlainQPT = 4;      // kernel 1: 16 queries a block
constexpr int kMaxRounds = 32;    // items a block (the launch sizes G to fit)

// Bytes of one weight row in shared memory: chunk weights rounded up to an
// odd number of 16-byte units, so that the rows of different ids start in
// different bank groups.
__host__ __device__ constexpr int row_bytes(int chunk_bytes) {
  return ((chunk_bytes + 15) / 16 % 2 ? (chunk_bytes + 15) / 16
                                      : (chunk_bytes + 15) / 16 + 1) * 16;
}

// Dynamic shared memory of the ring, the impact tiles and the row masks,
// plus alignment.
constexpr size_t kStreamSmem =
    (size_t)(kStages + kImpBufs) * kTile * 4 + kMaskBufs * kSliceCols * 4 + 128;

// ... and with the filter of a table of 2^bits slots.
inline size_t stream_smem(int bits) {
  return kStreamSmem + uid_table::filter_bytes(bits);
}

__device__ __forceinline__ float keyed(float s, bool present) {
  return (present && s >= 0.f) ? s : -1.f;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tma::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Weight types: f32 m (kernel 1), bf16 ("sublane"), int8 ("i8").  `from` is
// the TPU kernel's cast of w, `get` reads element k of words loaded whole.
template <typename W>
struct Weight;
template <>
struct Weight<float> {
  __device__ static float get(const uint32_t* r, int k) {
    return __uint_as_float(r[k]);
  }
};
template <>
struct Weight<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
  __device__ static float value(__nv_bfloat16 w) { return __bfloat162float(w); }
  __device__ static float get(const uint32_t* r, int k) {
    const uint32_t x = r[k >> 1];
    return __uint_as_float((k & 1) ? (x & 0xffff0000u) : (x << 16));
  }
};
template <>
struct Weight<int8_t> {
  __device__ static int8_t from(float v) { return (int8_t)(int)v; }
  // s8 weight x 0/1 match -> s32 -> f32, exact
  __device__ static float value(int8_t w) { return (float)(int32_t)w; }
  // The same value without a conversion instruction: byte k biased by 128
  // under the exponent of 2^23 reads as 2^23 + 128 + w, exactly.
  __device__ static float get(const uint32_t* r, int k) {
    const uint32_t b = __byte_perm(r[k >> 2] ^ 0x80808080u, 0x4Bu,
                                   0x4550u + (k & 3));
    return __uint_as_float(b) - 8388736.0f;
  }
};

// The n_words 32-bit words at p (16-byte aligned when n_words >= 4).
template <int kWords>
__device__ __forceinline__ void load_words(const void* p,
                                           uint32_t (&r)[kWords]) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      r[4 * k] = v.x, r[4 * k + 1] = v.y, r[4 * k + 2] = v.z,
            r[4 * k + 3] = v.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r[0] = v.x, r[1] = v.y;
  } else {
    static_assert(kWords == 1, "weight rows of 4, 8 or 16k bytes");
    r[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

__device__ __forceinline__ uint32_t bits_of(int8_t w) { return (uint8_t)w; }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 w) {
  return __bfloat16_as_ushort(w);
}

// Store kWords 32-bit words at p (aligned as load_words reads them).
template <int kWords>
__device__ __forceinline__ void store_words(void* p,
                                            const uint32_t (&r)[kWords]) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k)
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
  } else if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = r[0];
  }
}

// ---- kernels 5 ("acc") and 6 ("wide"): the products on the tensor cores ----

// How a block's walk ends in each stage: kernels 1-3 fold weights into
// per-thread sums (kFold); kernel 5 gathers each column's matches and
// multiplies them out with mma.sync at the item's end (kAcc); kernel 6
// multiplies each stage's matches with mma.sync and folds the products in
// registers (kWide).  Kernels 5-6 read their A fragments from shared
// memory (a_smem) or from device memory, through one generic pointer.
constexpr int kFold = 0;
constexpr int kAcc = 1;
constexpr int kWide = 2;
constexpr int kKc = 32;  // kernel 5: matches a column's list holds

// The k depth of one mma.sync: 16 bf16 ids, or 32 int8 ids (kernel 6).
template <typename W, int kProd>
__host__ __device__ constexpr int k_block() {
  return kProd == kWide && sizeof(W) == 1 ? 32 : 16;
}
// A-fragment operands: wq and wp (kernel 5), wq alone (kernel 6).
__host__ __device__ constexpr int n_operands(int prod) {
  return prod == kAcc ? 2 : 1;
}

// The TPU kernel's 3-way bf16 split of x (bm25_pallas.py:434-437):
// x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2).
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16(x);
  const float r1 = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16(r1);
  p[2] = __float2bfloat16(r1 - __bfloat162float(p[1]));
}

// d += a (16 x 16, row-major fragment) @ b (16 x 8, col-major fragment),
// bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// d += a (16 x 32, row-major fragment) @ b (32 x 8, col-major fragment),
// int8 in, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tile(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(d, a, b0, b1);
}
__device__ __forceinline__ void mma_tile(int (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  mma_s8(d, a, b0, b1);
}

// The A operands of kernels 5-6 in fragment order: for m16 tile mt of the
// padded queries and k block kb of the ids (K = 16 bf16 or 32 int8 ids),
// lane l's four words of the mma.sync A fragment at
// afrag[(mt * KB + kb) * 32 + l] -- W(w[q, u]) for wq (rows [0, B)), then,
// for kernel 5, Mt * KB * 32 entries on, W(w[B + q, u]) for wp; zero past B
// and U, W the TPU kernel's cast.  Word r of lane l holds the 4 / sizeof(W)
// ids u, u + 1, ... of query q (the first in the low bits) with
// q = mt * 16 + l / 4 + 8 (r & 1), u = kb * K + (K / 8) (l % 4) + (K / 2) (r >> 1).
template <typename W>
__global__ void pack_afrag_kernel(const float* __restrict__ w, int B, int U,
                                  int KB, int Mt, int n_ops,
                                  uint32_t* __restrict__ dst) {
  constexpr int kPer = 4 / (int)sizeof(W);  // ids a word
  constexpr int K = 8 * kPer;
  const int64_t per = (int64_t)Mt * KB * 128;  // words of one operand
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_ops * per; i += (int64_t)gridDim.x * blockDim.x) {
    const int op = (int)(i / per);
    const int64_t j = i - op * per;
    const int r = (int)(j & 3), l = (int)((j >> 2) & 31);
    const int64_t tile = j >> 7;
    const int mt = (int)(tile / KB), kb = (int)(tile - (int64_t)mt * KB);
    const int q = mt * 16 + l / 4 + 8 * (r & 1);
    const int u = kb * K + kPer * (l % 4) + (K / 2) * (r >> 1);
    const float* row = w + (int64_t)(op * B + q) * U;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float v = q < B && u + e < U ? row[u + e] : 0.f;
      word |= bits_of(Weight<W>::from(v)) << (8 * (int)sizeof(W) * e);
    }
    dst[i] = word;
  }
}

// One work item of a block: its group, the group's depth and first row in
// the stream, and the first column of the item.
struct Item {
  int g, rows, row0, col0;
};

// Where a walk stands: round k of the block's items (s_items[k]) and the
// first row of the current stage.
struct Cursor {
  int k, r0;
};

// One body for the five kernels.  kPlain: kernel 1 (qids = tids [B, n],
// qw = qtf [B, n], weights m from the chunk's query table, f32); otherwise
// kernels 2-3 (qids = uids [n], qw = w [2B, n], weights of type W) or,
// kProd = kAcc / kWide, kernel 5 / 6 (A fragments at afrag in
// pack_afrag_kernel's layout, of type W; staged in shared memory when
// a_smem).  kSmem: tables and weights in shared memory; otherwise g_table
// holds the query tables of kernel 1 (chunk c at c * g_stride) or the uid
// table of kernels 2-3 and 5-6, and kernels 2-3 read weights from w.  A
// block takes query chunk blockIdx.x % n_chunks of kQGroups * QPT queries
// and walks every item of the stream.
template <typename W, int QPT, bool kPlain, bool kSmem, int kProd = kFold>
__global__ void __launch_bounds__(kThreads, kProd == kAcc && QPT == 16 ? 1 : 2)
slots_kernel(
    const __grid_constant__ CUtensorMap terms, const float* __restrict__ impact,
    const int64_t* __restrict__ group_off,
    const int32_t* __restrict__ group_rows,
    const int32_t* __restrict__ group_order, int n_items, int n_chunks,
    const int32_t* __restrict__ qids, const float* __restrict__ qw, int B,
    int n, int bits, const int32_t* __restrict__ g_table, int64_t g_stride,
    float* __restrict__ out, int64_t ld_out, const uint4* __restrict__ afrag,
    bool a_smem) {
  constexpr int kChunk = kQGroups * QPT;
  constexpr int kWords = QPT * (int)sizeof(W) / 4;
  // weight row stride: padded in shared memory, kChunk weights in device
  // memory (kernel 1's query tables there)
  constexpr int kRow = kSmem ? row_bytes(kChunk * (int)sizeof(W))
                             : kChunk * (int)sizeof(W);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ Item s_items[kMaxRounds];  // the block's items, in walk order
  __shared__ Cursor s_prod;  // the producer's walk (thread 0)
  __shared__ int s_count;
  const uint32_t raw = tma::smem_u32(smem_raw);
  int32_t* ring = reinterpret_cast<int32_t*>(
      smem_raw + (((raw + 127u) & ~127u) - raw));
  float* ximp = reinterpret_cast<float*>(ring + kStages * kTile);
  // bit r of s_mask[stage % kMaskBufs][c]: row r of column c matched
  uint32_t(*s_mask)[kSliceCols] =
      reinterpret_cast<uint32_t(*)[kSliceCols]>(ximp + kImpBufs * kTile);
  const int fbits = uid_table::filter_bits(bits);
  uint32_t* s_filter = &s_mask[kMaskBufs][0];
  int32_t* s_keys =
      reinterpret_cast<int32_t*>(s_filter + (1 << (fbits - 5)));
  int32_t* s_slots = s_keys + (1 << bits);
  unsigned char* s_w = reinterpret_cast<unsigned char*>(s_slots + (1 << bits));
  // kernels 2-3: bit i of s_pmask[u * kQGroups + qg]: query qg * QPT + i has
  // weight > 0 on id u (after the weights, 16-byte rows)
  uint32_t* s_pmask = reinterpret_cast<uint32_t*>(s_w + (size_t)n * kRow);
  // kernels 5-6, after the filter and the table (kSmem): their A fragments
  // (a_smem; wq's tiles, then kernel 5's wp's), then kernel 5's list of
  // matches for each column (count, ids u, impacts).  Every part starts
  // 16-byte aligned.
  constexpr int kK = k_block<W, kProd>();
  constexpr int kOps = n_operands(kProd);
  const int KB = (n + kK - 1) / kK;            // k blocks of the ids
  const int mt_alloc = (min(kChunk, B) + 15) / 16;  // m16 tiles a block holds
  uint4* s_a = reinterpret_cast<uint4*>(kSmem ? s_slots + (1 << bits) : s_keys);
  int* s_n = reinterpret_cast<int*>(
      s_a + (a_smem ? kOps * mt_alloc * KB * 32 : 0));
  int32_t* s_lu = s_n + kSliceCols;  // a match's id u and its impact
  float* s_lx = reinterpret_cast<float*>(s_lu + kSliceCols * kKc);

  const int tid = threadIdx.x;
  const int col = tid % kSliceCols, qg = tid / kSliceCols;
  const int chunk = blockIdx.x % n_chunks;
  const int q0 = chunk * kChunk;
  const int nq = min(kChunk, B - q0);
  const bool active = qg * QPT < nq;  // this group folds at least one query
  const int G = gridDim.x / n_chunks;  // blocks a chunk
  const int b0 = blockIdx.x / n_chunks;

  // Round k's item: k * G + b0, or k * G + G - 1 - b0 in odd rounds (snake
  // order over the items ranked by depth); the block's items are staged in
  // s_items before the walk starts.
  const int n_rounds = (n_items + G - 1) / G;  // the last may have no item here
  auto round_item = [&](int k) {
    return k * G + ((k & 1) ? G - 1 - b0 : b0);
  };
  auto valid = [&](const Cursor& c) {
    return c.k < n_rounds && round_item(c.k) < n_items;
  };
  auto advance = [&](Cursor& c) {
    c.r0 += kStageRows;
    if (c.r0 >= s_items[c.k].rows) c.k += 1, c.r0 = 0;
  };
  auto stage_rows = [&](const Cursor& c) {
    return max(0, min(kStageRows, s_items[c.k].rows - c.r0));
  };
  // Thread 0: fill ring stage `slot` with the producer's next stage.  A
  // stage of 0 rows (an empty group) expects 0 bytes and completes on the
  // arrival alone.
  auto produce = [&](int slot) {
    Cursor& c = s_prod;
    const Item& it = s_items[c.k];
    const int boxes = (stage_rows(c) + kBoxRows - 1) / kBoxRows;
    const uint32_t bar = tma::smem_u32(&full[slot]);
    tma::mbar_expect_tx(bar, boxes * kBoxRows * kSliceCols * 4);
    for (int i = 0; i < boxes; ++i)
      tma::tma_box(tma::smem_u32(ring + slot * kTile + i * kBoxRows * kSliceCols),
                   &terms, it.col0, it.row0 + c.r0 + i * kBoxRows, bar);
    advance(c);
  };

  // The block's items, and kernel 1's query chunk (in the impact tiles,
  // unused until the first lookup), in one round trip to device memory.
  for (int k = tid; k < n_rounds && k < kMaxRounds; k += kThreads) {
    const int item = round_item(k);
    if (item < n_items) {
      const int g = group_order[item / kSlices];
      s_items[k] = Item{g, group_rows[g], (int)(group_off[g] / kCols),
                        (item % kSlices) * kSliceCols};
    }
  }
  int32_t* s_tids = reinterpret_cast<int32_t*>(ximp);
  float* s_qtf = ximp + kImpBufs * kTile / 2;
  if constexpr (kPlain && kSmem) {
    for (int i = tid; i < nq * n; i += kThreads) {
      s_tids[i] = qids[(int64_t)q0 * n + i];
      s_qtf[i] = qw[(int64_t)q0 * n + i];
    }
  }
  __syncthreads();

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tma::mbar_init(tma::smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_prod = Cursor{0, 0};
    for (int i = 0; i < kLead && valid(s_prod); ++i) produce(i);
  }

  // The block's tables, while the first stages stream in.
  if (kProd != kFold && a_smem) {  // this block's m16 tiles of wq (and wp)
    const int per = ((nq + 15) / 16) * KB * 32;
    const int64_t src0 = (int64_t)(q0 / 16) * KB * 32;
    const int64_t wp_at = (int64_t)((B + 15) / 16) * KB * 32;
    for (int i = tid; i < kOps * per; i += kThreads) {
      const int op = i >= per, j = i - op * per;
      s_a[op * mt_alloc * KB * 32 + j] = afrag[op * wp_at + src0 + j];
    }
  }
  if constexpr (kProd == kAcc)
    for (int i = tid; i < kSliceCols; i += kThreads) s_n[i] = 0;
  const int32_t* keys;
  const int32_t* slots;
  const unsigned char* wrows;  // weight row u at wrows + u * kRow
  if constexpr (kSmem) {
    if constexpr (kPlain) {
      uid_table::build_query_table(s_tids, s_qtf, nq, n, bits, s_keys,
                                   s_slots, reinterpret_cast<float*>(s_w),
                                   kRow / 4, &s_count);  // ends with a barrier
    } else if constexpr (kProd == kFold) {
      // w[:B] transposed into [U][kChunk], cast as the TPU kernel casts it,
      // and the presence masks; the presence rows [B, 2B) are not read:
      // presence is weight > 0.  A thread converts the QPT weights of one
      // (id, query group), reading along the ids (coalesced), and writes
      // them as one vector and the group's mask as one word.
      for (int i = tid; i < n * kQGroups; i += kThreads) {
        const int u = i % n, g = i / n;
        uint32_t r[kWords], pm = 0;
#pragma unroll
        for (int k = 0; k < kWords; ++k) r[k] = 0u;
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const int q = g * QPT + k;
          const float v = q < nq ? qw[(int64_t)(q0 + q) * n + u] : 0.f;
          const W wq = Weight<W>::from(v);
          pm |= (Weight<W>::value(wq) > 0.f ? 1u : 0u) << k;
          r[k * (int)sizeof(W) / 4] |= (uint32_t)bits_of(wq)
                                       << (8 * ((k * (int)sizeof(W)) & 3));
        }
        store_words<kWords>(s_w + (size_t)u * kRow + g * QPT * sizeof(W), r);
        s_pmask[i % n * kQGroups + g] = pm;
      }
      uid_table::build_shared(s_keys, s_slots, qids, n, bits);  // barriers
    } else {
      uid_table::build_shared(s_keys, s_slots, qids, n, bits);  // barriers
    }
    keys = s_keys, slots = s_slots, wrows = s_w;
  } else {
    const int32_t* t = kPlain ? g_table + chunk * g_stride : g_table;
    keys = t, slots = t + (1 << bits);
    wrows = reinterpret_cast<const unsigned char*>(slots + (1 << bits));
  }
  // The filter of the table's ids (uid_table.cuh): most postings match no
  // query term, and their lookup ends at a clear bit.
  for (int i = tid; i < kMaskBufs * kSliceCols; i += kThreads)
    (&s_mask[0][0])[i] = 0u;
  uid_table::build_filter(s_filter, fbits, keys, bits);  // barriers

  // The weights of this thread's QPT queries for distinct id u, and the
  // queries among them whose weight is > 0 (bit i: query qg * QPT + i).
  auto weights = [&](int u, float (&wv)[QPT]) {
    uint32_t pm = 0;
    if constexpr (kSmem || kPlain) {
      uint32_t r[kWords];
      load_words<kWords>(wrows + (size_t)u * kRow + qg * QPT * sizeof(W), r);
#pragma unroll
      for (int i = 0; i < QPT; ++i) wv[i] = Weight<W>::get(r, i);
    } else {
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int q = q0 + qg * QPT + i;
        wv[i] = q < B ? Weight<W>::value(Weight<W>::from(
                            __ldg(qw + (int64_t)q * n + u)))
                      : 0.f;
      }
    }
    if constexpr (kSmem && !kPlain) {
      pm = s_pmask[u * kQGroups + qg];
    } else {
#pragma unroll
      for (int i = 0; i < QPT; ++i) pm |= (wv[i] > 0.f ? 1u : 0u) << i;
    }
    return pm;
  };

  float acc[QPT];
  uint32_t present = 0;  // bit i: query qg * QPT + i matched with m > 0
#pragma unroll
  for (int i = 0; i < QPT; ++i) acc[i] = 0.f;

  // Kernel 5: warp v owns the n8 tile of columns [8 v, 8 v + 8) of the
  // item and, for every m16 tile of the block's queries, the sums
  // S1 = wq @ x1, S2 = wq @ x2, S3 = wq @ x3 and C = wp @ P over it
  // (mma.sync fragments: row q = mt * 16 + lane / 4 + 8 (i >> 1), column
  // 8 v + 2 (lane % 4) + (i & 1) for element i).  The three parts are
  // summed apart, as the TPU kernel and the plain version sum them: a part
  // of an impact times a small-integer weight is exact in f32, and so are
  // the sums of a column's few such products of one part, while the parts
  // together span more bits than f32 holds.
  constexpr int kMt = kChunk / 16;
  const int n_mt = (nq + 15) / 16;
  float S1[kMt][4], S2[kMt][4], S3[kMt][4], C[kMt][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) S1[m][i] = S2[m][i] = S3[m][i] = C[m][i] = 0.f;
  // Add the products of the matches gathered in the column lists.  Lane l
  // builds its B fragments (k = ids, n = columns) from the list of column
  // 8 wp + l / 4: a column holds each id at most once, so a fragment word
  // is a part of the split impact of the one match with that id, or 0,
  // and only the
  // k16 blocks that some column of the tile matched are multiplied.
  auto acc_product = [&]() {
    const int lane = tid % 32, t4 = lane & 3;
    const int c = (tid / 32) * 8 + lane / 4;
    const int n_c = s_n[c];
    const int32_t* cu = s_lu + c * kKc;
    const float* cx = s_lx + c * kKc;
    // This lane's matches: ids on its k rows 2 t4, 2 t4 + 1, 2 t4 + 8 and
    // 2 t4 + 9 of their k16 block, queued as list slots (5 bits each, up
    // to 6; past that the lane rescans its column's list).
    uint32_t queue = 0;
    int n_own = 0;
    for (int e = 0; e < n_c; ++e)
      if (((cu[e] & 7) >> 1) == t4) {
        if (n_own < 6) queue |= (uint32_t)e << (5 * n_own);
        ++n_own;
      }
    const bool many = n_own > 6;
    auto each = [&](auto&& fn) {
      if (!many) {
        uint32_t q = queue;
        for (int i = 0; i < n_own; ++i, q >>= 5) fn((int)(q & 31));
      } else {
        for (int e = 0; e < n_c; ++e)
          if (((cu[e] & 7) >> 1) == t4) fn(e);
      }
    };
    const uint4* aq = a_smem ? s_a : afrag + (int64_t)(q0 / 16) * KB * 32;
    const uint4* ap =
        aq + (a_smem ? (int64_t)mt_alloc : (int64_t)((B + 15) / 16)) * KB * 32;
    for (int kb0 = 0; kb0 < KB; kb0 += 32) {
      uint32_t mine = 0;  // k16 blocks (from kb0) of this lane's matches
      each([&](int e) {
        const int kb = (cu[e] >> 4) - kb0;
        if ((unsigned)kb < 32u) mine |= 1u << kb;
      });
      uint32_t todo = __reduce_or_sync(0xffffffffu, mine);
      while (todo) {
        const int kb = kb0 + __ffs(todo) - 1;
        todo &= todo - 1;
        // B fragment words of x1, x2, x3 and P: word h holds k rows
        // 2 t4 + 8 h (low half) and 2 t4 + 8 h + 1 (high half)
        uint32_t x1a = 0, x1b = 0, x2a = 0, x2b = 0, x3a = 0, x3b = 0;
        uint32_t pa = 0, pb = 0;
        each([&](int e) {
          const int u = cu[e];
          if ((u >> 4) != kb) return;
          const int sh = 16 * (u & 1);
          __nv_bfloat16 x[3];
          split3(cx[e], x);
          const uint32_t x1 = (uint32_t)__bfloat16_as_ushort(x[0]) << sh;
          const uint32_t x2 = (uint32_t)__bfloat16_as_ushort(x[1]) << sh;
          const uint32_t x3 = (uint32_t)__bfloat16_as_ushort(x[2]) << sh;
          if (u & 8) {
            x1b |= x1, x2b |= x2, x3b |= x3, pb |= 0x3f80u << sh;  // bf16 1.0
          } else {
            x1a |= x1, x2a |= x2, x3a |= x3, pa |= 0x3f80u << sh;
          }
        });
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
          if (m < n_mt) {
            const int64_t at = ((int64_t)m * KB + kb) * 32 + lane;
            const uint4 a_q = aq[at], a_p = ap[at];
            mma_bf16(S1[m], a_q, x1a, x1b);
            mma_bf16(S2[m], a_q, x2a, x2b);
            mma_bf16(S3[m], a_q, x3a, x3b);
            mma_bf16(C[m], a_p, pa, pb);
          }
        }
      }
    }
  };

  // Kernel 6: warp v owns the n8 tile of columns [8 v, 8 v + 8) of the
  // item; lane l keeps, for every m16 tile m of the block's queries, the
  // sums of its four C-fragment pairs (query m * 16 + l / 4 + 8 (i >> 1),
  // column 8 v + 2 (l % 4) + (i & 1) for element i) in wsum[m][i], and in
  // bit 4 m + i of wpresent whether the pair matched with weight > 0.
  using WAcc = typename std::conditional<sizeof(W) == 1, int, float>::type;
  constexpr int kWm = kProd == kWide ? kMt : 1;
  float wsum[kWm][4];
  uint32_t wpresent = 0;
#pragma unroll
  for (int m = 0; m < kWm; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) wsum[m][i] = 0.f;
  // Fold stage f's matches: step j takes the j-th matched row of each
  // column of the tile, in row order.  The B fragment (k = ids, n =
  // columns) is the one-hot of each column's id u; lane l sets it for
  // column 8 v + l / 4 where u falls on its k rows of the k block, and
  // the warp multiplies once for each k block that some column's u falls
  // in, so D[m] = W(w[q, u]) for each (query, column) pair, exactly.
  // The A fragments' place is a compile-time flag of the stage body (two
  // bodies, picked by a_smem), so each step reads them with ld.shared or
  // ld.global.nc: a generic load on every step's way to mma.sync cost
  // kernel 6 8% at B = 64 (kernel_times.py, NVIDIA H100 80GB HBM3, 700 W),
  // while kernel 5's products, once an item, keep it.
  auto wide_stage = [&](int f, auto shared) {
    constexpr bool kS = decltype(shared)::value;
    constexpr int kPer = 4 / (int)sizeof(W);  // ids a fragment word
    constexpr uint32_t kOne = sizeof(W) == 1 ? 1u : 0x3f80u;  // s8 / bf16 1
    const int lane = tid % 32, t4 = lane & 3;
    const int cb = (tid / 32) * 8 + lane / 4;  // this lane's B column
    const int32_t* tf = ring + (f % kStages) * kTile + cb;
    const float* xf = ximp + (f % kImpBufs) * kTile + cb;
    uint32_t rows = s_mask[f % kMaskBufs][cb];
    const uint4* a = kS ? s_a : afrag + (int64_t)(q0 / 16) * KB * 32;
    while (__any_sync(0xffffffffu, rows)) {
      // the next matched row of column cb: its id u and impact x (none: -1, 0)
      int kb_own = -1;
      uint32_t b = 0u;  // this lane's one-hot word of the B fragment
      bool upper = false;  // ... in b1 (k rows of the upper half), else b0
      float x = 0.f;
      if (rows) {
        const int r = __ffs(rows) - 1;
        rows &= rows - 1;
        const uint32_t u = (uint32_t)tf[r * kSliceCols];
        x = xf[r * kSliceCols];
        kb_own = (int)(u / kK);
        const uint32_t kk = u % kK;
        upper = kk >= kK / 2;
        if ((kk % (kK / 2)) / kPer == (uint32_t)t4)
          b = kOne << (32 / kPer * (kk % kPer));
      }
      // the impacts of the C fragment's columns 8 v + 2 (lane % 4) + {0, 1}
      const float x0 = __shfl_sync(0xffffffffu, x, 8 * t4);
      const float x1 = __shfl_sync(0xffffffffu, x, 8 * t4 + 4);
      WAcc d[kWm][4];
#pragma unroll
      for (int m = 0; m < kWm; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[m][i] = 0;
      bool pending = kb_own >= 0;
      uint32_t live;
      while ((live = __ballot_sync(0xffffffffu, pending))) {
        const int kb = __shfl_sync(0xffffffffu, kb_own, __ffs(live) - 1);
        const uint32_t bw = pending && kb_own == kb ? b : 0u;
        pending &= kb_own != kb;
#pragma unroll
        for (int m = 0; m < kWm; ++m) {
          if (m < n_mt) {
            const int64_t at = ((int64_t)m * KB + kb) * 32 + lane;
            mma_tile(d[m], kS ? a[at] : __ldg(a + at), upper ? 0u : bw,
                     upper ? bw : 0u);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kWm; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mw = (float)d[m][i];
          wsum[m][i] += mw * ((i & 1) ? x1 : x0);
          wpresent |= (mw > 0.f ? 1u : 0u) << (4 * m + i);
        }
      }
    }
  };
  // Kernel 6 at the item's end: keyed on presence and score >= 0, the
  // lane's two columns of a row in one 8-byte store.
  auto wide_out = [&](const Item& it) {
    const int lane = tid % 32;
    float* o = out + (int64_t)(q0 + lane / 4) * ld_out + (int64_t)it.g * kCols +
               it.col0 + (tid / 32) * 8 + 2 * (lane & 3);
#pragma unroll
    for (int m = 0; m < kWm; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // query m * 16 + lane / 4 + 8 h
        const int i = 2 * h;
        if (m * 16 + lane / 4 + 8 * h < nq)
          *reinterpret_cast<float2*>(o + (int64_t)(m * 16 + 8 * h) * ld_out) =
              make_float2(keyed(wsum[m][i], (wpresent >> (4 * m + i)) & 1u),
                          keyed(wsum[m][i + 1],
                                (wpresent >> (4 * m + i + 1)) & 1u));
        wsum[m][i] = wsum[m][i + 1] = 0.f;
      }
    }
    wpresent = 0;
  };

  Cursor look{0, 0}, fold{0, 0};  // the stage being looked up / folded
  const int lrow = tid / 32, lcol = (tid % 32) * 4;  // lookup: 4 columns
  for (int j = 0;; ++j) {
    if (valid(look)) {  // stage j: matched ids -> positions u, impacts copied
      tma::mbar_wait(tma::smem_u32(&full[j % kStages]), (j / kStages) & 1);
      if (lrow < stage_rows(look)) {
        // Warp w looks up row w of the stage, 4 columns a thread in one
        // 16-byte load.  Only a set filter bit probes the table; a match
        // writes u over its term id, sets its row bit in the column's mask
        // and starts the copy of its impact.
        int32_t* t = ring + (j % kStages) * kTile + lrow * kSliceCols + lcol;
        const int4 v = *reinterpret_cast<const int4*>(t);
        const int32_t term[4] = {v.x, v.y, v.z, v.w};
        uint32_t fb[4], fw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fb[i] = uid_table::filter_bit(term[i], fbits);
          fw[i] = term[i] >= 0 ? s_filter[fb[i] >> 5] : 0u;
        }
        uint32_t pass = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) pass |= ((fw[i] >> (fb[i] & 31)) & 1u) << i;
        if (pass) {
          const Item& it = s_items[look.k];
          const float* src = impact +
                             ((int64_t)it.row0 + look.r0 + lrow) * kCols +
                             it.col0 + lcol;
          float* xs = ximp + (j % kImpBufs) * kTile + lrow * kSliceCols + lcol;
          uint32_t* mask = &s_mask[j % kMaskBufs][lcol];
          do {
            const int i = __ffs(pass) - 1;
            pass &= pass - 1;
            const int32_t tm = i == 0 ? term[0] : i == 1 ? term[1]
                             : i == 2 ? term[2] : term[3];
            const int u = uid_table::lookup(keys, slots, bits, tm);
            if (u >= 0) {
              t[i] = u;
              atomicOr(mask + i, 1u << lrow);
              cp_async4(xs + i, src + i);
            }
          } while (pass);
          // the slot is refilled by TMA (the async proxy) after these writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
      }
      advance(look);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLag) : "memory");
    // Stage j's positions and stage j - kLag's impacts are visible; every
    // thread is done with stage j - kLag - 1, whose ring slot is refilled
    // now (and whose impact tile stage j + 1 takes).
    __syncthreads();
    if (tid == 0 && valid(s_prod)) produce((j + kLead) % kStages);
    // Clear the row masks of stage j + 2: stage j + 2 - kMaskBufs, their
    // last user, was folded before this iteration's barrier, and stage
    // j + 2 is looked up after the next one (kMaskBufs = kLag + 3).
    if (tid < kSliceCols) s_mask[(j + 2) % kMaskBufs][tid] = 0u;
    if (j < kLag) continue;

    // Fold stage f = j - kLag in row order, visiting only the rows of this
    // thread's column that matched.
    const int f = j - kLag;
    const int32_t* t = ring + (f % kStages) * kTile + col;
    const float* xs = ximp + (f % kImpBufs) * kTile + col;
    if constexpr (kProd == kAcc) {
      // Kernel 5: append the stage's matches (u, impact) to their column's
      // list (query group qg takes rows qg, qg + 4, ...; the order within a
      // list does not matter, a column holding each id at most once);
      // multiply the lists out when the item ends or a list could not take
      // another stage, then empty them.
      uint32_t rows = s_mask[f % kMaskBufs][col] & (0x1111u << qg);
      bool full = false;
      while (rows) {
        const int r = __ffs(rows) - 1;
        rows &= rows - 1;
        const int m = atomicAdd(s_n + col, 1);
        s_lu[col * kKc + m] = t[r * kSliceCols];
        s_lx[col * kKc + m] = xs[r * kSliceCols];
        full |= m + 1 > kKc - kStageRows;
      }
      const bool end = fold.r0 + kStageRows >= s_items[fold.k].rows;
      if (__syncthreads_or(end || full)) {
        acc_product();
        if (end) {  // keyed on C > 0 and S >= 0, then the next item from 0
          const Item& it = s_items[fold.k];
          const int lane = tid % 32;
          const int64_t c0 = (int64_t)it.g * kCols + it.col0 + (tid / 32) * 8 +
                             2 * (lane & 3);
#pragma unroll
          for (int m = 0; m < kMt; ++m) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int q = m * 16 + lane / 4 + 8 * (i >> 1);
              if (q < nq)
                out[(int64_t)(q0 + q) * ld_out + c0 + (i & 1)] =
                    keyed((S1[m][i] + S2[m][i]) + S3[m][i], C[m][i] > 0.f);
              S1[m][i] = S2[m][i] = S3[m][i] = C[m][i] = 0.f;
            }
          }
        }
        __syncthreads();  // every list read
        if (qg == 0) s_n[col] = 0;
      }
      advance(fold);
      if (!valid(fold)) break;
      continue;
    }
    if constexpr (kProd == kWide) {
      if (a_smem)
        wide_stage(f, std::true_type{});
      else
        wide_stage(f, std::false_type{});
      if (fold.r0 + kStageRows >= s_items[fold.k].rows) wide_out(s_items[fold.k]);
      advance(fold);
      if (!valid(fold)) break;
      continue;
    }
    if (active) {
      uint32_t rows = s_mask[f % kMaskBufs][col];
      while (rows) {
        const int r = __ffs(rows) - 1;
        rows &= rows - 1;
        const float x = xs[r * kSliceCols];
        float wv[QPT];
        present |= weights(t[r * kSliceCols], wv);
#pragma unroll
        for (int i = 0; i < QPT; ++i) acc[i] += wv[i] * x;
      }
    }
    if (fold.r0 + kStageRows >= s_items[fold.k].rows) {  // item complete
      if (active) {
        const Item& it = s_items[fold.k];
        float* o = out + (int64_t)it.g * kCols + it.col0 + col;
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const int q = q0 + qg * QPT + i;
          if (q < B) o[(int64_t)q * ld_out] = keyed(acc[i], (present >> i) & 1u);
          acc[i] = 0.f;
        }
      }
      present = 0;
    }
    advance(fold);
    if (!valid(fold)) break;
  }
}

// Everything a launch passes but the tensor map and the tables.
struct Args {
  const float* impact;
  const int64_t* group_off;
  const int32_t* group_rows;
  const int32_t* group_order;
  int n_groups;
  const int32_t* qids;
  const float* qw;
  int B, n;
  float* out;
  int64_t ld_out;
};

// The stream's term ids as a 2-d tensor [n_slots / 512 rows, 512] of int32,
// read in boxes of 8 rows x 128 columns; rows past the end read 0.
int encode_stream(CUtensorMap* map, const void* terms, int64_t n_slots) {
  if (n_slots < kCols || n_slots % kCols || n_slots / kCols > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t gdim[2] = {(cuuint64_t)kCols, (cuuint64_t)(n_slots / kCols)};
  const cuuint64_t gstride[1] = {(cuuint64_t)kCols * 4};
  const cuuint32_t box[2] = {kSliceCols, kBoxRows};
  const cuuint32_t estride[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(terms),
             gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Launch one instantiation: as many persistent blocks as fit on the card
// at once (occupancy at launch), G for each query chunk, G at most the
// number of items.
template <typename W, int QPT, bool kPlain, bool kSmem, int kProd = kFold>
int run(const CUtensorMap& map, const Args& a, int bits,
        const int32_t* g_table, int64_t g_stride, size_t smem,
        cudaStream_t s, const uint4* afrag = nullptr, bool a_smem = false) {
  auto kern = slots_kernel<W, QPT, kPlain, kSmem, kProd>;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int chunk = kQGroups * QPT;
  const int n_chunks = (a.B + chunk - 1) / chunk;
  const int n_items = a.n_groups * kSlices;
  int64_t fit = ((int64_t)per_sm * n_sm + n_chunks - 1) / n_chunks;
  // at most kMaxRounds items a block (more blocks than fit at once past that)
  if (fit < (n_items + kMaxRounds - 1) / kMaxRounds)
    fit = (n_items + kMaxRounds - 1) / kMaxRounds;
  const int G = fit < n_items ? (int)fit : n_items;
  if ((int64_t)G * n_chunks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kern<<<G * n_chunks, kThreads, smem, s>>>(
      map, a.impact, a.group_off, a.group_rows, a.group_order, n_items,
      n_chunks, a.qids, a.qw, a.B, a.n, bits, g_table, g_stride, a.out,
      a.ld_out, afrag, a_smem);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_udedup(const void* terms, const Args& a, int64_t n_slots,
                  void* table, int64_t table_len, cudaStream_t s) {
  const int U = a.n;
  if (a.B < 1 || U < 1 || a.n_groups < 1 || (int64_t)a.n_groups > INT_MAX / kSlices)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int rc = encode_stream(&map, terms, n_slots);
  if (rc != 0) return rc;
  bool wide = a.B > 16;  // 64 queries a block, else 16
  if (U <= kMaxU) {
    const int bits = uid_table::table_bits(U);
    // ring and impact tiles, the uid table, the weights [U][chunk] and the
    // presence masks [U][kQGroups]
    auto smem = [&](int chunk) {
      return stream_smem(bits) + ((size_t)8 << bits) +
             (size_t)U * row_bytes(chunk * (int)sizeof(W)) +
             (size_t)U * kQGroups * 4;
    };
    int dev = 0, max_smem = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    // 64 bf16 weights a row of 1,024 ids do not fit: 16-query chunks
    if (wide && smem(64) + 256 > (size_t)max_smem) wide = false;
    return wide ? run<W, 16, false, true>(map, a, bits, nullptr, 0, smem(64), s)
                : run<W, 4, false, true>(map, a, bits, nullptr, 0, smem(16), s);
  }
  const int bits = uid_table::global_bits(U);
  if (table == nullptr || table_len < (int64_t)2 << bits)
    return (int)cudaErrorInvalidValue;
  rc = uid_table::build_global(a.qids, U, (int32_t*)table, bits, s);
  if (rc != 0) return rc;
  const int32_t* t = (const int32_t*)table;
  return wide ? run<W, 16, false, false>(map, a, bits, t, 0, stream_smem(bits), s)
              : run<W, 4, false, false>(map, a, bits, t, 0, stream_smem(bits), s);
}

// Kernels 5 (kProd = kAcc, W = bf16) and 6 (kWide, W = bf16 or int8).
// scratch: their A fragments (pack_afrag_kernel), n_operands * 512 *
// ceil(B / 16) * ceil(U / K) bytes (bm25_slots.weight_scratch_bytes);
// table as for kernels 2-3.  A block takes 64 queries (16 at B <= 16), its
// A fragments in shared memory where they fit there, else read from device
// memory.
template <typename W, int kProd>
int launch_mma(const void* terms, const Args& a, int64_t n_slots, void* table,
               int64_t table_len, void* scratch, int64_t scratch_len,
               cudaStream_t s) {
  const int U = a.n, B = a.B;
  if (B < 1 || U < 1 || a.n_groups < 1 || (int64_t)a.n_groups > INT_MAX / kSlices)
    return (int)cudaErrorInvalidValue;
  constexpr int kK = k_block<W, kProd>(), kOps = n_operands(kProd);
  const int KB = (U + kK - 1) / kK, Mt = (B + 15) / 16;
  if (scratch == nullptr || scratch_len < (int64_t)kOps * Mt * KB * 512)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int rc = encode_stream(&map, terms, n_slots);
  if (rc != 0) return rc;
  const int64_t words = (int64_t)kOps * Mt * KB * 128;
  const int grid = (int)((words + 255) / 256 < 4096 ? (words + 255) / 256 : 4096);
  pack_afrag_kernel<W><<<grid, 256, 0, s>>>(a.qw, B, U, KB, Mt, kOps,
                                            (uint32_t*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const uint4* af = (const uint4*)scratch;
  int dev = 0, max_smem = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const bool smem_table = U <= kMaxU;
  const int bits = smem_table ? uid_table::table_bits(U) : uid_table::global_bits(U);
  const int32_t* t = nullptr;
  if (!smem_table) {
    if (table == nullptr || table_len < (int64_t)2 << bits)
      return (int)cudaErrorInvalidValue;
    rc = uid_table::build_global(a.qids, U, (int32_t*)table, bits, s);
    if (rc != 0) return rc;
    t = (const int32_t*)table;
  }
  // the stream and the filter, the table, the A fragments, kernel 5's lists
  const bool wide = B > 16;  // 64 queries a block, else 16
  const int mt = ((B < 64 ? B : 64) + 15) / 16;  // m16 tiles a block holds
  auto smem = [&](bool frags) {
    return stream_smem(bits) + (smem_table ? (size_t)8 << bits : 0) +
           (frags ? (size_t)kOps * (wide ? mt : 1) * KB * 512 : 0) +
           (kProd == kAcc ? (size_t)kSliceCols * 4 + (size_t)kSliceCols * kKc * 8
                          : 0);
  };
  const bool frags = smem(true) <= (size_t)max_smem;
  const size_t bytes = smem(frags);
  if (smem_table)
    return wide ? run<W, 16, false, true, kProd>(map, a, bits, t, 0, bytes, s, af, frags)
                : run<W, 4, false, true, kProd>(map, a, bits, t, 0, bytes, s, af, frags);
  return wide ? run<W, 16, false, false, kProd>(map, a, bits, t, 0, bytes, s, af, frags)
              : run<W, 4, false, false, kProd>(map, a, bits, t, 0, bytes, s, af, frags);
}

Args make_args(const void* impact, const void* group_off,
               const void* group_rows, const void* group_order, int n_groups,
               const void* qids, const void* qw, int B, int n, void* out,
               int64_t ld_out) {
  return Args{(const float*)impact,    (const int64_t*)group_off,
              (const int32_t*)group_rows, (const int32_t*)group_order,
              n_groups,                (const int32_t*)qids,
              (const float*)qw,        B,
              n,                       (float*)out,
              ld_out};
}

}  // namespace

// Kernel 1.  tables: device-memory scratch of
// ceil(B / 16) * query_table_words(bits, min(B, 16) * T, 16) int32, needed
// only when T > kMaxT (bm25_slots.slots_table_words).
extern "C" int mse_bm25_slots(const void* terms, const void* impact,
                              const void* group_off, const void* group_rows,
                              int n_groups, const void* tids, const void* qtf,
                              int B, int T, void* out, int64_t ld_out,
                              const void* group_order, int64_t n_slots,
                              void* tables, int64_t tables_len, void* stream) {
  if (B < 1 || T < 1 || n_groups < 1 || n_groups > INT_MAX / kSlices)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap map;
  int rc = encode_stream(&map, terms, n_slots);
  if (rc != 0) return rc;
  const Args a = make_args(impact, group_off, group_rows, group_order,
                           n_groups, tids, qtf, B, T, out, ld_out);
  constexpr int chunk = kQGroups * kPlainQPT;
  const int n_ids = (B < chunk ? B : chunk) * T;  // a chunk's term slots
  const int bits = uid_table::table_bits(n_ids);
  const int64_t words = uid_table::query_table_words(bits, n_ids, chunk);
  if (T <= kMaxT)  // the table with weight rows padded (row_bytes)
    return run<float, kPlainQPT, true, true>(
        map, a, bits, nullptr, 0,
        stream_smem(bits) +
            uid_table::query_table_words(bits, n_ids, row_bytes(chunk * 4) / 4) * 4,
        s);
  const int n_chunks = (B + chunk - 1) / chunk;
  if (tables == nullptr || tables_len < words * n_chunks)
    return (int)cudaErrorInvalidValue;
  uid_table::build_query_tables_kernel<<<n_chunks, 256, 0, s>>>(
      (const int32_t*)tids, (const float*)qtf, B, T, chunk, bits,
      (int32_t*)tables, words);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return run<float, kPlainQPT, true, false>(map, a, bits,
                                            (const int32_t*)tables, words,
                                            stream_smem(bits), s);
}

// Kernels 2 and 3.  table: the device-memory uid table (2 << global_bits(U)
// int32), needed only when U > kMaxU (bm25_slots.uid_table_scratch).
extern "C" int mse_bm25_slots_udedup_bf16(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, const void* group_order,
    int64_t n_slots, void* table, int64_t table_len, void* stream) {
  return launch_udedup<__nv_bfloat16>(
      terms,
      make_args(impact, group_off, group_rows, group_order, n_groups, uids, w,
                B, U, out, ld_out),
      n_slots, table, table_len, (cudaStream_t)stream);
}

extern "C" int mse_bm25_slots_udedup_i8(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, const void* group_order,
    int64_t n_slots, void* table, int64_t table_len, void* stream) {
  return launch_udedup<int8_t>(
      terms,
      make_args(impact, group_off, group_rows, group_order, n_groups, uids, w,
                B, U, out, ld_out),
      n_slots, table, table_len, (cudaStream_t)stream);
}

// Kernel 5 ("acc").  table: as for kernels 2-3; scratch: its packed A
// fragments (bm25_slots.weight_scratch_bytes).
extern "C" int mse_bm25_slots_udedup_acc(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* table,
    int64_t table_len, const void* group_order, int64_t n_slots,
    void* scratch, int64_t scratch_len, void* stream) {
  return launch_mma<__nv_bfloat16, kAcc>(
      terms,
      make_args(impact, group_off, group_rows, group_order, n_groups, uids, w,
                B, U, out, ld_out),
      n_slots, table, table_len, scratch, scratch_len, (cudaStream_t)stream);
}

// Kernel 6 ("wide", "wide_i8").  table, scratch: as for kernel 5.
extern "C" int mse_bm25_slots_udedup_wide_bf16(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* table,
    int64_t table_len, const void* group_order, int64_t n_slots,
    void* scratch, int64_t scratch_len, void* stream) {
  return launch_mma<__nv_bfloat16, kWide>(
      terms,
      make_args(impact, group_off, group_rows, group_order, n_groups, uids, w,
                B, U, out, ld_out),
      n_slots, table, table_len, scratch, scratch_len, (cudaStream_t)stream);
}

extern "C" int mse_bm25_slots_udedup_wide_i8(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* table,
    int64_t table_len, const void* group_order, int64_t n_slots,
    void* scratch, int64_t scratch_len, void* stream) {
  return launch_mma<int8_t, kWide>(
      terms,
      make_args(impact, group_off, group_rows, group_order, n_groups, uids, w,
                B, U, out, ld_out),
      n_slots, table, table_len, scratch, scratch_len, (cudaStream_t)stream);
}

extern "C" const char* mse_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
