// Blocked-layout BM25 scoring kernels of the hybrid query path, for Hopper.
//
// Replaces the TPU kernels in modern_search_engines_project_tpu/retrieval/bm25_pallas.py:
//   mse_bm25_blocked        <- _kernel (:48), launched by bm25_score_blocked (:625)
//   mse_bm25_blocked_udedup <- _kernel_udedup (:104), launched by
//                              bm25_score_blocked_udedup (:551)
//
// What they compute.  Row i of the blocked layout holds the postings of
// docs [128i, 128i+128), sorted by doc (a doc's postings in CSR order),
// then pads (term -1, impact 0, local id 0).  For every (query b, doc d):
//   plain : m = sum_t qtf[b,t] * (term == tids[b,t]),  present = m > 0
//   udedup: m = bf16(w[b, u]),  present = bf16(w[B + b, u]) > 0,
//           where uids[u] == term  (m = 0, not present when no u matches)
//   score = sum over d's postings of m * impact,  count = #present
//   out[b, d] = (count > 0 && score >= 0) ? score : -1        ("keyed")
//   out[b, n_docs_pad] = -1                                   (sentinel)
//
// Design.  The TPU reduces postings to docs with a one-hot [pc/8, 128]
// matmul in compensated bf16x2 (~2^-16 relative per posting) and walks a
// row's posting chunks as a sequential grid axis.  Here the reduction is a
// segmented sum over per-doc runs: doc_off[i, j] .. doc_off[i, j+1] is doc
// j's run in row i (doc_off[i, 128] is the row's real count), so pads are
// never read and can never add presence to doc 0.  Every (query, doc)
// score is an f32 sum in posting order -- the order of the slot kernels,
// since both layouts keep a doc's postings in CSR order -- deterministic,
// with no atomics.  1-6% of postings match for a batch of df-drawn queries
// at the bench shape, ~10% when all share the 100 most frequent terms.
//
// Kernel 7.  One block (8 warps) takes one row and a chunk of up to 32
// queries; warps take the row's docs one at a time from a shared counter.
// The 32 lanes of a warp read 32 consecutive postings of the doc
// (coalesced) and look each one up once in a hash table of its query
// chunk's distinct term ids (uid_table.cuh's hash, shared with the slot
// kernels).  A ballot gives the lanes that matched; for each, in lane
// order, the posting's u and impact are broadcast and lane q adds query
// q's m * impact.  The keyed scores of the row go through a shared
// [32, 128] tile and leave as coalesced 512-byte rows.
//
// Kernel 8.  Its first design was kernel 7's walk, one block per (row,
// 32-query chunk): every row's postings streamed once per chunk, every
// block rebuilt the uid table, and each warp step was a chain of dependent
// device-memory loads (term, lookup, ballot, impact) with a 128-byte line
// of weights read from device memory for every match -- latency-bound at
// 7.6x the bound.  Now:
//   * Persistent blocks (512 threads, two an SM) walk rows b0, b0 + G, ...,
//     64 queries a block.  A block stages the uid table, the bit filter
//     (uid_table.cuh) and its queries' bf16 weights (rows of 144 bytes: an
//     odd number of 16-byte units) with presence bit masks in shared memory
//     once (19 KB at U = 128).
//   * A row's real postings [0, doc_off[i, 128]) arrive by bulk copy
//     (tma.cuh) in stages of 2,048 term ids into a 3-stage ring, thread 0
//     keeping the next stages in flight: one pass over each row for the
//     whole batch.
//   * One lookup per posting for all of the block's queries: a thread takes
//     4 postings from one 16-byte load, and the filter ends most lookups.
//   * The matches are appended in posting order to a shared list
//     (u << 14 | position): a prefix count over the block places them, and
//     each match's impact arrives by an asynchronous 4-byte copy that has
//     until the list is folded to land.
//   * The list is folded when the row ends, when it spans 8 stages or when
//     it could not take another stage: thread (doc d, group g) finds d's
//     matches by a binary search of the list's positions and adds
//     fmaf(bf16(w[q, u]), impact) for its 16 queries q0 + 16 g .. + 15
//     over them in posting order, reading only shared memory (two 16-byte
//     loads of weights a match), into sums held in registers across the
//     row; presence is OR-ed from the masks.  So the keyed output is the
//     first design's bit for bit (and slot kernel 2's).  At a row's end
//     each thread writes its doc's scores for its 16 queries.
//
// What bounds kernel 8 now (kernel_times.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.071 ms at B = 64 / U = 128 shared and 0.070 ms on a df-drawn
// B = 64 (0.136 and 0.117 before), 3.9x the bound.  Per-phase clocks of
// throwaway copies put the time in instruction issue at two blocks an SM,
// not in memory: the lookups, the list appends and the folds take about a
// fifth each, the per-block set-up and the row ends most of the rest; the
// ring's waits are under 2%, and the impacts' copies cost ~5% (knocked
// out).  No spills (-Xptxas -v).
//
// Kernel 7's table.  Its first design compared every posting with all
// nq * T term ids of the chunk (~200 shared-memory compares at B = 64,
// T = 8) and rebuilt a matched posting's weight m with a T loop in every
// lane.  Both depend only on the chunk's term ids, so each block now pays
// them once: it builds a table of the chunk's distinct ids (a term shared
// by several queries, or repeated in one, is one entry u) and beside it
// m[u][q] (f32, 32 queries a row, so lane q reads column q with no bank
// conflict), summed in t order as the per-posting loop summed it — the
// scores are the same bits.  Shared memory is sized from nq * T at launch
// (B = 1, T = 8: a 16-slot table and 1 KB of weights); above kSmemIds
// term slots a small kernel
// builds each chunk's table once in device memory instead, a branch
// taken by input size.
//
// Any T and any U: kernel 7 as above; kernel 8's U as in uid_table.cuh.  The
// U-dedup kernel takes a posting's weight w[b, u] and presence w[B + b, u],
// each cast to bf16 as the TPU kernel casts them, from a table that a small
// kernel packs first: one word per (u, b), query-major.  A block copies its
// queries' columns into shared memory when they fit beside the rest
// (udedup_smem), else folding threads read them from that table (64 bytes
// a match and 16 queries); above 64 queries the grid holds a set of blocks
// for each 64-query chunk.
//
// Bound on this card: a 4-byte term id per real posting (pads are never
// read), the row offsets (129 int32 a row, in place of a 4-byte local id per
// slot), a 4-byte impact per matched posting, the queries and the keyed
// output, over 3.35 TB/s; ~33 MB at the 100k-doc bench shape, ~10 us.
// Operations: one table lookup per real posting and a multiply-add and a
// compare per query for each matched posting, which passes that memory
// time at B = 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "tma.cuh"
#include "uid_table.cuh"

namespace {

constexpr int kDocs = 128;  // docs per blocked row (DOC_BLOCK)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQC = 32;     // queries per block: lane q folds query q0 + q
// Kernel 7: a chunk's distinct-id table lives in shared memory when the
// chunk holds at most kSmemIds query term slots (32 queries x T <= 32);
// beyond that it is built once per chunk in device memory.
constexpr int kSmemIds = 1024;
constexpr unsigned kFull = 0xffffffffu;

// int32 words of one chunk's table of kernel 7 (uid_table.cuh): keys, dense
// ids, then m [n_ids][kQC].
__host__ __device__ inline int64_t table_words(int bits, int n_ids) {
  return uid_table::query_table_words(bits, n_ids, kQC);
}

__device__ __forceinline__ float keyed(float s, float c) {
  return (c > 0.f && s >= 0.f) ? s : -1.f;
}

// Next doc of the row for this warp (shared counter), or kDocs when done.
__device__ __forceinline__ int next_doc(int* counter, int lane) {
  int d = 0;
  if (lane == 0) d = atomicAdd(counter, 1);
  return __shfl_sync(kFull, d, 0);
}

// Write the block's [nq, 128] tile of keyed scores as coalesced rows; the
// blocks of row 0 also write their queries' sentinel column.
__device__ __forceinline__ void store_tile(const float (*tile)[kDocs], int nq,
                                           int q0, int row, float* out,
                                           int64_t ld_out, int n_docs_pad) {
  __syncthreads();
  for (int i = threadIdx.x; i < nq * kDocs; i += kThreads) {
    const int q = i / kDocs, c = i - q * kDocs;
    out[(int64_t)(q0 + q) * ld_out + (int64_t)row * kDocs + c] = tile[q][c];
  }
  if (row == 0)
    for (int q = threadIdx.x; q < nq; q += kThreads)
      out[(int64_t)(q0 + q) * ld_out + n_docs_pad] = -1.f;
}

// Kernel 7.  Each real posting is looked up once in its chunk's table of
// distinct query term ids (uid_table::build_query_table; kSmemTable: built
// by the block in shared memory, otherwise by build_query_tables_kernel in
// device memory, read through L1/L2); for each match, in
// lane order, lane q adds m[u][q] * impact.  The walk is kernel 8's, and
// every (query, doc) sum is the same f32 sum in posting order as before.
// Only real postings (term >= 0) are read.
template <bool kSmemTable>
__global__ void __launch_bounds__(kThreads) blocked_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int32_t* __restrict__ doc_off, int p_blk,
    const int32_t* __restrict__ tids, const float* __restrict__ qtf, int B,
    int T, int bits, const int32_t* __restrict__ g_tables, int64_t g_stride,
    float* __restrict__ out, int64_t ld_out, int n_docs_pad) {
  // dynamic: the [min(B, 32), 128] output tile, then (kSmemTable) the table
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_next, s_count;
  float(*s_out)[kDocs] = reinterpret_cast<float(*)[kDocs]>(smem);
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kQC;
  const int nq = min(kQC, B - q0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_next = 0;
  const int32_t* keys;
  const int32_t* slots;
  const float* m;
  if constexpr (kSmemTable) {
    int32_t* k = reinterpret_cast<int32_t*>(smem + min(kQC, B) * kDocs * 4);
    int32_t* sl = k + (1 << bits);
    float* mm = reinterpret_cast<float*>(sl + (1 << bits));
    uid_table::build_query_table(tids + (int64_t)q0 * T,
                                 qtf + (int64_t)q0 * T, nq, T, bits, k, sl,
                                 mm, kQC, &s_count);  // ends with a barrier
    keys = k, slots = sl, m = mm;
  } else {
    keys = g_tables + blockIdx.y * g_stride;
    slots = keys + (1 << bits);
    m = reinterpret_cast<const float*>(slots + (1 << bits));
    __syncthreads();
  }
  const int32_t* r_terms = terms + (int64_t)row * p_blk;
  const float* r_imp = impact + (int64_t)row * p_blk;
  const int32_t* off = doc_off + (int64_t)row * (kDocs + 1);

  for (int d = next_doc(&s_next, lane); d < kDocs;
       d = next_doc(&s_next, lane)) {
    const int end = off[d + 1];
    float s = 0.f, c = 0.f;  // lane q: query q0 + q
    for (int base = off[d]; base < end; base += 32) {
      const int p = base + lane;
      const int u = p < end
                        ? uid_table::lookup(keys, slots, bits, __ldg(r_terms + p))
                        : -1;
      unsigned mask = __ballot_sync(kFull, u >= 0);
      const float x = u >= 0 ? __ldg(r_imp + p) : 0.f;
      while (mask) {  // matched postings, in posting order
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const int uu = __shfl_sync(kFull, u, src);
        const float xx = __shfl_sync(kFull, x, src);
        const float mq = m[uu * kQC + lane];  // 0 past the chunk's queries
        s += mq * xx;
        c += (mq > 0.f) ? 1.f : 0.f;
      }
    }
    if (lane < nq) s_out[lane][d] = keyed(s, c);
  }
  store_tile(s_out, nq, q0, row, out, ld_out, n_docs_pad);
}

// Packed weights of kernel 8: wp[u * ldq + b] holds the bf16 bits of
// w[b, u] in its high half (so the word read as a float is that bf16 value)
// and bit 0 set when bf16(w[B + b, u]) > 0, the presence the TPU kernel
// reads from rows [B, 2B); ldq is B rounded up to kQC, columns b >= B are 0.
__global__ void pack_weights_kernel(const float* __restrict__ w, int U, int B,
                                    int ldq, uint32_t* __restrict__ wp) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= (int64_t)U * ldq) return;
  const int u = (int)(i / ldq), b = (int)(i - (int64_t)u * ldq);
  uint32_t v = 0;
  if (b < B) {
    const __nv_bfloat16 m = __float2bfloat16(w[(int64_t)b * U + u]);
    const __nv_bfloat16 pr = __float2bfloat16(w[(int64_t)(B + b) * U + u]);
    v = ((uint32_t)__bfloat16_as_ushort(m) << 16) |
        (__bfloat162float(pr) > 0.f ? 1u : 0u);
  }
  wp[i] = v;
}

// ---- kernel 8 ----------------------------------------------------------

constexpr int kUThreads = 512;       // 16 warps
constexpr int kUWarps = kUThreads / 32;
constexpr int kStageP = 2048;        // postings of one ring stage, 4 a thread
constexpr int kUStages = 3;          // ring depth
constexpr int kUQ = 64;              // queries a block
constexpr int kQPT = 16;             // queries a folding thread: 4 a doc
constexpr int kMaxRows = 64;         // rows a block (the launch sizes the grid)
constexpr int kList = 4096;          // matches the list holds
constexpr int kPosBits = 14;         // a match: u << 14 | position - base
constexpr int kFoldStages = 8;       // stages a list spans at most
constexpr int kWRow = 144;           // bytes of an id's weights: 64 bf16,
                                     // padded to 9 16-byte units (odd)
static_assert(kStageP == 4 * kUThreads && kUThreads == kDocs * kUQ / kQPT, "");
static_assert(kFoldStages * kStageP <= (1 << kPosBits), "");

// Dynamic shared memory of kernel 8 a block: the ring, the match list
// (entries, impacts), the filter, the uid table (kSmem) and the weights
// (kSmemW: [U][kWRow] bytes of bf16 weights, then 64 presence bits an
// id).  Every part starts 16-byte aligned.
__host__ __device__ inline size_t udedup_smem(int bits, bool table, int U,
                                              bool weights) {
  return (size_t)kUStages * kStageP * 4 + (size_t)kList * 8 +
         uid_table::filter_bytes(bits) + (table ? (size_t)8 << bits : 0) +
         (weights ? (size_t)U * (kWRow + 8) : 0);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tma::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Kernel 8.  Persistent blocks: block b0 of query chunk blockIdx.x %
// n_chunks (kUQ queries from q0) scores rows b0, b0 + G, ... one ring
// stage of kStageP real postings at a time, appending each stage's matches
// to a list that is folded when the row ends, when it spans kFoldStages
// stages or when it could not take another stage; thread (doc d, group g)
// folds doc d's matches for queries q0 + 16 g .. q0 + 16 g + 15 into sums
// held in registers across the row.  kSmem: U <= kSmemMaxU, the uid table
// lives in shared memory; otherwise it is the one build_global made
// (g_table, 2^bits slots).  kSmemW: the weights of the block's queries are
// staged in shared memory; otherwise they are read from wp
// (pack_weights_kernel's table) in device memory.
template <bool kSmem, bool kSmemW>
__global__ void __launch_bounds__(kUThreads, 2) blocked_udedup_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int32_t* __restrict__ doc_off, int n_rows, int p_blk,
    const int32_t* __restrict__ uids, int U, const uint32_t* __restrict__ wp,
    int ldq, int B, int n_chunks, float* __restrict__ out, int64_t ld_out,
    int n_docs_pad, const int32_t* __restrict__ g_table, int bits) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kUStages];
  __shared__ int s_real[kMaxRows];       // real postings of the block's rows
  __shared__ int s_off[kDocs + 1];       // doc offsets of the row
  __shared__ int s_wsum[2][kUWarps];     // matches a warp found in a stage

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (blockIdx.x % n_chunks) * kUQ;
  const int nq = min(kUQ, B - q0);
  const int G = gridDim.x / n_chunks, b0 = blockIdx.x / n_chunks;
  const int n_rounds = (n_rows - b0 + G - 1) / G;  // rows b0 + k G
  const int fd = tid >> 2, fg = tid & 3;  // the doc and query group folded
  const bool fq = fg * kQPT < nq;         // the group holds a query

  int32_t* ring = reinterpret_cast<int32_t*>(smem);
  int32_t* s_le = ring + kUStages * kStageP;  // u << kPosBits | position
  float* s_lx = reinterpret_cast<float*>(s_le + kList);  // impacts
  const int fbits = uid_table::filter_bits(bits);
  uint32_t* s_filter = reinterpret_cast<uint32_t*>(s_lx + kList);
  int32_t* s_keys = reinterpret_cast<int32_t*>(s_filter + (1 << (fbits - 5)));
  int32_t* s_slots = s_keys + (1 << bits);
  unsigned char* s_w = reinterpret_cast<unsigned char*>(
      kSmem ? s_slots + (1 << bits) : s_keys);
  uint16_t* s_pm = reinterpret_cast<uint16_t*>(s_w + (size_t)U * kWRow);

  for (int k = tid; k < n_rounds; k += kUThreads)
    s_real[k] = doc_off[(int64_t)(b0 + k * G) * (kDocs + 1) + kDocs];
  __syncthreads();

  // Thread 0 streams the rows' real postings, kUStages stages ahead: stage
  // (k, c) is postings [c kStageP, (c + 1) kStageP) of row round k, cut at
  // the row's real count (a row with none is one stage of 0 bytes, which
  // completes on the arrival alone).  p_blk % 4 == 0, so a copy rounded up
  // to 16 bytes stays inside its row.
  int pk = 0, pc = 0;
  auto produce = [&](int slot) {
    const int n = s_real[pk], c0 = pc * kStageP;
    const int len = max(0, min(kStageP, n - c0));
    const uint32_t bar = tma::smem_u32(&full[slot]);
    tma::mbar_expect_tx(bar, (len + 3) / 4 * 16);
    if (len)
      tma::bulk_copy(tma::smem_u32(ring + slot * kStageP),
                     terms + (int64_t)(b0 + pk * G) * p_blk + c0,
                     (len + 3) / 4 * 16, bar);
    if (c0 + kStageP >= n) ++pk, pc = 0;
    else ++pc;
  };
  if (tid == 0) {
    for (int i = 0; i < kUStages; ++i) tma::mbar_init(tma::smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kUStages && pk < n_rounds; ++i) produce(i);
  }

  // The uid table, the weights and the filter, while the first stages
  // stream in.  The weights: thread (u, g) converts its group's 16 packed
  // words into 16 bf16 (two 16-byte stores) and 16 presence bits.
  const int32_t* keys = s_keys;
  const int32_t* slots = s_slots;
  if constexpr (kSmemW) {
    for (int i = tid; i < U * 4; i += kUThreads) {
      const int u = i >> 2, g = i & 3;
      uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0}, pm = 0;
      if (g * kQPT < nq) {
        const uint4* r = reinterpret_cast<const uint4*>(
            wp + (int64_t)u * ldq + q0 + g * kQPT);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint4 v = __ldg(r + k);
          const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            w[2 * k + h] = (x[2 * h] >> 16) | (x[2 * h + 1] & 0xffff0000u);
            pm |= ((x[2 * h] & 1u) | (x[2 * h + 1] & 1u) << 1) << (4 * k + 2 * h);
          }
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(s_w + (size_t)u * kWRow + g * 32);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      s_pm[u * 4 + g] = (uint16_t)pm;
    }
  }
  if constexpr (kSmem) {
    uid_table::build_shared(s_keys, s_slots, uids, U, bits);  // barriers
  } else {
    keys = g_table, slots = g_table + (1 << bits);
  }
  uid_table::build_filter(s_filter, fbits, keys, bits);  // barriers

  float acc[kQPT];  // doc fd's sums for queries q0 + 16 fg + i
#pragma unroll
  for (int i = 0; i < kQPT; ++i) acc[i] = 0.f;
  uint32_t pres = 0;  // bit i: query q0 + 16 fg + i matched doc fd

  int k = 0, c = 0;        // the stage: row round, stage of the row
  int n_list = 0, base = 0, spans = 0;  // the list: matches, first
                                        // position, stages it spans
  int off = 0;
  for (int j = 0; k < n_rounds; ++j) {
    const int row = b0 + k * G;
    const int n = s_real[k], c0 = c * kStageP;
    const int len = max(0, min(kStageP, n - c0));
    const bool last = c0 + kStageP >= n;
    int u[4] = {-1, -1, -1, -1};
    int cnt = 0;
    if (c == 0 && tid <= kDocs)
      off = __ldg(doc_off + (int64_t)row * (kDocs + 1) + tid);
    // One lookup per posting for the whole batch: postings 4 tid .. 4 tid
    // + 3 of the stage, from one 16-byte load; the filter ends most.
    tma::mbar_wait(tma::smem_u32(&full[j % kUStages]), (j / kUStages) & 1);
    const int p4 = tid * 4;
    if (p4 < len) {
      const int4 v =
          *reinterpret_cast<const int4*>(ring + (j % kUStages) * kStageP + p4);
      const int32_t term[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p4 + i < len && uid_table::filter_pass(s_filter, fbits, term[i]))
          u[i] = uid_table::lookup(keys, slots, bits, term[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) cnt += u[i] >= 0;
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_wsum[j & 1][warp] = incl;
    __syncthreads();
    if (tid == 0 && pk < n_rounds) produce(j % kUStages);  // slot is free
    if (c == 0) {
      if (tid <= kDocs) s_off[tid] = off;
      base = 0;
    }

    // The stage's matches, appended to the list in posting order: a prefix
    // count over the block places them, (u, position) and an asynchronous
    // copy of the impact.
    int ws = s_wsum[j & 1][lane & (kUWarps - 1)];
#pragma unroll
    for (int o = 1; o < kUWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, ws, o);
      if ((lane & (kUWarps - 1)) >= o) ws += y;
    }
    int at = n_list + incl - cnt + (warp ? __shfl_sync(kFull, ws, warp - 1) : 0);
    n_list += __shfl_sync(kFull, ws, kUWarps - 1);
    const float* r_imp = impact + (int64_t)row * p_blk + c0 + p4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (u[i] >= 0) {
        s_le[at] = u[i] << kPosBits | (c0 + p4 + i - base);
        cp_async4(s_lx + at, r_imp + i);
        ++at;
      }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++spans;

    // Fold the list when the row ends, when it spans kFoldStages stages or
    // when it could not take another stage: thread (d, g) adds
    // fmaf(bf16(w[q, u]), impact) over doc d's matches in posting order,
    // from shared memory only (its range by a binary search of the list's
    // positions).
    if (last || spans == kFoldStages || n_list > kList - kStageP) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // the list and its impacts are in place
      auto first_at = [&](int pos) {  // first entry at or after pos
        int lo = 0, hi = n_list;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if ((s_le[mid] & ((1 << kPosBits) - 1)) < pos - base) lo = mid + 1;
          else hi = mid;
        }
        return lo;
      };
      // the doc's first entry (lane of group 0) and its end (group 1)
      const int b = first_at(s_off[fd + (fg & 1)]);
      const int lo = __shfl_sync(kFull, b, lane & ~3);
      const int hi = __shfl_sync(kFull, b, (lane & ~3) | 1);
      if (fq) {
        for (int m = lo; m < hi; ++m) {
          const float x = s_lx[m];
          const int uu = s_le[m] >> kPosBits;
          uint32_t w[8];
          uint32_t pm;
          if constexpr (kSmemW) {
            const uint4* r =
                reinterpret_cast<const uint4*>(s_w + (size_t)uu * kWRow + fg * 32);
            const uint4 a = r[0], b = r[1];
            w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
            w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
            pm = s_pm[uu * 4 + fg];
          } else {
            const uint4* r = reinterpret_cast<const uint4*>(
                wp + (int64_t)uu * ldq + q0 + fg * kQPT);
            pm = 0;
#pragma unroll
            for (int k4 = 0; k4 < 4; ++k4) {
              const uint4 v = __ldg(r + k4);
              w[2 * k4] = (v.x >> 16) | (v.y & 0xffff0000u);
              w[2 * k4 + 1] = (v.z >> 16) | (v.w & 0xffff0000u);
              pm |= ((v.x & 1u) | (v.y & 1u) << 1 | (v.z & 1u) << 2 |
                     (v.w & 1u) << 3) << (4 * k4);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[2 * i] = fmaf(__uint_as_float(w[i] << 16), x, acc[2 * i]);
            acc[2 * i + 1] = fmaf(__uint_as_float(w[i] & 0xffff0000u), x,
                                  acc[2 * i + 1]);
          }
          pres |= pm;
        }
      }
      if (last) {  // the row's keyed scores of doc fd for the group's queries
        if (fq) {
          float* o = out + (int64_t)(q0 + fg * kQPT) * ld_out +
                     (int64_t)row * kDocs + fd;
#pragma unroll
          for (int i = 0; i < kQPT; ++i)
            if (fg * kQPT + i < nq)
              o[(int64_t)i * ld_out] = keyed(acc[i], (float)((pres >> i) & 1u));
        }
        if (row == 0)
          for (int q = tid; q < nq; q += kUThreads)
            out[(int64_t)(q0 + q) * ld_out + n_docs_pad] = -1.f;
#pragma unroll
        for (int i = 0; i < kQPT; ++i) acc[i] = 0.f;
        pres = 0;
      }
      __syncthreads();  // every fold done: the list is free
      n_list = 0, spans = 0, base = c0 + kStageP;
    }
    if (last) ++k, c = 0;
    else ++c;
  }
}

}  // namespace

extern "C" int mse_bm25_blocked(const void* terms, const void* impact,
                                const void* doc_off, int n_blocks, int p_blk,
                                const void* tids, const void* qtf, int B, int T,
                                void* out, int64_t ld_out, void* tables,
                                int64_t tables_len, void* stream) {
  if (B < 1 || T < 1 || ld_out < (int64_t)n_blocks * kDocs + 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (B + kQC - 1) / kQC;
  const int nq_max = B < kQC ? B : kQC;
  const int n_ids = nq_max * T;  // a chunk's term slots
  const int bits = uid_table::table_bits(n_ids);
  const dim3 grid(n_blocks, n_chunks);
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_docs_pad = n_blocks * kDocs;
  const size_t tile = (size_t)nq_max * kDocs * 4;
  if (n_ids <= kSmemIds) {
    const size_t smem = tile + table_words(bits, n_ids) * 4;
    auto kern = blocked_kernel<true>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<grid, kThreads, smem, s>>>(
        (const int32_t*)terms, (const float*)impact, (const int32_t*)doc_off,
        p_blk, (const int32_t*)tids, (const float*)qtf, B, T, bits, nullptr,
        0, (float*)out, ld_out, n_docs_pad);
    return (int)cudaGetLastError();
  }
  const int64_t stride = table_words(bits, n_ids);
  if (tables == nullptr || tables_len < stride * n_chunks)
    return (int)cudaErrorInvalidValue;
  uid_table::build_query_tables_kernel<<<n_chunks, kThreads, 0, s>>>(
      (const int32_t*)tids, (const float*)qtf, B, T, kQC, bits,
      (int32_t*)tables, stride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  blocked_kernel<false><<<grid, kThreads, tile, s>>>(
      (const int32_t*)terms, (const float*)impact, (const int32_t*)doc_off,
      p_blk, (const int32_t*)tids, (const float*)qtf, B, T, bits,
      (const int32_t*)tables, stride, (float*)out, ld_out, n_docs_pad);
  return (int)cudaGetLastError();
}

// Kernel 8.  wpack: U * ldq int32 for pack_weights_kernel (ldq = B rounded
// up to 32); table: the device-memory uid table (2 << global_bits(U)
// int32), needed only when U > kSmemMaxU (bm25_slots.uid_table_scratch).
// The rows must start 16-byte aligned (p_blk % 4 == 0, as the layout pads
// them to POSTING_CHUNK).
extern "C" int mse_bm25_blocked_udedup(const void* terms, const void* impact,
                                       const void* doc_off, int n_blocks,
                                       int p_blk, const void* uids, int U,
                                       const void* w, int B, void* out,
                                       int64_t ld_out, void* wpack,
                                       int64_t wpack_len, void* table,
                                       int64_t table_len, void* stream) {
  const int ldq = (B + kQC - 1) / kQC * kQC;
  if (U < 1 || U >= (1 << (31 - kPosBits)) || B < 1 || n_blocks < 1 ||
      p_blk % 4 || (uintptr_t)terms % 16 ||
      ld_out < (int64_t)n_blocks * kDocs + 1 || wpack == nullptr ||
      wpack_len < (int64_t)U * ldq)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_pack = (int64_t)U * ldq;
  pack_weights_kernel<<<(unsigned)((n_pack + 255) / 256), 256, 0, s>>>(
      (const float*)w, U, B, ldq, (uint32_t*)wpack);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool smem_table = U <= uid_table::kSmemMaxU;
  int bits;
  if (smem_table) {
    bits = uid_table::table_bits(U);
  } else {
    bits = uid_table::global_bits(U);
    if (table == nullptr || table_len < (int64_t)2 << bits)
      return (int)cudaErrorInvalidValue;
    const int rc = uid_table::build_global((const int32_t*)uids, U,
                                           (int32_t*)table, bits, s);
    if (rc != 0) return rc;
  }
  int dev = 0, n_sm = 0, max_smem = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  // the weights in shared memory when they fit beside the rest
  const size_t static_smem = 2048;  // barriers, row counts and offsets
  const bool smem_w =
      smem_table &&
      udedup_smem(bits, true, U, true) + static_smem <= (size_t)max_smem;
  const size_t smem = udedup_smem(bits, smem_table, U, smem_w);
  auto kern = smem_table ? (smem_w ? blocked_udedup_kernel<true, true>
                                   : blocked_udedup_kernel<true, false>)
                         : blocked_udedup_kernel<false, false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kUThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many persistent blocks as fit at once, G for each query chunk, at
  // most one a row and at least enough that no block takes more than
  // kMaxRows rows
  const int n_chunks = (B + kUQ - 1) / kUQ;
  int64_t G = ((int64_t)per_sm * n_sm + n_chunks - 1) / n_chunks;
  if (G < (n_blocks + kMaxRows - 1) / kMaxRows)
    G = (n_blocks + kMaxRows - 1) / kMaxRows;
  if (G > n_blocks) G = n_blocks;
  if (G * n_chunks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kern<<<(int)(G * n_chunks), kUThreads, smem, s>>>(
      (const int32_t*)terms, (const float*)impact, (const int32_t*)doc_off,
      n_blocks, p_blk, (const int32_t*)uids, U, (const uint32_t*)wpack, ldq,
      B, n_chunks, (float*)out, ld_out, n_blocks * kDocs,
      (const int32_t*)table, bits);
  return (int)cudaGetLastError();
}
