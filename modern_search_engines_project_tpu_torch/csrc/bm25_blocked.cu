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
// never read and can never add presence to doc 0.  One block (8 warps)
// takes one row and a chunk of up to 32 queries; warps take the row's docs
// one at a time from a shared counter.  The 32 lanes of a warp read 32
// consecutive postings of the doc (coalesced) and look each one up once in a
// hash table of distinct term ids (uid_table.cuh's hash, shared with the slot
// kernels): the U-dedup kernel among the batch's distinct ids, kernel 7
// among its query chunk's.  A ballot gives the lanes that matched (1-6% of
// postings for a batch of df-drawn queries at the bench shape, ~10% when
// all share the 100 most frequent terms); for each, in lane order, the
// posting's u and impact are broadcast and lane q adds query q's
// m * impact.  So every (query, doc) score is an f32 sum in posting order —
// the order of the slot kernels, since both layouts keep a doc's postings
// in CSR order — deterministic, with no atomics.  The keyed scores of the
// row go through a shared [32, 128] tile and leave as coalesced 512-byte
// rows.
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
// kernel packs first: one word per (u, b), query-major, so the 32 lanes of
// a warp (32 queries) read one 128-byte line per matched posting instead
// of 32 scattered words of w for each of the two.
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
#include <stdint.h>

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

// Kernel 8.  kSmem: U <= uid_table::kSmemMaxU, the uid table lives in
// shared memory; otherwise it is the one build_global made (g_table,
// 2^g_bits slots).  wp is pack_weights_kernel's table.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads) blocked_udedup_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int32_t* __restrict__ doc_off, int p_blk,
    const int32_t* __restrict__ uids, int U, const uint32_t* __restrict__ wp,
    int ldq, int B, float* __restrict__ out, int64_t ld_out, int n_docs_pad,
    const int32_t* __restrict__ g_table, int g_bits) {
  __shared__ int32_t s_key[kSmem ? uid_table::kSmemSize : 1];
  __shared__ int32_t s_slot[kSmem ? uid_table::kSmemSize : 1];
  __shared__ float s_out[kQC][kDocs];
  __shared__ int s_next;
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kQC;
  const int nq = min(kQC, B - q0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_next = 0;
  if constexpr (kSmem)
    uid_table::build_shared(s_key, s_slot, uids, U);  // ends with a barrier
  else
    __syncthreads();
  const int bits = kSmem ? uid_table::kSmemBits : g_bits;
  const int32_t* keys = kSmem ? s_key : g_table;
  const int32_t* slots = kSmem ? s_slot : g_table + ((size_t)1 << g_bits);
  const uint32_t* q_wp = wp + q0 + lane;  // column of the lane's query
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
        const uint32_t v = q_wp[(int64_t)uu * ldq];  // 0 beyond the batch
        s += __uint_as_float(v & 0xffff0000u) * xx;
        c += (v & 1u) ? 1.f : 0.f;
      }
    }
    if (lane < nq) s_out[lane][d] = keyed(s, c);
  }
  store_tile(s_out, nq, q0, row, out, ld_out, n_docs_pad);
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

extern "C" int mse_bm25_blocked_udedup(const void* terms, const void* impact,
                                       const void* doc_off, int n_blocks,
                                       int p_blk, const void* uids, int U,
                                       const void* w, int B, void* out,
                                       int64_t ld_out, void* wpack,
                                       int64_t wpack_len, void* table,
                                       int64_t table_len, void* stream) {
  const int ldq = (B + kQC - 1) / kQC * kQC;
  if (U < 1 || ld_out < (int64_t)n_blocks * kDocs + 1 || wpack == nullptr ||
      wpack_len < (int64_t)U * ldq)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blocks, ldq / kQC);
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_docs_pad = n_blocks * kDocs;
  const int64_t n_pack = (int64_t)U * ldq;
  pack_weights_kernel<<<(unsigned)((n_pack + 255) / 256), 256, 0, s>>>(
      (const float*)w, U, B, ldq, (uint32_t*)wpack);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (U <= uid_table::kSmemMaxU) {
    blocked_udedup_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int32_t*)terms, (const float*)impact, (const int32_t*)doc_off,
        p_blk, (const int32_t*)uids, U, (const uint32_t*)wpack, ldq, B,
        (float*)out, ld_out, n_docs_pad, nullptr, 0);
    return (int)cudaGetLastError();
  }
  const int bits = uid_table::global_bits(U);
  if (table == nullptr || table_len < (int64_t)2 << bits)
    return (int)cudaErrorInvalidValue;
  const int rc =
      uid_table::build_global((const int32_t*)uids, U, (int32_t*)table, bits, s);
  if (rc != 0) return rc;
  blocked_udedup_kernel<false><<<grid, kThreads, 0, s>>>(
      (const int32_t*)terms, (const float*)impact, (const int32_t*)doc_off,
      p_blk, (const int32_t*)uids, U, (const uint32_t*)wpack, ldq, B,
      (float*)out, ld_out, n_docs_pad, (const int32_t*)table, bits);
  return (int)cudaGetLastError();
}
