// Lookup of a posting's term id among a batch's DISTINCT query term ids
// ("uids"), shared by the U-dedup kernels of bm25_slots.cu and
// bm25_blocked.cu, with the bit filter that ends most lookups before a
// probe.
//
// The TPU kernels recover per-query weights with a (B,U)@(U,cols) product
// of a 0/1 match matrix.  The real uids are distinct, so a posting matches
// at most one u and that product is exactly w[b, u*]; here u* comes from an
// open-addressing hash table of the uids (linear probing, load <= 1/2), in
// any order of the uids:
//   * U <= kSmemMaxU: every block builds a kSmemSize-slot table in shared
//     memory (build_shared);
//   * larger U: build_global fills ONE table of next_pow2(2U) slots in
//     device memory (scratch the caller allocates) before the scoring
//     kernel, which probes it through L1/L2.  A few percent of postings
//     match at the bench shape, and a miss ends at the first empty slot.
// Keys are the uids, values their positions u; pads (uid < 0) are never
// inserted, and postings with term < 0 are never looked up.
//
// The per-query kernels (slot kernel 1, blocked kernel 7) look postings up
// the same way, in a table of one query chunk's distinct term ids with a
// weight row m[u][q] beside each (build_query_table): both sum a weight in
// term-slot order there, which keeps their scores the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace uid_table {

constexpr int kSmemBits = 11;
constexpr int kSmemSize = 1 << kSmemBits;
constexpr int kSmemMaxU = kSmemSize / 2;  // 1024
constexpr int32_t kEmpty = -1;            // memset 0xFF; real ids are >= 0

__device__ __forceinline__ uint32_t hash_slot(int32_t key, int bits) {
  return ((uint32_t)key * 2654435761u) >> (32 - bits);
}

// Insert key (= uids[u]) with value u; `keys` starts all kEmpty.  Real uids
// are distinct by contract, so a key already present is left as it is.
__device__ __forceinline__ void insert(int32_t* keys, int32_t* slots, int bits,
                                       int32_t key, int u) {
  const uint32_t mask = (1u << bits) - 1u;
  uint32_t h = hash_slot(key, bits);
  while (true) {
    const int32_t prev = atomicCAS(keys + h, kEmpty, key);
    if (prev == kEmpty) {
      slots[h] = u;
      return;
    }
    if (prev == key) return;
    h = (h + 1u) & mask;
  }
}

// u with uids[u] == key, or -1.
__device__ __forceinline__ int lookup(const int32_t* keys, const int32_t* slots,
                                      int bits, int32_t key) {
  const uint32_t mask = (1u << bits) - 1u;
  uint32_t h = hash_slot(key, bits);
  while (true) {
    const int32_t k = keys[h];
    if (k == key) return slots[h];
    if (k == kEmpty) return -1;
    h = (h + 1u) & mask;
  }
}

// Block-cooperative build of a 2^bits-slot table in shared memory (2^bits
// >= 2U; kSmemBits for U up to kSmemMaxU).  Every thread of the block must
// call it; it ends with a barrier.
__device__ __forceinline__ void build_shared(int32_t* keys, int32_t* slots,
                                             const int32_t* __restrict__ uids,
                                             int U, int bits = kSmemBits) {
  for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x) keys[i] = kEmpty;
  __syncthreads();
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const int32_t key = uids[u];
    if (key >= 0) insert(keys, slots, bits, key, u);
  }
  __syncthreads();
}

__global__ void build_global_kernel(const int32_t* __restrict__ uids, int U,
                                    int32_t* keys, int32_t* slots, int bits) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < U) {
    const int32_t key = uids[u];
    if (key >= 0) insert(keys, slots, bits, key, u);
  }
}

// Bits of a table for n ids: 2^bits >= 2n (at least 2 slots).
__host__ __device__ inline int table_bits(int n) {
  int bits = 1;
  while ((1 << bits) < 2 * n) ++bits;
  return bits;
}

// Table bits for U distinct ids in device memory: 2^bits >= 2U.
inline int global_bits(int U) {
  int bits = kSmemBits;
  while ((1 << bits) < 2 * U) ++bits;
  return bits;
}

// Fill the device-memory table `table` (2 << bits int32: keys, then values)
// on `stream`.  Returns 0 or a CUDA error code.
inline int build_global(const int32_t* uids, int U, int32_t* table, int bits,
                        cudaStream_t stream) {
  const size_t n = (size_t)1 << bits;
  cudaError_t e = cudaMemsetAsync(table, 0xFF, n * sizeof(int32_t), stream);
  if (e != cudaSuccess) return (int)e;
  build_global_kernel<<<(U + 255) / 256, 256, 0, stream>>>(uids, U, table,
                                                           table + n, bits);
  return (int)cudaGetLastError();
}

// ---- the membership filter in front of a table (kernels 1-3, 5 and 8) -----
// Most postings match no query term.  A bit filter of the table's ids (one
// bit an id under a multiplicative hash of its own) ends their lookup after
// one shared-memory load, before any probe of the table; only a set bit
// probes.  2^fbits bits for a table of 2^bits slots: 64 a slot (about 128
// an id), at least 2^12 and at most 2^15 (4 KB).

__host__ __device__ constexpr int filter_bits(int bits) {
  return bits + 6 > 15 ? 15 : bits + 6 < 12 ? 12 : bits + 6;
}

// Bytes of the filter of a table of 2^bits slots.
__host__ __device__ constexpr int filter_bytes(int bits) {
  return 1 << (filter_bits(bits) - 3);
}

// The filter's bit of a term id.
__device__ __forceinline__ uint32_t filter_bit(int32_t key, int fbits) {
  return ((uint32_t)key * 0x85EBCA77u) >> (32 - fbits);
}

// Whether term id `key` may be in the table: false for pads (key < 0) and
// for most ids that are not there.
__device__ __forceinline__ bool filter_pass(const uint32_t* filter, int fbits,
                                            int32_t key) {
  const uint32_t b = filter_bit(key, fbits);
  return key >= 0 && ((filter[b >> 5] >> (b & 31)) & 1u);
}

// Block-cooperative build of the filter (2^fbits bits in shared memory) of
// the table whose 2^bits keys are `keys` (shared or device memory).  Every
// thread of the block must call it; it starts and ends with a barrier.
__device__ __forceinline__ void build_filter(uint32_t* filter, int fbits,
                                             const int32_t* keys, int bits) {
  for (int i = threadIdx.x; i < (1 << (fbits - 5)); i += blockDim.x)
    filter[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x) {
    const int32_t k = keys[i];
    if (k != kEmpty) {
      const uint32_t b = filter_bit(k, fbits);
      atomicOr(filter + (b >> 5), 1u << (b & 31));
    }
  }
  __syncthreads();
}

// ---- one query chunk's table (kernels 1 and 7) ----------------------------
// The distinct term ids of nq queries of T term slots each: an
// open-addressing table of 2^bits keys (2^bits >= 2 nq T) and 2^bits dense
// ids u, and m[u * ldm + q], the weight sum_t qtf[q, t] * (tids[q, t] ==
// id_u) of query q, summed in t order as the TPU kernel's per-query match
// does (q < nq <= ldm; columns q >= nq stay 0).  A repeated id is one
// entry; query pads (< 0) are skipped.

// int32 words of one chunk's table: keys, dense ids, then m [n_ids][ldm].
__host__ __device__ inline int64_t query_table_words(int bits, int n_ids,
                                                     int ldm) {
  return 2 * ((int64_t)1 << bits) + (int64_t)n_ids * ldm;
}

// Block-cooperative build (keys, slots and m in shared or device memory,
// `count` in shared memory).  Every thread of the block calls it; it ends
// with a barrier.
__device__ __forceinline__ void build_query_table(
    const int32_t* __restrict__ tids, const float* __restrict__ qtf, int nq,
    int T, int bits, int32_t* keys, int32_t* slots, float* m, int ldm,
    int* count) {
  const int size = 1 << bits;
  for (int i = threadIdx.x; i < size; i += blockDim.x) keys[i] = kEmpty;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  const uint32_t mask = (uint32_t)size - 1u;
  for (int i = threadIdx.x; i < nq * T; i += blockDim.x) {
    const int32_t key = tids[i];
    if (key < 0) continue;  // query pads never match
    uint32_t h = hash_slot(key, bits);
    while (true) {
      const int32_t prev = atomicCAS(keys + h, kEmpty, key);
      if (prev == kEmpty) {
        slots[h] = atomicAdd(count, 1);
        break;
      }
      if (prev == key) break;  // a repeated id: one entry
      h = (h + 1u) & mask;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < *count * ldm; i += blockDim.x) m[i] = 0.f;
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += blockDim.x)
    for (int j = 0; j < T; ++j) {
      const int32_t key = tids[q * T + j];
      if (key >= 0) m[lookup(keys, slots, bits, key) * ldm + q] += qtf[q * T + j];
    }
  __syncthreads();
}

// Device-memory tables, one block per chunk of ldm queries: chunk c's table
// starts at tables + c * stride, sized for n_ids = min(B, ldm) * T ids.
__global__ void build_query_tables_kernel(const int32_t* __restrict__ tids,
                                          const float* __restrict__ qtf,
                                          int B, int T, int ldm, int bits,
                                          int32_t* tables, int64_t stride) {
  __shared__ int count;
  const int q0 = blockIdx.x * ldm;
  int32_t* keys = tables + blockIdx.x * stride;
  int32_t* slots = keys + (1 << bits);
  build_query_table(tids + (int64_t)q0 * T, qtf + (int64_t)q0 * T,
                    min(ldm, B - q0), T, bits, keys, slots,
                    reinterpret_cast<float*>(slots + (1 << bits)), ldm,
                    &count);
}

}  // namespace uid_table
}  // namespace
