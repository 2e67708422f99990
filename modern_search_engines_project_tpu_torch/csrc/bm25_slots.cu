// Slot-layout BM25 scoring kernels of the hybrid query path, for Hopper.
//
// Replaces the TPU kernels in modern_search_engines_project_tpu/retrieval/bm25_pallas.py:
//   mse_bm25_slots             <- _kernel_slots (:190) with its tail _accum_keyed (:165)
//   mse_bm25_slots_udedup_bf16 <- _kernel_slots_udedup (:241), variant "sublane"
//   mse_bm25_slots_udedup_i8   <- _kernel_slots_udedup_i8 (:289), variant "i8"
//
// What they compute.  The doc-slot postings are groups of 512 doc columns;
// column c of group g holds one document's postings stacked down its rows
// (term id int32 pad -1, impact f32 pad 0).  For every (query b, column):
//   plain : m = sum_t qtf[b,t] * (term == tids[b,t])       (query pad -1 -> -2)
//   udedup: m = sum_u w[b,u] * (term == uids[u])           (uids pad -2)
//   score = sum_rows m * impact,  count = sum_rows (m > 0)
//   out[b, g*512 + c] = (count > 0 && score >= 0) ? score : -1     ("keyed")
// The output column order is the class-concatenated order of the groups
// (the caller un-permutes it with col_unperm).
//
// Design.  The TPU walks a group's rows as a sequential grid axis carrying
// the sum in VMEM scratch; here one block owns one whole group (512
// threads, one doc column each) and loops over all its rows, so nothing is
// carried between blocks and the keyed score is written once.  Each
// thread keeps the sums of up to 8 queries in registers; grid.y covers
// the batch in chunks of 8.  Reads of a row are coalesced (512 consecutive
// columns).
//
// The U-dedup variants match each posting against the batch's DISTINCT
// term ids once, then recover every query's weight from w.  The TPU does
// that with a (B,U)@(U,COLS) matmul of a 0/1 match matrix; since the real
// uids are distinct, a posting matches at most one u, so the product is
// exactly w[b, u*] — found here with a hash table of the uids
// (uid_table.cuh: O(1) probes instead of U compares).  "sublane" converts w
// to bf16 and "i8" to int8 before use, as the TPU kernels do; both are
// exact for the small-integer weights dedup_query_terms produces, so the
// two give identical keyed scores (one templated body).
//
// Any T and any U.  Up to kMaxT query term slots (plain) and up to
// uid_table::kSmemMaxU distinct ids (U-dedup) are staged in shared memory,
// as are the U-dedup weights; beyond that the kernels read the query term
// ids, the weight rows and a hash table built in device memory directly
// (cached in L1/L2): a weight is read only for a posting that matches.
//
// Bound on this card: each posting slot is read once (8 bytes); at the
// 100k-doc bench shape that is ~69 MB per call by the layout's size, so
// ~21 us at the H100's published 3.35 TB/s.  The plain kernel also does
// B*T compares per posting, which passes that memory time at large B (it
// serves only B < 8 in the engine).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "uid_table.cuh"

namespace {

constexpr int kCols = 512;     // doc columns per group (SLOT_COLS)
constexpr int kQB = 8;         // queries per block (grid.y chunks the batch)
constexpr int kMaxT = 64;      // query term slots staged in shared memory
constexpr int kMaxU = uid_table::kSmemMaxU;  // distinct ids staged likewise

__device__ __forceinline__ float keyed(float s, float c) {
  return (c > 0.f && s >= 0.f) ? s : -1.f;
}

// kSmemQ: the query term ids and weights (T <= kMaxT) are staged in shared
// memory; otherwise read from device memory.  Pad slots are skipped before
// the match, so a query pad (-1) never meets a posting pad.
template <bool kSmemQ>
__global__ void __launch_bounds__(kCols) slots_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int64_t* __restrict__ group_off, const int32_t* __restrict__ group_rows,
    const int32_t* __restrict__ tids, const float* __restrict__ qtf, int B, int T,
    float* __restrict__ out, int64_t ld_out) {
  __shared__ int32_t s_tid[kSmemQ ? kQB * kMaxT : 1];
  __shared__ float s_qtf[kSmemQ ? kQB * kMaxT : 1];
  const int g = blockIdx.x;
  const int col = threadIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, B - q0);
  if constexpr (kSmemQ) {
    for (int i = threadIdx.x; i < nq * T; i += blockDim.x) {
      s_tid[i] = tids[(int64_t)q0 * T + i];
      s_qtf[i] = qtf[(int64_t)q0 * T + i];
    }
    __syncthreads();
  }
  const int32_t* q_tid = kSmemQ ? s_tid : tids + (int64_t)q0 * T;
  const float* q_w = kSmemQ ? s_qtf : qtf + (int64_t)q0 * T;

  float acc_s[kQB], acc_c[kQB];
#pragma unroll
  for (int q = 0; q < kQB; ++q) {
    acc_s[q] = 0.f;
    acc_c[q] = 0.f;
  }
  const int64_t base = group_off[g] + col;
  const int rows = group_rows[g];
  for (int r = 0; r < rows; ++r) {
    const int32_t t = __ldg(terms + base + (int64_t)r * kCols);
    if (t < 0) continue;  // pad slot: matches no query, adds exactly 0
    const float x = __ldg(impact + base + (int64_t)r * kCols);
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      if (q < nq) {
        float m = 0.f;
        for (int j = 0; j < T; ++j)
          m += (t == q_tid[q * T + j]) ? q_w[q * T + j] : 0.f;
        acc_s[q] += m * x;
        acc_c[q] += (m > 0.f) ? 1.f : 0.f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQB; ++q)
    if (q < nq)
      out[(int64_t)(q0 + q) * ld_out + (int64_t)g * kCols + col] =
          keyed(acc_s[q], acc_c[q]);
}

template <typename W>
__device__ __forceinline__ W to_weight(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_weight<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ int8_t to_weight<int8_t>(float v) {
  return (int8_t)(int)v;
}
__device__ __forceinline__ float weight_value(__nv_bfloat16 w) {
  return __bfloat162float(w);
}
__device__ __forceinline__ float weight_value(int8_t w) {
  return (float)(int32_t)w;  // s8 weight x 0/1 match -> s32 -> f32, exact
}

// kSmem: U <= kMaxU, so the uid table and the block's weights live in
// shared memory; otherwise the table is the one build_global made
// (g_table, 2^g_bits slots) and weights are read from w as needed.
template <typename W, bool kSmem>
__global__ void __launch_bounds__(kCols) slots_udedup_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int64_t* __restrict__ group_off, const int32_t* __restrict__ group_rows,
    const int32_t* __restrict__ uids, int U, const float* __restrict__ w, int B,
    float* __restrict__ out, int64_t ld_out, const int32_t* __restrict__ g_table,
    int g_bits) {
  __shared__ int32_t s_key[kSmem ? uid_table::kSmemSize : 1];
  __shared__ int32_t s_slot[kSmem ? uid_table::kSmemSize : 1];
  __shared__ W s_w[kSmem ? kQB * kMaxU : 1];
  const int g = blockIdx.x;
  const int col = threadIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, B - q0);

  // weight rows [0, B) of w; the presence rows [B, 2B) are not read: the
  // presence of a query is derived as (weight > 0)
  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < kQB * U; i += blockDim.x) {
      const int q = i / U;
      const float v = q < nq ? w[(int64_t)(q0 + q) * U + (i - q * U)] : 0.f;
      s_w[i] = to_weight<W>(v);
    }
    uid_table::build_shared(s_key, s_slot, uids, U);
  }
  const int bits = kSmem ? uid_table::kSmemBits : g_bits;
  const int32_t* keys = kSmem ? s_key : g_table;
  const int32_t* slots = kSmem ? s_slot : g_table + ((size_t)1 << g_bits);

  float acc_s[kQB], acc_c[kQB];
#pragma unroll
  for (int q = 0; q < kQB; ++q) {
    acc_s[q] = 0.f;
    acc_c[q] = 0.f;
  }
  const int64_t base = group_off[g] + col;
  const int rows = group_rows[g];
  for (int r = 0; r < rows; ++r) {
    const int32_t t = __ldg(terms + base + (int64_t)r * kCols);
    if (t < 0) continue;
    const int u = uid_table::lookup(keys, slots, bits, t);
    if (u < 0) continue;  // no batch term: every query's weight is 0
    const float x = __ldg(impact + base + (int64_t)r * kCols);
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      if (q < nq) {
        float mw;
        if constexpr (kSmem)
          mw = weight_value(s_w[q * U + u]);
        else
          mw = weight_value(to_weight<W>(w[(int64_t)(q0 + q) * U + u]));
        acc_s[q] += mw * x;
        acc_c[q] += (mw > 0.f) ? 1.f : 0.f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQB; ++q)
    if (q < nq)
      out[(int64_t)(q0 + q) * ld_out + (int64_t)g * kCols + col] =
          keyed(acc_s[q], acc_c[q]);
}

template <typename W>
int launch_udedup(const void* terms, const void* impact, const void* group_off,
                  const void* group_rows, int n_groups, const void* uids, int U,
                  const void* w, int B, void* out, int64_t ld_out, void* table,
                  int64_t table_len, void* stream) {
  if (U < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(n_groups, (B + kQB - 1) / kQB);
  if (U <= kMaxU) {
    slots_udedup_kernel<W, true><<<grid, kCols, 0, s>>>(
        (const int32_t*)terms, (const float*)impact, (const int64_t*)group_off,
        (const int32_t*)group_rows, (const int32_t*)uids, U, (const float*)w, B,
        (float*)out, ld_out, nullptr, 0);
    return (int)cudaGetLastError();
  }
  const int bits = uid_table::global_bits(U);
  if (table == nullptr || table_len < (int64_t)2 << bits)
    return (int)cudaErrorInvalidValue;
  const int rc = uid_table::build_global((const int32_t*)uids, U,
                                         (int32_t*)table, bits, s);
  if (rc != 0) return rc;
  slots_udedup_kernel<W, false><<<grid, kCols, 0, s>>>(
      (const int32_t*)terms, (const float*)impact, (const int64_t*)group_off,
      (const int32_t*)group_rows, (const int32_t*)uids, U, (const float*)w, B,
      (float*)out, ld_out, (const int32_t*)table, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mse_bm25_slots(const void* terms, const void* impact,
                              const void* group_off, const void* group_rows,
                              int n_groups, const void* tids, const void* qtf,
                              int B, int T, void* out, int64_t ld_out,
                              void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(n_groups, (B + kQB - 1) / kQB);
  const cudaStream_t s = (cudaStream_t)stream;
  if (T <= kMaxT)
    slots_kernel<true><<<grid, kCols, 0, s>>>(
        (const int32_t*)terms, (const float*)impact, (const int64_t*)group_off,
        (const int32_t*)group_rows, (const int32_t*)tids, (const float*)qtf, B,
        T, (float*)out, ld_out);
  else
    slots_kernel<false><<<grid, kCols, 0, s>>>(
        (const int32_t*)terms, (const float*)impact, (const int64_t*)group_off,
        (const int32_t*)group_rows, (const int32_t*)tids, (const float*)qtf, B,
        T, (float*)out, ld_out);
  return (int)cudaGetLastError();
}

extern "C" int mse_bm25_slots_udedup_bf16(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* table,
    int64_t table_len, void* stream) {
  return launch_udedup<__nv_bfloat16>(terms, impact, group_off, group_rows,
                                      n_groups, uids, U, w, B, out, ld_out,
                                      table, table_len, stream);
}

extern "C" int mse_bm25_slots_udedup_i8(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* table,
    int64_t table_len, void* stream) {
  return launch_udedup<int8_t>(terms, impact, group_off, group_rows, n_groups,
                               uids, U, w, B, out, ld_out, table, table_len,
                               stream);
}

extern "C" const char* mse_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
