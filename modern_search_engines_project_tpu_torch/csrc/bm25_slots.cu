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
// exactly w[b, u*] — found here with a hash table of the uids in shared
// memory (O(1) probes instead of U compares).  "sublane" converts w to
// bf16 and "i8" to int8 before use, as the TPU kernels do; both are exact
// for the small-integer weights dedup_query_terms produces, so the two give
// identical keyed scores (one templated body).
//
// Bound on this card: each posting slot is read once (8 bytes); at the
// 100k-doc bench shape that is ~69 MB per call by the layout's size, so
// ~21 us at the H100's published 3.35 TB/s.  The plain kernel also does
// B*T compares per posting, which passes that memory time at large B (it
// serves only B < 8 in the engine).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kCols = 512;     // doc columns per group (SLOT_COLS)
constexpr int kQB = 8;         // queries per block (grid.y chunks the batch)
constexpr int kMaxT = 64;      // query term slots the plain kernel takes
constexpr int kMaxU = 1024;    // distinct batch terms the U-dedup kernels take
constexpr int kHashBits = 11;  // 2048-slot table: load factor <= 1/2
constexpr int kHashSize = 1 << kHashBits;
constexpr int32_t kEmpty = INT_MIN;

__device__ __forceinline__ float keyed(float s, float c) {
  return (c > 0.f && s >= 0.f) ? s : -1.f;
}

__device__ __forceinline__ uint32_t hash_slot(int32_t key) {
  return ((uint32_t)key * 2654435761u) >> (32 - kHashBits);
}

__global__ void __launch_bounds__(kCols) slots_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int64_t* __restrict__ group_off, const int32_t* __restrict__ group_rows,
    const int32_t* __restrict__ tids, const float* __restrict__ qtf, int B, int T,
    float* __restrict__ out, int64_t ld_out) {
  __shared__ int32_t s_tid[kQB * kMaxT];
  __shared__ float s_qtf[kQB * kMaxT];
  const int g = blockIdx.x;
  const int col = threadIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, B - q0);
  for (int i = threadIdx.x; i < kQB * T; i += blockDim.x) {
    const int q = i / T;
    int32_t id = -2;
    float wq = 0.f;
    if (q < nq) {
      const int64_t src = (int64_t)(q0 + q) * T + (i - q * T);
      id = tids[src];
      wq = qtf[src];
      if (id < 0) id = -2;  // query pad never collides with posting pad -1
    }
    s_tid[i] = id;
    s_qtf[i] = wq;
  }
  __syncthreads();

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
          m += (t == s_tid[q * T + j]) ? s_qtf[q * T + j] : 0.f;
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

template <typename W>
__global__ void __launch_bounds__(kCols) slots_udedup_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int64_t* __restrict__ group_off, const int32_t* __restrict__ group_rows,
    const int32_t* __restrict__ uids, int U, const float* __restrict__ w, int B,
    float* __restrict__ out, int64_t ld_out) {
  __shared__ int32_t s_key[kHashSize];
  __shared__ int16_t s_slot[kHashSize];
  __shared__ W s_w[kQB * kMaxU];
  const int g = blockIdx.x;
  const int col = threadIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, B - q0);

  for (int i = threadIdx.x; i < kHashSize; i += blockDim.x) s_key[i] = kEmpty;
  // weight rows [0, B) of w; the presence rows [B, 2B) are not read: the
  // presence of a query is derived as (weight > 0)
  for (int i = threadIdx.x; i < kQB * U; i += blockDim.x) {
    const int q = i / U;
    const float v = q < nq ? w[(int64_t)(q0 + q) * U + (i - q * U)] : 0.f;
    s_w[i] = to_weight<W>(v);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const int32_t key = uids[u];
    if (key < 0) continue;  // pad -2 never matches a posting
    uint32_t h = hash_slot(key);
    while (true) {
      const int32_t prev = atomicCAS(&s_key[h], kEmpty, key);
      if (prev == kEmpty) {
        s_slot[h] = (int16_t)u;
        break;
      }
      if (prev == key) break;  // real uids are distinct by contract
      h = (h + 1) & (kHashSize - 1);
    }
  }
  __syncthreads();

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
    uint32_t h = hash_slot(t);
    int u = -1;
    while (true) {
      const int32_t k = s_key[h];
      if (k == t) {
        u = s_slot[h];
        break;
      }
      if (k == kEmpty) break;
      h = (h + 1) & (kHashSize - 1);
    }
    if (u < 0) continue;  // no batch term: every query's weight is 0
    const float x = __ldg(impact + base + (int64_t)r * kCols);
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      if (q < nq) {
        const float mw = weight_value(s_w[q * U + u]);
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
                  const void* w, int B, void* out, int64_t ld_out, void* stream) {
  if (U < 1 || U > kMaxU) return (int)cudaErrorInvalidValue;
  dim3 grid(n_groups, (B + kQB - 1) / kQB);
  slots_udedup_kernel<W><<<grid, kCols, 0, (cudaStream_t)stream>>>(
      (const int32_t*)terms, (const float*)impact, (const int64_t*)group_off,
      (const int32_t*)group_rows, (const int32_t*)uids, U, (const float*)w, B,
      (float*)out, ld_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mse_bm25_slots(const void* terms, const void* impact,
                              const void* group_off, const void* group_rows,
                              int n_groups, const void* tids, const void* qtf,
                              int B, int T, void* out, int64_t ld_out,
                              void* stream) {
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  dim3 grid(n_groups, (B + kQB - 1) / kQB);
  slots_kernel<<<grid, kCols, 0, (cudaStream_t)stream>>>(
      (const int32_t*)terms, (const float*)impact, (const int64_t*)group_off,
      (const int32_t*)group_rows, (const int32_t*)tids, (const float*)qtf, B, T,
      (float*)out, ld_out);
  return (int)cudaGetLastError();
}

extern "C" int mse_bm25_slots_udedup_bf16(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* stream) {
  return launch_udedup<__nv_bfloat16>(terms, impact, group_off, group_rows,
                                      n_groups, uids, U, w, B, out, ld_out,
                                      stream);
}

extern "C" int mse_bm25_slots_udedup_i8(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* stream) {
  return launch_udedup<int8_t>(terms, impact, group_off, group_rows, n_groups,
                               uids, U, w, B, out, ld_out, stream);
}

extern "C" const char* mse_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
