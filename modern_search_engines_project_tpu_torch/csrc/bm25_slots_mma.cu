// Slot-layout U-dedup BM25 kernel that recovers the per-query weights as a
// matrix product on the tensor cores, for Hopper.
//
// Replaces the TPU kernel in modern_search_engines_project_tpu/retrieval/bm25_pallas.py:
//   mse_bm25_slots_udedup_wide_bf16 <- _kernel_slots_udedup_wide (:327), i8=False ("wide")
//   mse_bm25_slots_udedup_wide_i8   <- _kernel_slots_udedup_wide (:327), i8=True  ("wide_i8")
// (Kernel 5, "acc", shares the streaming body of kernels 1-3 in
// bm25_slots.cu.)
//
// Same operands and keyed contract as the U-dedup kernels of bm25_slots.cu:
// slot postings (term id int32 pad -1, impact f32 pad 0) walked through the
// flat group table; uids [U] distinct real ids and pads -2; w [2B, U] f32
// with small-integer weights in rows [0, B) and presence rows [B, 2B);
// out[b, g*512 + c] = (count > 0 && score >= 0) ? score : -1.
//
// Unlike kernels 2-3 (which look up u* and read w[b, u*] directly), it
// computes the TPU kernel's product on the tensor cores (nvcuda::wmma,
// m16n16k16), the weights packed k16-blocked by pack_weights_kernel:
//
// a block owns 16 doc columns of one group and walks its rows 8 at a time
// (128 postings a step).  Each posting's u* (hash lookup, uid_table.cuh)
// sets one 1 in a zeroed 0/1 match tile MU [U chunk x 128 postings] in
// shared memory (reset after use), and mw = bf16(w[:B]) @ MU (f32 sums) or
// int8(w[:B]) @ MU (s32 sums) runs over U in chunks of 128.  Then, per
// (query, column), in row order: score += mw * impact, count += (mw > 0) --
// presence derived from the weight, as on the TPU.  The product is exact
// (integer weights, 0/1 matches), so the scores equal kernel 2's and 3's
// bit for bit.  Bound: 2*B*U operations a posting slot on the tensor cores
// (989 TFLOP/s bf16, 1,979 TOP/s int8); per k16 step a warp reads its A
// tiles and one B tile from shared memory, so shared-memory bandwidth sets
// the pace.  The weight rows stay in shared memory when they fit, else the
// A tiles are read from device memory (any U).
//
// It takes any B (grid.y chunks of 64 queries, padded to 16) and any U
// (padded to 128; above uid_table::kSmemMaxU the uid hash table lives in
// device memory, as in bm25_slots.cu).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "uid_table.cuh"

namespace {

using namespace nvcuda;

constexpr int kCols = 512;      // doc columns per group (SLOT_COLS)
constexpr int kThreads = 256;   // 8 warps
constexpr int kQB = 64;         // queries per block (4 m16 tiles)
constexpr int kUAlign = 128;    // U is padded to this
constexpr int kSmemMax = 232448;  // 227 KB: what one block may use

// wide: postings per step and U per K chunk
constexpr int kWRows = 8;
constexpr int kWCols = 16;
constexpr int kWN = kWRows * kWCols;  // 128 = 8 n16 tiles, one per warp
constexpr int kWKc = 128;

constexpr int kTableBytes = 2 * uid_table::kSmemSize * 4;

template <typename T>
struct Acc;
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};
template <>
struct Acc<signed char> {
  using type = int;
};

template <typename T>
__device__ __forceinline__ T to_w(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_w<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ signed char to_w<signed char>(float v) {
  return (signed char)(int)v;
}

__device__ __forceinline__ float keyed(float s, float c) {
  return (c > 0.f && s >= 0.f) ? s : -1.f;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// rows [row0, row0 + B) of w [*, U] -> dst k16-blocked: element (b, u) at
// ((u / 16) * Bp + b) * 16 + u % 16, zero for b >= B or u >= U.  An m16 x
// k16 tile is then 512 contiguous bytes (bf16), loadable with ldm = 16.
template <typename T>
__global__ void pack_weights_kernel(const float* __restrict__ w, int row0,
                                    int B, int U, int Bp, int Up,
                                    T* __restrict__ dst) {
  const int64_t n = (int64_t)Bp * Up;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(i & 15);
    const int64_t r = i >> 4;
    const int b = (int)(r % Bp);
    const int u = (int)(r / Bp) * 16 + k;
    const float v =
        (b < B && u < U) ? w[(int64_t)(row0 + b) * U + u] : 0.f;
    dst[i] = to_w<T>(v);
  }
}

template <typename T>
int pack_weights(const float* w, int row0, int B, int U, int Bp, int Up,
                 T* dst, cudaStream_t s) {
  const int64_t n = (int64_t)Bp * Up;
  const int grid = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  pack_weights_kernel<T><<<grid, 256, 0, s>>>(w, row0, B, U, Bp, Up, dst);
  return (int)cudaGetLastError();
}

// ---- wide ------------------------------------------------------------------

struct WideLayout {  // byte offsets into dynamic shared memory
  int mu, c, x, table, a, total;
  __host__ __device__ WideLayout(int elem, int Up, int a_rows, bool smem_table,
                                 bool a_in_smem) {
    mu = 0;
    c = mu + kWKc * kWN * elem;
    x = c + kQB * kWN * 4;
    table = x + kWN * 4;
    a = table + (smem_table ? kTableBytes : 0);
    total = a + (a_in_smem ? Up * a_rows * elem : 0);
  }
};

template <typename T, bool kSmemTable>
__global__ void __launch_bounds__(kThreads) wide_kernel(
    const int32_t* __restrict__ terms, const float* __restrict__ impact,
    const int64_t* __restrict__ group_off, const int32_t* __restrict__ group_rows,
    const int32_t* __restrict__ uids, int U, const T* __restrict__ wpk, int Bp,
    int Up, int B, float* __restrict__ out, int64_t ld_out,
    const int32_t* __restrict__ g_table, int g_bits, int a_in_smem) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int a_rows = min(kQB, Bp);
  const WideLayout L(sizeof(T), Up, a_rows, kSmemTable, a_in_smem);
  T* s_mu = (T*)(smem + L.mu);
  A* s_c = (A*)(smem + L.c);
  float* s_x = (float*)(smem + L.x);
  int32_t* s_key = (int32_t*)(smem + L.table);
  int32_t* s_slot = s_key + uid_table::kSmemSize;
  T* s_a = (T*)(smem + L.a);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tiles = kCols / kWCols;
  const int g = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * kWCols;
  const int q0 = blockIdx.y * kQB;
  const int nq = min(kQB, B - q0);         // real queries of this block
  const int mrows = min(kQB, Bp - q0);     // padded rows, a multiple of 16
  const int mt = mrows / 16;

  // zero the match tile once; every 1 set below is reset after its chunk
  for (int i = tid; i < kWKc * kWN * (int)sizeof(T) / 16; i += kThreads)
    ((int4*)s_mu)[i] = make_int4(0, 0, 0, 0);
  if (a_in_smem) {  // this block's weight rows, k16-blocked [Up/16][mrows][16]
    const int per = mrows * 16 * (int)sizeof(T) / 16;  // int4 per k16 block
    for (int i = tid; i < (Up / 16) * per; i += kThreads) {
      const int kb = i / per, j = i - kb * per;
      ((int4*)s_a)[i] =
          ((const int4*)(wpk + ((int64_t)kb * Bp + q0) * 16))[j];
    }
  }
  if constexpr (kSmemTable) uid_table::build_shared(s_key, s_slot, uids, U);
  const int bits = kSmemTable ? uid_table::kSmemBits : g_bits;
  const int32_t* keys = kSmemTable ? s_key : g_table;
  const int32_t* slots = kSmemTable ? s_slot : g_table + ((size_t)1 << g_bits);
  __syncthreads();

  const T one = to_w<T>(1.f);
  const T zero = to_w<T>(0.f);
  float sc[4], pc[4];  // (query, column) pairs tid + 256 i: q = p / 16, c = p % 16
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[i] = pc[i] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, A> acc[4];
  const int64_t base = group_off[g] + c0;
  const int rows = group_rows[g];
  for (int r0 = 0; r0 < rows; r0 += kWRows) {
    int my_u = -1;  // thread n < 128 owns posting n = (row r0 + n / 16, col n % 16)
    if (tid < kWN) {
      const int r = r0 + tid / kWCols;
      float x = 0.f;
      if (r < rows) {
        const int64_t at = base + (int64_t)r * kCols + tid % kWCols;
        const int32_t t = __ldg(terms + at);
        if (t >= 0) my_u = uid_table::lookup(keys, slots, bits, t);
        if (my_u >= 0) x = __ldg(impact + at);
      }
      s_x[tid] = x;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[m], (A)0);
    for (int k0 = 0; k0 < Up; k0 += kWKc) {
      const bool mine = my_u >= k0 && my_u < k0 + kWKc;
      const int at = (((my_u - k0) >> 4) * kWN + tid) * 16 + ((my_u - k0) & 15);
      if (mine) s_mu[at] = one;
      __syncthreads();
#pragma unroll 2
      for (int kb = 0; kb < kWKc / 16; ++kb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, s_mu + (kb * kWN + warp * 16) * 16, 16);
        const int kg = k0 / 16 + kb;  // k16 block of U
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < mt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
            const T* ap = a_in_smem
                              ? s_a + ((int64_t)kg * mrows + m * 16) * 16
                              : wpk + ((int64_t)kg * Bp + q0 + m * 16) * 16;
            wmma::load_matrix_sync(a, ap, 16);
            wmma::mma_sync(acc[m], a, b, acc[m]);
          }
        }
      }
      __syncthreads();
      if (mine) s_mu[at] = zero;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m < mt)
        wmma::store_matrix_sync(s_c + m * 16 * kWN + warp * 16, acc[m], kWN,
                                wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = tid + i * kThreads;
      const int q = p / kWCols, c = p % kWCols;
      if (q < nq) {
#pragma unroll
        for (int r = 0; r < kWRows; ++r) {
          const float mw = (float)s_c[q * kWN + r * kWCols + c];
          sc[i] += mw * s_x[r * kWCols + c];
          pc[i] += (mw > 0.f) ? 1.f : 0.f;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tid + i * kThreads;
    const int q = p / kWCols, c = p % kWCols;
    if (q < nq)
      out[(int64_t)(q0 + q) * ld_out + (int64_t)g * kCols + c0 + c] =
          keyed(sc[i], pc[i]);
  }
}

template <typename T>
int launch_wide(const void* terms, const void* impact, const void* group_off,
                const void* group_rows, int n_groups, const void* uids, int U,
                const void* w, int B, void* out, int64_t ld_out, void* table,
                int64_t table_len, void* scratch, int64_t scratch_len,
                void* stream) {
  if (U < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int Bp = round_up(B, 16), Up = round_up(U, kUAlign);
  if (scratch == nullptr || scratch_len < (int64_t)Bp * Up * (int64_t)sizeof(T))
    return (int)cudaErrorInvalidValue;
  T* wpk = (T*)scratch;
  int rc = pack_weights<T>((const float*)w, 0, B, U, Bp, Up, wpk, s);
  if (rc != 0) return rc;
  const bool smem_table = U <= uid_table::kSmemMaxU;
  int bits = 0;
  if (!smem_table) {
    bits = uid_table::global_bits(U);
    if (table == nullptr || table_len < (int64_t)2 << bits)
      return (int)cudaErrorInvalidValue;
    rc = uid_table::build_global((const int32_t*)uids, U, (int32_t*)table,
                                 bits, s);
    if (rc != 0) return rc;
  }
  const int a_rows = Bp < kQB ? Bp : kQB;
  const bool a_in_smem =
      WideLayout(sizeof(T), Up, a_rows, smem_table, true).total <= kSmemMax;
  const int bytes =
      WideLayout(sizeof(T), Up, a_rows, smem_table, a_in_smem).total;
  auto kern = smem_table ? wide_kernel<T, true> : wide_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_groups * (kCols / kWCols), (B + kQB - 1) / kQB);
  kern<<<grid, kThreads, bytes, s>>>(
      (const int32_t*)terms, (const float*)impact, (const int64_t*)group_off,
      (const int32_t*)group_rows, (const int32_t*)uids, U, wpk, Bp, Up, B,
      (float*)out, ld_out, (const int32_t*)table, bits, (int)a_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mse_bm25_slots_udedup_wide_bf16(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* table,
    int64_t table_len, void* scratch, int64_t scratch_len, void* stream) {
  return launch_wide<__nv_bfloat16>(terms, impact, group_off, group_rows,
                                    n_groups, uids, U, w, B, out, ld_out, table,
                                    table_len, scratch, scratch_len, stream);
}

extern "C" int mse_bm25_slots_udedup_wide_i8(
    const void* terms, const void* impact, const void* group_off,
    const void* group_rows, int n_groups, const void* uids, int U,
    const void* w, int B, void* out, int64_t ld_out, void* table,
    int64_t table_len, void* scratch, int64_t scratch_len, void* stream) {
  return launch_wide<signed char>(terms, impact, group_off, group_rows,
                                  n_groups, uids, U, w, B, out, ld_out, table,
                                  table_len, scratch, scratch_len, stream);
}
