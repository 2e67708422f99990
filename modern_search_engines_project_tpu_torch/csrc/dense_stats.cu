// Fused per-document dense statistics over one slot-major bucket bank.
//
// Replaces the TPU kernel
//   modern_search_engines_project_tpu/retrieval/dense_pallas.py::_stats_kernel (:55)
// reached through bucket_stats_pallas (:97).
//
// What it computes.  A bucket holds cnt documents with exactly n chunks each,
// stored slot-major: emb[s, d, :] is chunk s of document d (bf16, dim wide).
// For every query b and document d, with x_s = q[b] . emb[s, d] in f32:
//   v1, w1 = the largest x_s and its slot; v2, w2 = the runner-up and its
//   slot; vmin = the smallest x_s.  The streaming recurrence is the TPU's:
//   a strict '>' keeps the LOWEST slot on ties (so a duplicate of the max
//   lands in v2), v2 starts at -inf, and for n == 1 the outputs are
//   (v1, v1, 0, 0, v1).  Only the five [B, cnt] statistics are written; the
//   [B, n, cnt] similarities never reach device memory.
//
// Bound on this card: bytes.  The bank is read once and the five outputs are
// written once; at the 100k-doc bench index that is ~468 MB of bank, ~0.140 /
// 0.149 / 0.178 ms at B = 1 / 16 / 64 over the published 3.35 TB/s.  The
// products are B flop per bank byte (at most 64 at B = 64), far below the
// ~295 flop per byte where the bf16 tensor cores would become the limit.  So
// the design streams the bank once and hides the arithmetic under the loads.
//
// Design, and what it does about each fault of the first (CUDA-core) kernel:
//   * Tensor cores.  mma.sync m16n8k16 bf16 -> f32 with ldmatrix operands:
//     documents on M (a warp owns 16 docs), queries on N.  Each thread's
//     accumulator elements are fixed (doc, query) pairs for every slot, so
//     the top-2 / min fold runs on the fragments in registers after each
//     slot, with no shuffle and no shared-memory round trip.  Each stage's
//     sums come out of the tensor cores fresh and are added to the running
//     f32 sum with an ordinary rounded add, so the tensor core's own
//     accumulation never spans more than one stage's products.
//   * No padding waste at small B.  The query tile is 8, 16, 32 or 64 wide
//     (the smallest that holds B), padded to the mma's N of 8, not 16: B = 1
//     pays for 8 columns of a cheap product and reads no extra bank bytes.
//     B = 64 is one block per doc tile (two warps per 16 docs, 32 queries
//     each), so the bank is read once; above 64 the query tiles of one doc
//     tile are neighbours on the grid and share its rows through L2.
//   * A load pipeline.  The bank streams through a ring of stages in shared
//     memory, filled by the Tensor Memory Accelerator: one thread issues
//     2-d box copies of a tensor map over the bank viewed [n * cnt, dim]
//     (cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so
//     nothing links libcuda; tma.cuh), each stage completing on its own
//     mbarrier.
//     One barrier a stage frees the oldest stage for the next copy.
//   * No bank conflicts.  The boxes arrive with TMA's 128-byte swizzle (16 B
//     chunk c of row r at c ^ (r & 7)), which ldmatrix reads conflict-free;
//     query rows are padded by 16 bytes (an odd number of 16-byte units).
//   * Streaming at the card's rate, large buckets and small.  On the H100
//     one SM streams little more than its 1/132 share of the card's
//     bandwidth, and a block pays a fixed cost a stage (barrier wait,
//     barrier, copy issue) whatever the stage's size (kernel_times.py gives
//     the time of each bucket).  So a bucket with at least one 64-doc tile
//     per SM runs 64-doc blocks (4 warps, stages of 64 docs x 128 dims,
//     16 KB, a 64 KB ring); a smaller one runs 16-doc blocks, four times as
//     many, whose 4 warps split the dims of stages of 16 docs x up to 768
//     dims (24 KB, a 72 KB ring) and add their partial sums in a fixed
//     order at each slot's end.  Ring, query tile and partial sums are dynamic shared
//     memory (cudaFuncAttributeMaxDynamicSharedMemorySize): 77-188 KB a
//     block at dim 768.  Where even an 8-query tile does not fit (dim above
//     ~8,500), the queries are read from device memory (L1/L2) instead.
//   * The grid.  Blocks are persistent: as many as fit on the card at once
//     (occupancy at launch), each keeping one query tile and walking every
//     G-th doc tile, so the query tile (99 KB at B = 64) is staged once a
//     block, not once a doc tile, and the first stages stream while it is
//     staged.  Doc tiles sit on no grid axis, so no bucket size is refused,
//     where the first kernel refused a bucket above 65,535 x 64 docs on
//     grid.y.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using tma::encode_tiled;
using tma::EncodeTiled;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;
using tma::tma_box;

constexpr int kBoxK = 64;          // dims of one TMA box: 128 bytes a row
constexpr int kMaxStages = 16;     // ring depth for the smallest stages
constexpr int kQPad = 8;           // bf16 pad of a query row

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory offset of (row, 16-byte chunk 0..15) in a stage of two
// boxes of `rows` x 128 bytes: TMA's 128-byte swizzle puts chunk c of row r
// at c ^ (r & 7), so an 8-row ldmatrix phase touches 8 distinct 16-byte
// bank groups.
__device__ __forceinline__ uint32_t stage_off(int row, int chunk, int rows) {
  return (chunk >> 3) * rows * 128 + row * 128 +
         (((chunk & 7) ^ (row & 7)) << 4);
}

// One block: DW * 16 docs x (QW * NT * 8) queries, 4 * QW warps.  Warp w
// owns docs (w % DW) * 16 .. +15 and queries (w / 4) * NT * 8 .. +NT*8-1
// (NT n8 tiles); with DW = 1 the KW = 4 warps of a query tile split each
// stage's dims.  `rows` (a multiple of 16 up to DW * 16) is the TMA box
// height: DW * 16 unless the bucket is smaller, and warps past it idle.
// A stage is `boxes` boxes of 64 dims.  kQSmem: the query tile sits in
// shared memory after the ring (rows of q_ld = dim rounded up to a stage,
// plus 8, zero past dim and past B); otherwise B fragments are read from
// device memory.
template <int NT, int QW, int DW, bool kQSmem>
__global__ void __launch_bounds__(128 * QW) stats_kernel(
    const __grid_constant__ CUtensorMap bank, const __nv_bfloat16* __restrict__ q,
    int B, int n, int cnt, int dim, int n_qt, int rows, int boxes,
    int n_stages,
    float* __restrict__ v1_out, float* __restrict__ v2_out,
    int32_t* __restrict__ w1_out, int32_t* __restrict__ w2_out,
    float* __restrict__ vm_out) {
  constexpr int KW = 4 / DW;  // warps that split each stage's dims
  constexpr int kThreads = 128 * QW;
  constexpr int kNQ = QW * NT * 8;
  constexpr int kDocs = 16 * DW;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  // the swizzled boxes want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int stage_bytes = boxes * rows * 128;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (ring - raw) + n_stages * stage_bytes);
  const int kdim = boxes * kBoxK;  // dims a stage
  const int q_ld = (dim + kdim - 1) / kdim * kdim + kQPad;
  // KW > 1: [NT][KW][QW][32 lanes] float4 partial sums, after the queries
  float4* red = reinterpret_cast<float4*>(
      reinterpret_cast<unsigned char*>(qs) + (kQSmem ? kNQ * q_ld * 2 : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dw = warp % DW, kw = (warp / DW) % KW, qw = warp / 4;
  const int g = lane >> 2, t4 = lane & 3;
  // Persistent blocks: block b keeps query tile b % n_qt and walks doc
  // tiles b / n_qt, + G, + 2G, ... (G blocks a query tile), so its query
  // tile is staged once however many doc tiles it scores.
  const int G = gridDim.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kNQ;
  const int first = blockIdx.x / n_qt;
  const int n_dt = (cnt + kDocs - 1) / kDocs;
  const int n_tiles = first < n_dt ? (n_dt - 1 - first) / G + 1 : 0;
  const int kc = (dim + kdim - 1) / kdim;  // stages a slot
  const int per_tile = n * kc;
  const int total = n_tiles * per_tile;

  // The ring: stage `it` holds, of the block's doc tile it / per_tile,
  // slot (it / kc) % n and dims (it % kc) * kdim .. +kdim-1: rows
  // s * cnt + d0 .. +rows-1 of the bank viewed [n * cnt, dim].  Rows past
  // the doc tile belong to the next slot (or are zeros past the bank):
  // their sums are never stored.  Dims past dim arrive as zeros.  The first
  // stages are in flight while the query tile is staged.
  int ld_t = 0, ld_s = 0, ld_c = 0;
  auto produce = [&](int stage) {  // one thread
    const uint32_t bar = smem_u32(&full[stage]);
    const uint32_t dst = ring + stage * stage_bytes;
    const int x = ld_c * kdim;
    const int y = ld_s * cnt + (first + ld_t * G) * kDocs;
    mbar_expect_tx(bar, stage_bytes);
    for (int j = 0; j < boxes; ++j)
      tma_box(dst + j * rows * 128, &bank, x + j * kBoxK, y, bar);
    if (++ld_c == kc) {
      ld_c = 0;
      if (++ld_s == n) {
        ld_s = 0;
        ++ld_t;
      }
    }
  };
  if (tid == 0) {
    for (int j = 0; j < n_stages; ++j) mbar_init(smem_u32(&full[j]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < n_stages - 1 && i < total; ++i) produce(i);
  }
  if constexpr (kQSmem) {  // query tile, 16 bytes a copy
    const int vec = q_ld / 8;
    for (int i = tid; i < kNQ * vec; i += kThreads) {
      const int r = i / vec, c = (i - r * vec) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < B && c < dim)
        v = *reinterpret_cast<const uint4*>(q + (int64_t)(q0 + r) * dim + c);
      *reinterpret_cast<uint4*>(qs + r * q_ld + c) = v;
    }
  }
  __syncthreads();

  float acc[NT][4], v1[NT][4], v2[NT][4], vm[NT][4];
  int w12[NT][4];  // w1 in the low 16 bits, w2 in the high 16
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const bool active = dw * 16 < rows;
  const int a_row = dw * 16 + (lane & 15);
  const int b_row = qw * NT * 8 + (lane & 7);
  int s = 0, c = 0, d0 = first * kDocs;
  int slot = 0, phase = 0, next = n_stages - 1;  // ring positions
  for (int it = 0; it < total; ++it) {
    mbar_wait(smem_u32(&full[slot]), phase);
    __syncthreads();  // every warp is done with stage it - 1: refill it
    if (tid == 0 && it + n_stages - 1 < total) produce(next);
    if (++next == n_stages) next = 0;

    const uint32_t st = ring + slot * stage_bytes;
    const int k0 = c * kdim;
    // this stage's sums (of this warp's dims), in two independent mma chains
    float p[2][NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[h][j][e] = 0.f;
    if (active) {
#pragma unroll 2
      for (int kp = kw; kp < 2 * boxes; kp += KW) {  // two k16 steps a kp
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ldmatrix_x4(
              st + stage_off(a_row, kp * 4 + h * 2 + (lane >> 4), rows), a[h]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[4];  // k16 step 0: b[0], b[1]; step 1: b[2], b[3]
          if constexpr (kQSmem) {
            ldmatrix_x4(smem_u32(qs + (b_row + j * 8) * q_ld + k0 + kp * 32 +
                                 (lane >> 3) * 8),
                        b);
          } else {
            // dims come in whole groups of 32 (dim % 32 == 0)
            const int qb = q0 + qw * NT * 8 + j * 8 + g;
            const bool in = qb < B && k0 + kp * 32 < dim;
            const uint32_t* src = reinterpret_cast<const uint32_t*>(
                q + (in ? (int64_t)qb * dim + k0 + kp * 32 + 2 * t4 : 0));
#pragma unroll
            for (int h = 0; h < 4; ++h) b[h] = in ? __ldg(src + h * 4) : 0u;
          }
          mma_bf16(p[0][j], a[0], b[0], b[1]);
          mma_bf16(p[1][j], a[1], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += p[0][j][e] + p[1][j][e];

    if (++slot == n_stages) {
      slot = 0;
      phase ^= 1;
    }

    if (++c == kc) {  // slot s complete: fold it into the statistics
      if constexpr (KW > 1) {  // sum the KW warps' partial sums, in order
#pragma unroll
        for (int j = 0; j < NT; ++j)
          red[(j * KW * QW + kw * QW + qw) * 32 + lane] =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        __syncthreads();
        if (kw == 0)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int k2 = 1; k2 < KW; ++k2) {
              const float4 o = red[(j * KW * QW + k2 * QW + qw) * 32 + lane];
              acc[j][0] += o.x;
              acc[j][1] += o.y;
              acc[j][2] += o.z;
              acc[j][3] += o.w;
            }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = acc[j][e];
          acc[j][e] = 0.f;
          if (s == 0) {
            v1[j][e] = x;
            v2[j][e] = -INFINITY;
            vm[j][e] = x;
            w12[j][e] = 0;
          } else {
            const int w1 = w12[j][e] & 0xffff, w2 = w12[j][e] >> 16;
            const bool is1 = x > v1[j][e];
            const bool is2 = !is1 && x > v2[j][e];
            v2[j][e] = is1 ? v1[j][e] : (is2 ? x : v2[j][e]);
            const int nw2 = is1 ? w1 : (is2 ? s : w2);
            v1[j][e] = is1 ? x : v1[j][e];
            w12[j][e] = (is1 ? s : w1) | (nw2 << 16);
            vm[j][e] = fminf(vm[j][e], x);
          }
        }
      c = 0;
      if (++s == n) {  // doc tile complete: store it, go to the next
        // Element e of tile j: doc g + 8 * (e >> 1), query 2 * t4 + (e & 1).
        // The 8 lanes of one t4 write 8 neighbouring docs: whole sectors.
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = q0 + qw * NT * 8 + j * 8 + 2 * t4 + (e & 1);
            const int d = d0 + dw * 16 + g + 8 * (e >> 1);
            if (kw != 0 || b >= B || d >= cnt) continue;
            const int64_t o = (int64_t)b * cnt + d;
            v1_out[o] = v1[j][e];
            // single-chunk documents: (v1, v1, 0, 0, v1)
            v2_out[o] = n == 1 ? v1[j][e] : v2[j][e];
            w1_out[o] = w12[j][e] & 0xffff;
            w2_out[o] = w12[j][e] >> 16;
            vm_out[o] = vm[j][e];
          }
        s = 0;
        d0 += G * kDocs;
      }
    }
  }
}

template <int NT, int QW, int DW, bool kQSmem>
cudaError_t launch(const CUtensorMap& map, const void* q, int B, int n,
                   int cnt, int dim, int n_qt, int rows, int boxes,
                   int n_stages, int n_sm, size_t smem, void* const* out,
                   cudaStream_t stream) {
  auto kern = stats_kernel<NT, QW, DW, kQSmem>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 128 * QW,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // G blocks a query tile: as many as fit on the card at once, at most one
  // a doc tile
  const int n_dt = (cnt + 16 * DW - 1) / (16 * DW);
  const int64_t fit = ((int64_t)per_sm * n_sm + n_qt - 1) / n_qt;
  const int G = fit < n_dt ? (int)fit : n_dt;
  if ((int64_t)G * n_qt > INT_MAX) return cudaErrorInvalidConfiguration;
  kern<<<G * n_qt, 128 * QW, smem, stream>>>(
      map, (const __nv_bfloat16*)q, B, n, cnt, dim, n_qt, rows, boxes,
      n_stages, (float*)out[0], (float*)out[1], (int32_t*)out[2],
      (int32_t*)out[3], (float*)out[4]);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mse_dense_stats(const void* q, const void* emb, int B, int n,
                               int cnt, int dim, void* v1, void* v2, void* w1,
                               void* w2, void* vm, void* stream) {
  // slots are packed in 16 bits; dims stream in chunks of 32
  if (B < 1 || cnt < 1 || n < 1 || n > 0xffff || dim < 32 || dim % 32 ||
      (int64_t)n * cnt > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;

  // Query tile: the smallest of 8, 16, 32, 64 that holds B (64 at most, in
  // several tiles beyond), narrowed below if it does not fit shared memory.
  int nq = B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 64;
  // Doc tile: 64 docs (4 warps, a stage of 128 dims) when that gives every
  // SM a block; else 16 docs, whose 4 warps split the dims of a stage of
  // up to 768 dims.  The loop's fixed cost a stage (a barrier wait, a
  // barrier, the copy's issue) then falls on few, long stages, and a small
  // bucket spreads over four times the SMs.
  const int dw =
      (int64_t)((cnt + 63) / 64) * ((B + nq - 1) / nq) >= n_sm ? 4 : 1;
  const int rows = cnt >= 16 * dw ? 16 * dw : (cnt + 15) / 16 * 16;
  const int chunks = (dim + kBoxK - 1) / kBoxK;
  const int boxes = dw == 4 ? 2 : chunks < 12 ? chunks : 12;
  const int stage_bytes = boxes * rows * 128;
  const int ring_bytes = dw == 4 ? 64 * 1024 : 72 * 1024;
  int n_stages = ring_bytes / stage_bytes;
  n_stages = n_stages < 2 ? 2 : n_stages > kMaxStages ? kMaxStages : n_stages;
  const size_t ring = (size_t)n_stages * stage_bytes + 1024;  // + alignment

  const int kdim = boxes * kBoxK;
  const int q_ld = (dim + kdim - 1) / kdim * kdim + kQPad;
  auto q_bytes = [&](int nq) { return (size_t)nq * q_ld * 2; };
  const size_t avail = (size_t)max_smem - 256;  // less the static barriers
  const size_t red_max = 4 * 8 * 32 * 16;  // split-dim partial sums
  while (nq > 8 && ring + q_bytes(nq) + red_max > avail) nq /= 2;
  const bool q_smem = ring + q_bytes(nq) + red_max <= avail;
  const size_t red = dw == 1 ? (size_t)4 * (nq / 8) * 32 * 16 : 0;
  const size_t smem = ring + (q_smem ? q_bytes(nq) : 0) + red;
  const int n_qt = (B + nq - 1) / nq;

  // The bank as a 2-d tensor [n * cnt rows, dim] of bf16, read in boxes of
  // `rows` x 64 dims with the 128-byte swizzle; rows past the end read 0.
  CUtensorMap map;
  const cuuint64_t gdim[2] = {(cuuint64_t)dim, (cuuint64_t)n * cnt};
  const cuuint64_t gstride[1] = {(cuuint64_t)dim * 2};
  const cuuint32_t box[2] = {kBoxK, (cuuint32_t)rows};
  const cuuint32_t estride[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(emb),
             gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  void* const out[5] = {v1, v2, w1, w2, vm};
  const cudaStream_t s = (cudaStream_t)stream;
#define MSE_LAUNCH(NT, QW, DW, QS)                                      \
  launch<NT, QW, DW, QS>(map, q, B, n, cnt, dim, n_qt, rows, boxes, \
                         n_stages, n_sm, smem, out, s)
  if (!q_smem)
    e = dw == 4 ? MSE_LAUNCH(1, 1, 4, false) : MSE_LAUNCH(1, 1, 1, false);
  else if (nq == 8)
    e = dw == 4 ? MSE_LAUNCH(1, 1, 4, true) : MSE_LAUNCH(1, 1, 1, true);
  else if (nq == 16)
    e = dw == 4 ? MSE_LAUNCH(2, 1, 4, true) : MSE_LAUNCH(2, 1, 1, true);
  else if (nq == 32)
    e = dw == 4 ? MSE_LAUNCH(4, 1, 4, true) : MSE_LAUNCH(4, 1, 1, true);
  else
    e = dw == 4 ? MSE_LAUNCH(4, 2, 4, true) : MSE_LAUNCH(4, 2, 1, true);
#undef MSE_LAUNCH
  return (int)e;
}
