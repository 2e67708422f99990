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
// Design.  One block per (16-query tile, 64-document tile), 64 threads; a
// thread owns a 4x4 (query, document) patch.  For each slot the block
// walks the dim axis in 32-wide chunks staged through shared memory (bf16
// loaded 16 bytes at a time, widened to f32), accumulates the 16 dot
// products in f32 registers with FMAs, then folds them into the running
// statistics, which also stay in registers.  The query tile is the fastest
// grid axis, so the blocks that share a document tile run together and
// read its bank rows from L2 rather than from device memory again.  CUDA
// cores, no tensor cores: a simple kernel first.
//
// Bound on this card: the bank is read once — at the 100k-doc bench shape
// ~304,640 chunks x 768 x 2 B = 468 MB by the layout's size, so ~0.14 ms at
// the H100's published 3.35 TB/s; the 2*B*dim FLOP per chunk fit under that
// on the tensor cores, but not on the CUDA cores this simple kernel uses.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kTB = 16;   // queries per block
constexpr int kTD = 64;   // documents per block
constexpr int kKC = 32;   // dim chunk staged in shared memory
constexpr int kThreads = (kTB / 4) * (kTD / 4);  // 64: a 4x4 patch each

__global__ void __launch_bounds__(kThreads) stats_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ emb,
    int B, int n, int cnt, int dim, float* __restrict__ v1_out,
    float* __restrict__ v2_out, int32_t* __restrict__ w1_out,
    int32_t* __restrict__ w2_out, float* __restrict__ vm_out) {
  __shared__ __align__(16) float qs[kKC][kTB];
  __shared__ __align__(16) float es[kKC][kTD + 4];
  const int tid = threadIdx.x;
  const int qi = tid / (kTD / 4);  // 0..3: queries qi*4 .. qi*4+3
  const int di = tid % (kTD / 4);  // 0..15: docs di*4 .. di*4+3
  const int b0 = blockIdx.x * kTB;
  const int d0 = blockIdx.y * kTD;

  float v1[4][4], v2[4][4], vm[4][4];
  int w1[4][4], w2[4][4];

  for (int s = 0; s < n; ++s) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    const __nv_bfloat16* plane = emb + (int64_t)s * cnt * dim;
    for (int k0 = 0; k0 < dim; k0 += kKC) {
      // query chunk: kTB x kKC values, 8 per thread
      for (int i = tid; i < kTB * kKC; i += kThreads) {
        const int b = i / kKC, k = i % kKC;
        qs[k][b] = (b0 + b < B)
                       ? __bfloat162float(q[(int64_t)(b0 + b) * dim + k0 + k])
                       : 0.f;
      }
      // bank chunk: kTD rows x kKC values as 16-byte vectors of 8 bf16
      for (int i = tid; i < kTD * (kKC / 8); i += kThreads) {
        const int d = i / (kKC / 8), kv = (i % (kKC / 8)) * 8;
        float f[8];
        if (d0 + d < cnt) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              plane + (int64_t)(d0 + d) * dim + k0 + kv);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) es[kv + e][d] = f[e];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[k][qi * 4]);
        const float4 e = *reinterpret_cast<const float4*>(&es[k][di * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], ev[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = acc[i][j];
        if (s == 0) {
          v1[i][j] = x;
          w1[i][j] = 0;
          v2[i][j] = -INFINITY;
          w2[i][j] = 0;
          vm[i][j] = x;
        } else {
          const bool is1 = x > v1[i][j];
          const bool is2 = !is1 && x > v2[i][j];
          v2[i][j] = is1 ? v1[i][j] : (is2 ? x : v2[i][j]);
          w2[i][j] = is1 ? w1[i][j] : (is2 ? s : w2[i][j]);
          v1[i][j] = is1 ? x : v1[i][j];
          w1[i][j] = is1 ? s : w1[i][j];
          vm[i][j] = fminf(vm[i][j], x);
        }
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + qi * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + di * 4 + j;
      if (d >= cnt) continue;
      const int64_t o = (int64_t)b * cnt + d;
      v1_out[o] = v1[i][j];
      // single-chunk documents: (v1, v1, 0, 0, v1)
      v2_out[o] = n == 1 ? v1[i][j] : v2[i][j];
      w1_out[o] = w1[i][j];
      w2_out[o] = w2[i][j];
      vm_out[o] = n == 1 ? v1[i][j] : vm[i][j];
    }
  }
}

}  // namespace

extern "C" int mse_dense_stats(const void* q, const void* emb, int B, int n,
                               int cnt, int dim, void* v1, void* v2, void* w1,
                               void* w2, void* vm, void* stream) {
  if (n < 1 || dim % kKC != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((B + kTB - 1) / kTB, (cnt + kTD - 1) / kTD);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)emb, B, n, cnt, dim,
      (float*)v1, (float*)v2, (int32_t*)w1, (int32_t*)w2, (float*)vm);
  return (int)cudaGetLastError();
}
