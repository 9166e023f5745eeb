// Exact-distance kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// rerank_distances replaces the TPU kernel rerank_distances_pallas
// (src/repro/kernels/rerank.py, body _rerank_kernel): the dense (Q, N)
// matrix |q|^2 - 2 q.x + |x|^2 (metric 0, squared L2) or -q.x (metric 1).
// Bound on this card: at the probe and ground-truth shapes (D = 128, N in
// the thousands to millions) the work is 2 Q N D f32 operations against
// 4 (Q + N) D + 4 Q N bytes, so it is bound by the f32 SIMT rate
// (67 TFLOP/s) until Q is small, where the (Q, N) output write dominates.
// Design: the TPU schedule (one MXU matmul per tile) does not carry over,
// and this first version stays off the tensor cores so the sums stay full
// f32 (no TF32).  A 64x64 output tile per 256-thread block, D streamed in
// chunks of 16 through shared memory, a 4x4 register block per thread; the
// row norms are summed from the same shared-memory chunks, so q and x are
// read from device memory once per tile.  Ragged Q, N and D are masked in
// the loads and stores: the caller pads nothing.
//
// gather_rerank replaces the TPU kernel gather_rerank_pallas
// (src/repro/kernels/rerank.py, body _gather_rerank_kernel): the exact
// distance from each query to its own P candidate rows, then an ascending
// top-k of those P, with (+inf, -1) for slots whose id is < 0 or >= N and
// for the tail when k > P.  The TPU kernel scans every N tile with a
// one-hot matmul because the TPU has no per-lane gather; Hopper gathers.
// Bound on this card: bytes — each live candidate row (D floats) is read
// once, 4 P D bytes per query against 3 P D operations.  Design: one block
// per query; each warp takes candidate slots, reads the row with 16-byte
// loads (D % 4 == 0) or 4-byte loads, and reduces the direct form
// sum((x - q)^2) (or -q.x) with warp shuffles into dist[P] in shared
// memory.  The top-k is k rounds of block-wide argmin; ties go to the
// lowest slot, as lax.top_k does in the reference.  Duplicate ids are
// scored twice, as in the reference.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int RD_THREADS = 256;

__global__ void __launch_bounds__(RD_THREADS)
rerank_distances_kernel(const float* __restrict__ q, const float* __restrict__ x,
                        float* __restrict__ out, int Q, int N, int D, int metric) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  __shared__ float q2s[BM];
  __shared__ float x2s[BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // threads [0, BM) sum q rows, [BM, BM + BN) sum x rows
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BM * BK; i += RD_THREADS) {
      const int m = i / BK, kk = i % BK;
      const int gr = row0 + m, gk = k0 + kk;
      As[kk][m] = (gr < Q && gk < D) ? q[(size_t)gr * D + gk] : 0.f;
      const int gc = col0 + m;
      Bs[kk][m] = (gc < N && gk < D) ? x[(size_t)gc * D + gk] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm += As[kk][tid] * As[kk][tid];
    } else if (tid < BM + BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm += Bs[kk][tid - BM] * Bs[kk][tid - BM];
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  if (tid < BM) q2s[tid] = nrm;
  else if (tid < BM + BN) x2s[tid - BM] = nrm;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= N) continue;
      const float cross = acc[i][j];
      out[(size_t)r * N + c] = metric == 0
          ? (q2s[ty * TM + i] - 2.0f * cross) + x2s[tx * TN + j]
          : -cross;
    }
  }
}

constexpr int GR_THREADS = 256;
constexpr int GR_WARPS = GR_THREADS / 32;

__device__ __forceinline__ bool better(float d, int s, float bd, int bs) {
  return d < bd || (d == bd && s < bs);
}

// dynamic shared memory: qs[D] floats, dist[P] floats, slot ids[P] ints
__global__ void __launch_bounds__(GR_THREADS)
gather_rerank_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     const int* __restrict__ pids, float* __restrict__ out_d,
                     int* __restrict__ out_i, int N, int D, int P, int k,
                     int metric, bool vec4) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dist = qs + D;
  int* ids = reinterpret_cast<int*>(dist + P);
  __shared__ float red_d[GR_WARPS];
  __shared__ int red_s[GR_WARPS];
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float* qrow = q + (size_t)row * D;
  for (int d = threadIdx.x; d < D; d += GR_THREADS) qs[d] = qrow[d];
  __syncthreads();
  for (int p = warp; p < P; p += GR_WARPS) {
    const int pid = pids[(size_t)row * P + p];
    const bool live = pid >= 0 && pid < N;
    float s = 0.f;
    if (live) {
      const float* xr = x + (size_t)pid * D;
      if (vec4) {
        const float4* xr4 = reinterpret_cast<const float4*>(xr);
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        for (int c = lane; c < D / 4; c += 32) {
          const float4 v = xr4[c];
          const float4 w = q4[c];
          if (metric == 0) {
            const float a = v.x - w.x, b = v.y - w.y, e = v.z - w.z, f = v.w - w.w;
            s += a * a + b * b + e * e + f * f;
          } else {
            s += v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
          }
        }
      } else {
        for (int d = lane; d < D; d += 32) {
          const float v = xr[d];
          if (metric == 0) {
            const float a = v - qs[d];
            s += a * a;
          } else {
            s += v * qs[d];
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      dist[p] = live ? (metric == 0 ? s : -s) : CUDART_INF_F;
      ids[p] = live ? pid : -1;
    }
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    float bd = CUDART_INF_F;
    int bs = INT32_MAX;
    for (int p = threadIdx.x; p < P; p += GR_THREADS) {
      if (better(dist[p], p, bd, bs)) { bd = dist[p]; bs = p; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      if (better(od, os, bd, bs)) { bd = od; bs = os; }
    }
    if (lane == 0) { red_d[warp] = bd; red_s[warp] = bs; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < GR_WARPS; ++w)
        if (better(red_d[w], red_s[w], bd, bs)) { bd = red_d[w]; bs = red_s[w]; }
      const bool hit = bd < CUDART_INF_F;
      out_d[(size_t)row * k + r] = hit ? bd : CUDART_INF_F;
      out_i[(size_t)row * k + r] = hit ? ids[bs] : -1;
      // a taken slot drops out; once only +inf remains every later round
      // writes (+inf, -1), which is also the k > P tail
      if (hit) dist[bs] = CUDART_INF_F;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rerank_distances(const float* q, const float* x, float* out, int Q, int N,
                     int D, int metric, cudaStream_t stream) {
  if (Q <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM);
  rerank_distances_kernel<<<grid, RD_THREADS, 0, stream>>>(q, x, out, Q, N, D, metric);
  return static_cast<int>(cudaGetLastError());
}

int gather_rerank(const float* q, const float* x, const int* pids, float* out_d,
                  int* out_i, int Q, int N, int D, int P, int k, int metric,
                  cudaStream_t stream) {
  if (Q <= 0 || k <= 0) return 0;
  const size_t smem = (size_t)D * sizeof(float) + (size_t)P * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_rerank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec4 = (D % 4) == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  gather_rerank_kernel<<<Q, GR_THREADS, smem, stream>>>(q, x, pids, out_d, out_i, N, D,
                                                        P, k, metric, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
