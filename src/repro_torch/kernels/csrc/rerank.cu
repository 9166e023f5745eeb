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
// once, 4 P D bytes per query against 3 P D operations.
// Design: one block of 16 warps per query.  The gather is latency-bound
// (a row is 512 bytes at D = 128), so a warp loads its share of the pool's
// ids with one coalesced load (a lane an id), hands them out by
// __shfl_sync, and scores 8 slots at a time: their 16-byte row loads are
// all in flight before any sum.  Each lane sums the direct form sum((x - q)^2) (or
// q.x) over its features, as the first version of this kernel did, and the 8 slots' lane sums
// are reduced by a transposed butterfly (at offset 16 a lane keeps 4 slots
// and hands 4 to its partner, at 8 it keeps 2, at 4 one): 9 shuffles
// where one xor tree a slot took 40, each addition pairing the same two
// partial sums as that tree, so every distance keeps its bits.
// The select costs the same whatever k is: each slot becomes one 64-bit key
// (the order-preserving image of its distance, -0.0 taken onto +0.0, above
// 2 slot + (distance is -0.0), keys.cuh), so (distance, slot)
// order is one integer compare, ties go to the lowest slot as lax.top_k
// does, and the key decodes to the scorer's bits; a sentinel slot, or a
// distance that is not below +inf, is the DEAD key.  The keys are sorted
// and the first k written: for P <= 512 by one warp in registers (a
// bitonic network, no block barrier), above that by the block in shared
// memory (a bitonic network with every comparator ascending, so the
// padding to a power of two is virtual; log^2 P barriers).  The shared
// memory is the query and the keys, 4 D + 8 P bytes as before, so every P
// the previous kernel took still fits.  Duplicate ids are scored twice, as
// in the reference.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "keys.cuh"  // make_key, key_score, key_row, warp_sort, butterfly_level

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

constexpr int GR_THREADS = 512;
constexpr int GR_WARPS = GR_THREADS / 32;
constexpr int GU = 8;        // slots a warp scores at once
static_assert(GU == 8, "the butterfly below reduces 8 slots");
constexpr int WARP_SORT_MAX = 16;  // keys a lane holds in the warp sort: P <= 512
// output position e of query row from its key: (score, pool id), or
// (+inf, -1) for DEAD
__device__ __forceinline__ void write_slot(uint64_t key, int e, int row, const int* pids,
                                           float* out_d, int* out_i, int P, int k) {
  const bool hit = key != DEAD;
  out_d[(size_t)row * k + e] = hit ? key_score(key) : CUDART_INF_F;
  out_i[(size_t)row * k + e] = hit ? pids[(size_t)row * P + key_row(key)] : -1;
}

// one warp: the P <= 32 M keys sorted in registers, the first k written
template <int M>
__device__ void warp_select(const uint64_t* keys, int row, const int* pids, float* out_d,
                            int* out_i, int P, int k) {
  const int lane = threadIdx.x & 31;
  uint64_t v[M];
#pragma unroll
  for (int r = 0; r < M; ++r) v[r] = r * 32 + lane < P ? keys[r * 32 + lane] : DEAD;
  warp_sort<M>(v);
#pragma unroll
  for (int r = 0; r < M; ++r)
    if (lane * M + r < k) write_slot(v[r], lane * M + r, row, pids, out_d, out_i, P, k);
  for (int e = 32 * M + lane; e < k; e += 32) write_slot(DEAD, e, row, pids, out_d, out_i, P, k);
}

// dynamic shared memory: qs[D] floats (padded to 16 bytes), then keys[P]
__global__ void __launch_bounds__(GR_THREADS)
gather_rerank_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     const int* __restrict__ pids, float* __restrict__ out_d,
                     int* __restrict__ out_i, int N, int D, int P, int k,
                     int metric, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + (D * sizeof(float) + 15) / 16 * 16);
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float* qrow = q + (size_t)row * D;
  const int* prow = pids + (size_t)row * P;
  for (int d = threadIdx.x; d < D; d += GR_THREADS) qs[d] = qrow[d];
  __syncthreads();
  // each warp scores a contiguous share of the slots
  const int share = (P + GR_WARPS - 1) / GR_WARPS;
  const int s_end = min(P, (warp + 1) * share);
  for (int base = warp * share; base < s_end; base += 32) {
    const int nb = min(32, s_end - base);
    const int my_pid = lane < nb ? prow[base + lane] : -1;
    for (int j0 = 0; j0 < nb; j0 += GU) {
      const float* xr[GU];
      unsigned live = 0;  // bit u: slot j0 + u is scored
      float s[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int pid = __shfl_sync(FULL, my_pid, (j0 + u) & 31);
        const bool ok = j0 + u < nb && pid >= 0 && pid < N;
        live |= static_cast<unsigned>(ok) << u;
        xr[u] = x + (size_t)(ok ? pid : 0) * D;
        s[u] = 0.f;
      }
      if (vec4) {
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        for (int c = lane; c < D / 4; c += 32) {
          float4 v[GU];
#pragma unroll
          for (int u = 0; u < GU; ++u)
            if (live >> u & 1) v[u] = reinterpret_cast<const float4*>(xr[u])[c];
          const float4 w = q4[c];
#pragma unroll
          for (int u = 0; u < GU; ++u) {
            if (!(live >> u & 1)) continue;
            if (metric == 0) {
              const float a = v[u].x - w.x, b = v[u].y - w.y, e = v[u].z - w.z, f = v[u].w - w.w;
              s[u] += a * a + b * b + e * e + f * f;
            } else {
              s[u] += v[u].x * w.x + v[u].y * w.y + v[u].z * w.z + v[u].w * w.w;
            }
          }
        }
      } else {
        for (int d = lane; d < D; d += 32) {
          float v[GU];
#pragma unroll
          for (int u = 0; u < GU; ++u)
            if (live >> u & 1) v[u] = xr[u][d];
          const float qd = qs[d];
#pragma unroll
          for (int u = 0; u < GU; ++u) {
            if (!(live >> u & 1)) continue;
            if (metric == 0) {
              const float a = v[u] - qd;
              s[u] += a * a;
            } else {
              s[u] += v[u] * qd;
            }
          }
        }
      }
      // transposed butterfly: after offsets 16, 8, 4 lane l holds slot
      // j0 + (l >> 2), and offsets 2 and 1 complete its sum
      butterfly_level<4, 16>(s);
      butterfly_level<2, 8>(s);
      butterfly_level<1, 4>(s);
      s[0] += __shfl_xor_sync(FULL, s[0], 2);
      s[0] += __shfl_xor_sync(FULL, s[0], 1);
      const int u = lane >> 2;
      if ((lane & 3) == 0 && j0 + u < nb) {
        const int slot = base + j0 + u;
        keys[slot] = (live >> u & 1) ? make_key(metric == 0 ? s[0] : -s[0], slot) : DEAD;
      }
    }
  }
  __syncthreads();
  if (P <= 32 * WARP_SORT_MAX) {
    if (warp != 0) return;
    if (P <= 32) warp_select<1>(keys, row, pids, out_d, out_i, P, k);
    else if (P <= 64) warp_select<2>(keys, row, pids, out_d, out_i, P, k);
    else if (P <= 128) warp_select<4>(keys, row, pids, out_d, out_i, P, k);
    else if (P <= 256) warp_select<8>(keys, row, pids, out_d, out_i, P, k);
    else warp_select<16>(keys, row, pids, out_d, out_i, P, k);
    return;
  }
  // the block sorts keys[0, P) in place: positions >= P hold virtual DEAD
  // keys, and with every comparator ascending a pair that reaches past P
  // never moves
  auto order = [&](int lo, int hi) {
    if (hi < P && keys[lo] > keys[hi]) {
      const uint64_t t = keys[lo];
      keys[lo] = keys[hi];
      keys[hi] = t;
    }
  };
  int pad = 1;
  while (pad < P) pad <<= 1;
  for (int size = 2; size <= pad; size <<= 1) {
    const int half = size / 2;
    for (int i = threadIdx.x; i < pad / 2; i += GR_THREADS)  // each run against its mirror
      order((i / half) * size + i % half, (i / half) * size + size - 1 - i % half);
    __syncthreads();
    for (int stride = size / 4; stride >= 1; stride >>= 1) {
      for (int i = threadIdx.x; i < pad / 2; i += GR_THREADS)
        order((i / stride) * 2 * stride + i % stride, (i / stride) * 2 * stride + i % stride + stride);
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < k; e += GR_THREADS)
    write_slot(e < P ? keys[e] : DEAD, e, row, pids, out_d, out_i, P, k);
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
  const size_t smem = ((size_t)D * sizeof(float) + 15) / 16 * 16 + (size_t)P * sizeof(uint64_t);
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
