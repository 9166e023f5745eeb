// Dense PQ-ADC scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces pq_scan_pallas of src/repro/kernels/pq_scan.py (body
// _pq_scan_kernel): scores[q, n] = sum_j lut[q, j, codes[n, j]] for every
// (query, row), a dense (Q, N) f32 output with no top-k.
//
// Bound on this card: the output write, 4 Q N bytes (100 MB at Q = 100,
// N = 250k: 0.030 ms at 3.35 TB/s), over N m code bytes and m adds per
// cell.  Beside it stands the gather floor: Q N m lookups at random
// shared-memory addresses (800 M at m = 32, K = 256, Q = 100, N = 250k).
// At one 32-lane wavefront a lookup that is 0.108 ms on 132 SMs at
// 1.755 GHz; with 32 random codes a warp, bank conflicts make it about 3.15
// wavefronts a lookup, 0.34 ms, when each lookup is its own 4-byte load.
//
// Design.  The TPU kernel turns the gather into a one-hot matmul because the
// TPU has no lane gather; Hopper gathers from shared memory.
// - A persistent grid: as many blocks as fit on the SMs walk a list of
//   (query tile, 1,024-row range) work items in query-tile order, each
//   block a contiguous share of the list, so a block stages its query
//   tile's LUTs once and keeps them across every row range it takes: a LUT
//   byte leaves device memory about once a block, not once a row range.
// - The LUTs of W = 4 (or 2, or 1, as shared memory allows) queries are
//   interleaved entry by entry, lut[g][j][c][w], so one 16-byte (8-byte)
//   shared load fetches the entry of all W queries for one (j, code): the
//   W lookups share one address, and a quarter-warp's 8 loads fall in 8
//   bank quads at random, not 32 lanes in 32 banks.  A tile holds up to 8
//   such groups when the LUTs are small.
// - A thread takes one row of the range (consecutive threads, consecutive
//   rows, so each query's output row is written coalesced, once), loads
//   its m code bytes once into registers as 16-byte vectors where
//   m % 16 == 0, m <= 64 and the codes are 16-byte aligned (byte loads
//   otherwise), and reuses them for every query of the tile.
// - Each score adds in subquantizer order from 0 with __fadd_rn, as the
//   plain version (kernels/ref.py pq_adc_scores) does, so the two agree bit
//   for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;        // rows a work item
constexpr int GMAX = 8;              // at most this many query groups a tile
constexpr int SMEM = 227 * 1024;     // dynamic shared bytes a block may take

template <int W>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

template <int W>
__device__ __forceinline__ void add(float* s, const typename Vec<W>::T& v);
template <>
__device__ __forceinline__ void add<1>(float* s, const float& v) { s[0] = __fadd_rn(s[0], v); }
template <>
__device__ __forceinline__ void add<2>(float* s, const float2& v) {
  s[0] = __fadd_rn(s[0], v.x);
  s[1] = __fadd_rn(s[1], v.y);
}
template <>
__device__ __forceinline__ void add<4>(float* s, const float4& v) {
  s[0] = __fadd_rn(s[0], v.x);
  s[1] = __fadd_rn(s[1], v.y);
  s[2] = __fadd_rn(s[2], v.z);
  s[3] = __fadd_rn(s[3], v.w);
}

// W queries' LUT entries interleaved: g groups of M K entries of W floats.
// MV > 0: a row's codes are MV 16-byte vectors held in registers.
template <int W, int MV>
__global__ void __launch_bounds__(THREADS)
pq_scan_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes, int Q, int N,
               int M, int K, int groups, int q_tiles, int ranges, float* __restrict__ out) {
  using T = typename Vec<W>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* lut = reinterpret_cast<T*>(smem);  // [groups][M][K] of W floats
  const int lut_len = M * K;
  const int tq = groups * W;
  const long long items = (long long)q_tiles * ranges;
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;
  int staged = -1;
  for (long long it = first; it < last; ++it) {
    const int qt = static_cast<int>(it / ranges);
    const int row = static_cast<int>(it - (long long)qt * ranges) * THREADS + threadIdx.x;
    const int q0 = qt * tq;
    const int nq = min(tq, Q - q0);
    if (qt != staged) {
      __syncthreads();  // every thread is done with the previous tile
      float* f = reinterpret_cast<float*>(smem);
      for (int e = threadIdx.x; e < tq * lut_len; e += THREADS) {
        const int ql = e / lut_len, jc = e - ql * lut_len;
        f[((ql / W) * lut_len + jc) * W + ql % W] =
            ql < nq ? luts[(size_t)(q0 + ql) * lut_len + jc] : 0.f;
      }
      __syncthreads();
      staged = qt;
    }
    if (row >= N) continue;
    const uint8_t* code = codes + (size_t)row * M;
    uint4 cv[MV > 0 ? MV : 1];
#pragma unroll
    for (int v = 0; v < MV; ++v) cv[v] = __ldg(reinterpret_cast<const uint4*>(code) + v);
    for (int g = 0; g * W < nq; ++g) {
      const T* lg = lut + (size_t)g * lut_len;
      float s[W];
#pragma unroll
      for (int w = 0; w < W; ++w) s[w] = 0.f;
      if (MV > 0) {
#pragma unroll
        for (int v = 0; v < MV; ++v) {
          const unsigned word[4] = {cv[v].x, cv[v].y, cv[v].z, cv[v].w};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int j = v * 16 + b;
            const unsigned c = (word[b / 4] >> (8 * (b % 4))) & 0xffu;
            add<W>(s, lg[j * K + c]);
          }
        }
      } else {
        for (int j = 0; j < M; ++j) add<W>(s, lg[j * K + __ldg(code + j)]);
      }
      float* o = out + (size_t)(q0 + g * W) * N + row;
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (g * W + w < nq) o[(size_t)w * N] = s[w];
    }
  }
}

// queries interleaved a group for (M, K): 4, 2 or 1, as shared memory
// allows; 0 when one query's LUT does not fit
int group_width(int M, int K) {
  const long long per_q = (long long)M * K * 4;
  if (M <= 0 || K <= 0) return 0;
  for (int w = 4; w >= 1; w /= 2)
    if (w * per_q <= SMEM) return w;
  return 0;
}

template <int W>
int launch(const float* luts, const uint8_t* codes, int Q, int N, int M, int K, int groups,
           int mv, float* out, cudaStream_t stream) {
  static void (*const kernels[5])(const float*, const uint8_t*, int, int, int, int, int, int, int,
                                  float*) = {pq_scan_kernel<W, 0>, pq_scan_kernel<W, 1>,
                                             pq_scan_kernel<W, 2>, pq_scan_kernel<W, 3>,
                                             pq_scan_kernel<W, 4>};
  auto kernel = kernels[mv];
  const int tq = groups * W;
  const size_t smem = (size_t)tq * M * K * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  const int q_tiles = (Q + tq - 1) / tq;
  const int ranges = (N + THREADS - 1) / THREADS;
  const long long items = (long long)q_tiles * ranges;
  const long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(grid < items ? grid : items);
  kernel<<<blocks, THREADS, smem, stream>>>(luts, codes, Q, N, M, K, groups, q_tiles, ranges, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// queries per block for (M, K); 0 when one query's LUT does not fit
int pq_scan_tile(int M, int K) {
  const int w = group_width(M, K);
  if (w == 0) return 0;
  const long long g = SMEM / ((long long)w * M * K * 4);
  return w * static_cast<int>(g < GMAX ? g : GMAX);
}

// scores (Q, N) f32 from luts (Q, M, K) f32 and codes (N, M) uint8.
// Returns a CUDA error code.
int pq_scan(const float* luts, const uint8_t* codes, int Q, int N, int M, int K, float* out,
            cudaStream_t stream) {
  if (Q <= 0 || N <= 0) return 0;
  const int w = group_width(M, K);
  const int tq = pq_scan_tile(M, K);
  if (tq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = M % 16 == 0 && M <= 64 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const int mv = vec ? M / 16 : 0;
  if (w == 4) return launch<4>(luts, codes, Q, N, M, K, tq / 4, mv, out, stream);
  if (w == 2) return launch<2>(luts, codes, Q, N, M, K, tq / 2, mv, out, stream);
  return launch<1>(luts, codes, Q, N, M, K, tq, mv, out, stream);
}

}  // extern "C"
