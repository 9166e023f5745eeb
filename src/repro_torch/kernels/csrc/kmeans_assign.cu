// Nearest-centroid assignment for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kmeans_assign_pallas
// (src/repro/kernels/kmeans_assign.py, body _kmeans_assign_kernel): for
// each of N points, the argmin and the minimum over K centroids of the
// expanded squared distance |x|^2 - 2 x.c + |c|^2, the form the reference
// oracle (ref.kmeans_assign) computes.  Ties go to the lowest centroid
// index, as jnp.argmin.
//
// Bound on this card: 2 N K D f32 operations against 4 N D bytes of points.
// At the shard-ownership and Stage-0 shapes (D = 128, K = 16, N up to 250k)
// that is the point bytes (0.039 ms for 250k points at 3.35 TB/s); at the
// PQ-encode shape (D = 4, K = 256, N = 8,192 a batch, 97 % of the main
// path's launches) it is the f32 SIMT rate, and at well under a microsecond
// the launch itself.
//
// Design: the TPU kernel re-enters a (N tile, K tile) grid and carries the
// running (min, argmin) across K steps in its output block; here a group of
// lanes walks all K itself.  Every (point, centroid) distance is summed in the order
// the first version of this kernel (a thread or a warp a point) summed it,
// so the outputs keep its bits:
//
// - D < 64 (PQ encoding): a group of 8 lanes owns a point, every lane
//   holding the whole point in registers and scanning every 8th centroid of
//   the tile (neighbouring lanes read neighbouring centroids, so the tile
//   reads are conflict-free; at D = 4 a centroid is one float4).  N = 8,192
//   fills 256 blocks where one thread a point filled 32.  |x|^2, |c|^2 and
//   x.c are sequential sums in feature order, and the group's (min, argmin)
//   is combined with three __shfl_xor_sync steps, ties to the lower index.
// - D >= 64: lane l of a warp sums features d = l, l + 32, ... of each
//   dot product, as the warp-per-point version did, and the 32 lanes'
//   partial sums of 16 centroids are reduced with a transposed butterfly
//   (butterfly16 below): 16 shuffles give every lane pair (2c, 2c + 1)
//   centroid c's total where the xor tree of one centroid at a time took
//   80, and each addition pairs the same two partial sums as that tree, so
//   the totals keep their bits.  Each lane keys its (distance, centroid),
//   and one warp min over the keys (two __reduce_min_sync) gives the
//   point's.  At the main path's shapes (K <= 16, D <= 128: shard
//   ownership and Stage 0) every warp holds all centroids and their norms
//   in registers for the whole launch, walks points a grid of warps apart
//   (two blocks an SM), and loads the next point while it scores one, each
//   a coalesced warp load a 32-feature slice, so no shared memory is read at all.  Other
//   shapes stage the centroids in shared memory in tiles, a warp a point.
//
// All paths reproduce the sequential scan's answer, "take centroid 0, then
// any strictly smaller distance": a NaN distance never wins unless it is
// centroid 0's, which then stands.  Ragged K is masked in the tile loop, so
// the caller pads no filler centroids.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "keys.cuh"  // make_key, key_score, key_row, butterfly_level

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_FLOATS = 12 * 1024;  // 48 KB: centroid tile and norms
constexpr int GROUP = 8;                // lanes a point, D < 64
constexpr int GROUP_POINTS = THREADS / GROUP;
constexpr int CB = 16;                  // centroids a butterfly reduces
constexpr int REG_BLOCKS = 2;           // blocks an SM of the register kernel (<= 128 registers)

// the smallest key over the warp, on every lane
__device__ __forceinline__ uint64_t warp_min(uint64_t key) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t mh = __reduce_min_sync(FULL, hi);
  const uint32_t ml = __reduce_min_sync(FULL, hi == mh ? static_cast<uint32_t>(key) : 0xffffffffu);
  return (static_cast<uint64_t>(mh) << 32) | ml;
}

// stage centroids [k0, k0 + kt) and their norms: one warp a norm, lanes
// strided over the features and an xor tree
__device__ __forceinline__ void stage_tile(const float* __restrict__ c, float* cs, float* c2,
                                           int k0, int kt, int D) {
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kt * D; i += THREADS) cs[i] = c[(size_t)k0 * D + i];
  __syncthreads();
  for (int j = threadIdx.x / 32; j < kt; j += WARPS) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += cs[j * D + d] * cs[j * D + d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) c2[j] = s;
  }
  __syncthreads();
}

// D < 64: GROUP lanes a point; DMAX >= D is the register width of a point
template <int DMAX>
__global__ void __launch_bounds__(THREADS)
assign_group_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    int* __restrict__ out_i, float* __restrict__ out_d, int N,
                    int K, int D, int tile_k) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                          // tile_k * D
  float* c2 = smem + (size_t)tile_k * D;     // tile_k
  const int g = threadIdx.x % GROUP;
  const int n = blockIdx.x * GROUP_POINTS + threadIdx.x / GROUP;
  float xv[DMAX];
  float x2 = 0.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    xv[d] = (n < N && d < D) ? x[(size_t)n * D + d] : 0.f;
    x2 += xv[d] * xv[d];
  }
  float best = CUDART_INF_F, d0 = 0.f;
  int arg = INT32_MAX;
  for (int k0 = 0; k0 < K; k0 += tile_k) {
    const int kt = min(tile_k, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kt * D; i += THREADS) cs[i] = c[(size_t)k0 * D + i];
    __syncthreads();
    for (int j = threadIdx.x; j < kt; j += THREADS) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += cs[j * D + d] * cs[j * D + d];
      c2[j] = s;
    }
    __syncthreads();
    for (int j = g; j < kt; j += GROUP) {
      const float* cj = cs + j * D;
      float dot = 0.f;
      if (DMAX == 4 && D == 4) {
        const float4 cv = *reinterpret_cast<const float4*>(cj);
        dot += xv[0] * cv.x;
        dot += xv[1] * cv.y;
        dot += xv[2] * cv.z;
        dot += xv[3] * cv.w;
      } else {
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) dot += xv[d] * cj[d];
      }
      const float dist = (x2 - 2.0f * dot) + c2[j];
      if (k0 + j == 0) d0 = dist;
      if (dist < best || (dist == best && k0 + j < arg)) { best = dist; arg = k0 + j; }
    }
  }
#pragma unroll
  for (int off = 1; off < GROUP; off <<= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int oa = __shfl_xor_sync(FULL, arg, off);
    if (ob < best || (ob == best && oa < arg)) { best = ob; arg = oa; }
  }
  if (g == 0 && n < N) {
    // lane 0 of the group scored centroid 0: a NaN there stands
    const bool nan0 = d0 != d0;
    out_i[n] = nan0 ? 0 : arg;
    out_d[n] = nan0 ? d0 : best;
  }
}

// the 16 lane partial sums v[j] of a warp, reduced by a transposed
// butterfly (keys.cuh): at offset 16 a lane keeps 8 values and hands its
// partner the other 8, at 8 it keeps 4, at 4 two, at 2 one; offset 1
// completes the sum.  Lane l returns value l >> 1, with the bits of the xor
// tree of one value at a time.
__device__ __forceinline__ float butterfly16(float (&v)[CB]) {
  butterfly_level<8, 16>(v);
  butterfly_level<4, 8>(v);
  butterfly_level<2, 4>(v);
  butterfly_level<1, 2>(v);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// lane 0 writes point n from the warp's smallest key: its (distance,
// centroid), or centroid 0's distance d0 where that is NaN or no key is
// live (every distance NaN or +inf), as the sequential scan keeps it
__device__ __forceinline__ void write_point(uint64_t m, float d0, int n, int* out_i,
                                            float* out_d) {
  const bool keep0 = d0 != d0 || m == DEAD;
  out_i[n] = keep0 ? 0 : key_row(m);
  out_d[n] = keep0 ? d0 : key_score(m);
}

// point n's features l + 32 t on lane l (zeros past D or N)
template <int NCH>
__device__ __forceinline__ void load_slice(float (&dst)[NCH], const float* __restrict__ x, int n,
                                           int N, int D) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < NCH; ++t) {
    const int d = lane + 32 * t;
    dst[t] = (n < N && d < D) ? x[(size_t)n * D + d] : 0.f;
  }
}

// 32 (NCH - 1) < D <= 32 NCH and K <= CB (shard ownership, Stage 0): a warp
// keeps every centroid in registers, lane l holding features l + 32 t, and
// walks points a grid of warps apart
template <int NCH>
__global__ void __launch_bounds__(THREADS, REG_BLOCKS)
assign_reg_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  int* __restrict__ out_i, float* __restrict__ out_d, int N, int K, int D) {
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * WARPS;
  float cr[CB][NCH];
  float v[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < NCH; ++t) {
      const int d = lane + 32 * t;
      cr[j][t] = (j < K && d < D) ? c[(size_t)j * D + d] : 0.f;
      if (d < D) s += cr[j][t] * cr[j][t];
    }
    v[j] = s;
  }
  const float c2 = butterfly16(v);  // |c|^2 of centroid lane >> 1
  // the next point's slice is loaded before this one is scored, so each
  // load has a point's work to land (deeper rings measured slower)
  const int first = blockIdx.x * WARPS + threadIdx.x / 32;
  float next[NCH];
  load_slice<NCH>(next, x, first, N, D);
  for (int n = first; n < N; n += stride) {
    float xv[NCH];
#pragma unroll
    for (int t = 0; t < NCH; ++t) xv[t] = next[t];
    load_slice<NCH>(next, x, n + stride, N, D);
    float x2 = 0.f;
#pragma unroll
    for (int t = 0; t < NCH; ++t)
      if (lane + 32 * t < D) x2 += xv[t] * xv[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x2 += __shfl_xor_sync(FULL, x2, off);
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < NCH; ++t)
        if (lane + 32 * t < D) dot += xv[t] * cr[j][t];
      v[j] = dot;
    }
    const int j = lane >> 1;
    const float dist = (x2 - 2.0f * butterfly16(v)) + c2;
    const uint64_t m = warp_min(j < K ? make_key(dist, j) : DEAD);
    if (lane == 0) write_point(m, dist, n, out_i, out_d);
  }
}

// any other D >= 64: a warp owns a point, the centroids pass through shared
// memory in tiles, CB at a time through the butterfly
__global__ void __launch_bounds__(THREADS)
assign_warp_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   int* __restrict__ out_i, float* __restrict__ out_d, int N,
                   int K, int D, int tile_k) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                          // tile_k * D
  float* c2 = smem + (size_t)tile_k * D;     // tile_k
  const int lane = threadIdx.x % 32;
  const bool one_tile = tile_k >= K;
  if (one_tile) stage_tile(c, cs, c2, 0, K, D);
  for (int n0 = blockIdx.x * WARPS; n0 < N; n0 += gridDim.x * WARPS) {
    // every warp takes each step, so the block's barriers line up
    const int n = n0 + threadIdx.x / 32;
    const float* xr = x + (size_t)min(n, N - 1) * D;
    float x2 = 0.f;
    for (int d = lane; d < D; d += 32) x2 += xr[d] * xr[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x2 += __shfl_xor_sync(FULL, x2, off);
    uint64_t key = DEAD;
    float d0 = 0.f;
    for (int k0 = 0; k0 < K; k0 += tile_k) {
      const int kt = min(tile_k, K - k0);
      if (!one_tile) {
        __syncthreads();  // every warp is done with the previous tile
        stage_tile(c, cs, c2, k0, kt, D);
      }
      for (int cb = 0; cb < kt; cb += CB) {
        float v[CB];
#pragma unroll
        for (int j = 0; j < CB; ++j) v[j] = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float xv = xr[d];
#pragma unroll
          for (int j = 0; j < CB; ++j)  // rows past the tile repeat its last; dropped below
            v[j] += xv * cs[min(cb + j, kt - 1) * D + d];
        }
        const int j = cb + (lane >> 1);
        const float dist = (x2 - 2.0f * butterfly16(v)) + c2[min(j, kt - 1)];
        if (k0 + j == 0) d0 = dist;
        const uint64_t kk = j < kt ? make_key(dist, k0 + j) : DEAD;
        key = kk < key ? kk : key;
      }
    }
    const uint64_t m = warp_min(key);
    if (lane == 0 && n < N) write_point(m, d0, n, out_i, out_d);
  }
}

template <int DMAX>
cudaError_t launch_group(const float* x, const float* c, int* out_i, float* out_d,
                         int N, int K, int D, int tile_k, cudaStream_t stream) {
  const size_t smem = (size_t)tile_k * (D + 1) * sizeof(float);
  const int blocks = (N + GROUP_POINTS - 1) / GROUP_POINTS;
  assign_group_kernel<DMAX><<<blocks, THREADS, smem, stream>>>(x, c, out_i, out_d, N, K,
                                                               D, tile_k);
  return cudaGetLastError();
}

// the current device's SM count (a cheap attribute read, so never cached)
cudaError_t sm_count(int* count) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int kmeans_assign(const float* x, const float* c, int* out_i, float* out_d, int N,
                  int K, int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (K <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D + 1 > SMEM_FLOATS) return static_cast<int>(cudaErrorInvalidValue);
  if (D < 64) {
    // centroid rows per shared-memory tile (plus their norms)
    const int tile_k = max(1, min(K, SMEM_FLOATS / (D + 1)));
    if (D <= 4) return static_cast<int>(launch_group<4>(x, c, out_i, out_d, N, K, D, tile_k, stream));
    if (D <= 8) return static_cast<int>(launch_group<8>(x, c, out_i, out_d, N, K, D, tile_k, stream));
    if (D <= 16) return static_cast<int>(launch_group<16>(x, c, out_i, out_d, N, K, D, tile_k, stream));
    if (D <= 32) return static_cast<int>(launch_group<32>(x, c, out_i, out_d, N, K, D, tile_k, stream));
    return static_cast<int>(launch_group<64>(x, c, out_i, out_d, N, K, D, tile_k, stream));
  }
  const int blocks_needed = (N + WARPS - 1) / WARPS;  // a point a warp
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (K <= CB && D <= 128) {
    const int blocks = min(blocks_needed, REG_BLOCKS * sms);
    if (D <= 64)
      assign_reg_kernel<2><<<blocks, THREADS, 0, stream>>>(x, c, out_i, out_d, N, K, D);
    else if (D <= 96)
      assign_reg_kernel<3><<<blocks, THREADS, 0, stream>>>(x, c, out_i, out_d, N, K, D);
    else
      assign_reg_kernel<4><<<blocks, THREADS, 0, stream>>>(x, c, out_i, out_d, N, K, D);
    return static_cast<int>(cudaGetLastError());
  }
  const int tile_k = max(1, min(K, SMEM_FLOATS / (D + 1)));
  const size_t smem = (size_t)tile_k * (D + 1) * sizeof(float);
  const int blocks = min(blocks_needed, 4 * sms);
  assign_warp_kernel<<<blocks, THREADS, smem, stream>>>(x, c, out_i, out_d, N, K, D, tile_k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
