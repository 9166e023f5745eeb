// Nearest-centroid assignment for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel kmeans_assign_pallas
// (src/repro/kernels/kmeans_assign.py, body _kmeans_assign_kernel): for
// each of N points, the argmin and the minimum over K centroids of the
// expanded squared distance |x|^2 - 2 x.c + |c|^2, the form the reference
// oracle (ref.kmeans_assign) computes.  Ties go to the lowest centroid
// index, as jnp.argmin.
// Bound on this card: at the main-path shapes (D = 128, K = 16 for shard
// ownership; D = 4, K = 256 for PQ encoding) the work is 2 N K D f32
// operations against 4 N D bytes of points, so with K = 16 it is bound by
// the point bytes and with K = 256 by the f32 SIMT rate.
// Design: the TPU kernel re-enters a (N tile, K tile) grid and carries the
// running (min, argmin) across K steps in its output block; here one block
// walks all K itself.  Centroid tiles (and their norms) are staged in
// shared memory and read by every thread as broadcasts, and the running
// (min, argmin) stays in registers.  For D < 64 one thread owns a point and
// keeps it in registers (a template on the padded width); for D >= 64 one
// warp owns a point, each lane holding a strided slice, and the dot product
// is reduced with warp shuffles.  Ragged K is masked in the tile loop, so
// the caller pads no filler centroids.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = 12 * 1024;  // 48 KB of centroid tile

// one thread per point; DMAX >= D is the register width of a point
template <int DMAX>
__global__ void __launch_bounds__(THREADS)
assign_thread_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ out_i, float* __restrict__ out_d, int N,
                     int K, int D, int tile_k) {
  extern __shared__ float smem[];
  float* cs = smem;                          // tile_k * D
  float* c2 = smem + (size_t)tile_k * D;     // tile_k
  const int n = blockIdx.x * THREADS + threadIdx.x;
  float xv[DMAX];
  float x2 = 0.f;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    xv[d] = (n < N && d < D) ? x[(size_t)n * D + d] : 0.f;
    x2 += xv[d] * xv[d];
  }
  float best = CUDART_INF_F;
  int arg = 0;
  bool first = true;
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
    for (int j = 0; j < kt; ++j) {
      const float* cj = cs + j * D;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) dot += xv[d] * cj[d];
      const float dist = (x2 - 2.0f * dot) + c2[j];
      if (first || dist < best) { best = dist; arg = k0 + j; first = false; }
    }
  }
  if (n < N) {
    out_i[n] = arg;
    out_d[n] = best;
  }
}

// one warp per point; lanes hold a strided slice of the point
__global__ void __launch_bounds__(THREADS)
assign_warp_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   int* __restrict__ out_i, float* __restrict__ out_d, int N,
                   int K, int D, int tile_k) {
  extern __shared__ float smem[];
  float* cs = smem;
  float* c2 = smem + (size_t)tile_k * D;
  const int lane = threadIdx.x % 32;
  const int warps = THREADS / 32;
  const int n = blockIdx.x * warps + threadIdx.x / 32;
  const float* xr = x + (size_t)min(n, N - 1) * D;
  float x2 = 0.f;
  for (int d = lane; d < D; d += 32) x2 += xr[d] * xr[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x2 += __shfl_xor_sync(0xffffffffu, x2, off);
  float best = CUDART_INF_F;
  int arg = 0;
  bool first = true;
  for (int k0 = 0; k0 < K; k0 += tile_k) {
    const int kt = min(tile_k, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kt * D; i += THREADS) cs[i] = c[(size_t)k0 * D + i];
    __syncthreads();
    // centroid norms: one warp per centroid
    for (int j = threadIdx.x / 32; j < kt; j += warps) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += cs[j * D + d] * cs[j * D + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) c2[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < kt; ++j) {
      const float* cj = cs + j * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += xr[d] * cj[d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float dist = (x2 - 2.0f * dot) + c2[j];
      if (first || dist < best) { best = dist; arg = k0 + j; first = false; }
    }
  }
  if (n < N && lane == 0) {
    out_i[n] = arg;
    out_d[n] = best;
  }
}

template <int DMAX>
cudaError_t launch_thread(const float* x, const float* c, int* out_i, float* out_d,
                          int N, int K, int D, int tile_k, cudaStream_t stream) {
  const size_t smem = (size_t)tile_k * (D + 1) * sizeof(float);
  const int blocks = (N + THREADS - 1) / THREADS;
  assign_thread_kernel<DMAX><<<blocks, THREADS, smem, stream>>>(x, c, out_i, out_d, N,
                                                                K, D, tile_k);
  return cudaGetLastError();
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
  // centroid rows per shared-memory tile (plus their norms), at least one
  const int tile_k = max(1, min(K, SMEM_FLOATS / (D + 1)));
  if (tile_k * (D + 1) > SMEM_FLOATS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (D <= 4) e = launch_thread<4>(x, c, out_i, out_d, N, K, D, tile_k, stream);
  else if (D <= 8) e = launch_thread<8>(x, c, out_i, out_d, N, K, D, tile_k, stream);
  else if (D <= 16) e = launch_thread<16>(x, c, out_i, out_d, N, K, D, tile_k, stream);
  else if (D <= 32) e = launch_thread<32>(x, c, out_i, out_d, N, K, D, tile_k, stream);
  else if (D < 64) e = launch_thread<64>(x, c, out_i, out_d, N, K, D, tile_k, stream);
  else {
    const size_t smem = (size_t)tile_k * (D + 1) * sizeof(float);
    const int warps = THREADS / 32;
    const int blocks = (N + warps - 1) / warps;
    assign_warp_kernel<<<blocks, THREADS, smem, stream>>>(x, c, out_i, out_d, N, K, D,
                                                          tile_k);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

}  // extern "C"
