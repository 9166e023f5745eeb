// Dense PQ-ADC scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces pq_scan_pallas of src/repro/kernels/pq_scan.py (body
// _pq_scan_kernel): scores[q, n] = sum_j lut[q, j, codes[n, j]] for every
// (query, row), a dense (Q, N) f32 output with no top-k.
//
// Design.  The TPU kernel turns the gather into a one-hot matmul because the
// TPU has no lane gather.  Hopper gathers from shared memory, so this is the
// masked ADC tile of masked_topk.cu without its select: a block stages the
// LUTs of a few queries (m K 4 bytes each, 32 KB at m = 32, K = 256) and a
// chunk of CN rows' codes (uint8, one contiguous range) in shared memory,
// and each thread scores whole rows, adding in subquantizer order from 0 as
// the plain version (kernels/ref.py pq_adc_scores) does, so the two agree
// bit for bit.  Consecutive threads take consecutive rows, so the (Q, N)
// output is written coalesced, once.
//
// Bound on this card: the output write, 4 Q N bytes (100 MB at Q = 100,
// N = 250k: 0.030 ms at 3.35 TB/s), over N m code bytes and m adds per
// cell.  This first version restages each query tile's LUTs for every
// chunk of rows, and each chunk's codes for every query tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CN = 2048;             // rows per chunk
constexpr int TQ = 8;                // at most this many queries per block
constexpr int SMEM = 200 * 1024;     // dynamic shared bytes a block may take

__global__ void __launch_bounds__(THREADS)
pq_scan_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes, int Q, int N,
               int M, int K, int tq, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lut_len = M * K;
  float* lut = smem;                                                  // [tq][M][K]
  uint8_t* cs = reinterpret_cast<uint8_t*>(lut + (size_t)tq * lut_len);  // [CN][M]
  const int q0 = blockIdx.x * tq;
  const int nq = min(tq, Q - q0);
  const int row0 = blockIdx.y * CN;
  const int rows = min(CN, N - row0);
  const float* src = luts + (size_t)q0 * lut_len;
  for (int e = threadIdx.x; e < nq * lut_len; e += THREADS) lut[e] = src[e];
  const uint8_t* csrc = codes + (size_t)row0 * M;
  for (int e = threadIdx.x; e < rows * M; e += THREADS) cs[e] = csrc[e];
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const uint8_t* code = cs + (size_t)r * M;
    for (int i = 0; i < nq; ++i) {
      const float* l = lut + (size_t)i * lut_len;
      float s = 0.f;
      for (int j = 0; j < M; ++j) s = __fadd_rn(s, l[j * K + code[j]]);
      out[(size_t)(q0 + i) * N + row0 + r] = s;
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// queries per block for (M, K); 0 when one query's LUT does not fit
int pq_scan_tile(int M, int K) {
  const long long per_q = (long long)M * K * 4;
  const long long room = (long long)SMEM - (long long)CN * M;
  if (M <= 0 || K <= 0 || per_q > room) return 0;
  const long long t = room / per_q;
  return (int)(t < TQ ? t : TQ);
}

// scores (Q, N) f32 from luts (Q, M, K) f32 and codes (N, M) uint8.
// Returns a CUDA error code.
int pq_scan(const float* luts, const uint8_t* codes, int Q, int N, int M, int K, float* out,
            cudaStream_t stream) {
  if (Q <= 0 || N <= 0) return 0;
  const int tq = pq_scan_tile(M, K);
  if (tq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (N + CN - 1) / CN;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(pq_scan_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = (size_t)tq * M * K * sizeof(float) + (size_t)CN * M;
  dim3 grid((Q + tq - 1) / tq, chunks);
  pq_scan_kernel<<<grid, THREADS, smem, stream>>>(luts, codes, Q, N, M, K, tq, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
