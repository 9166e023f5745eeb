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
// and the sums stay off the tensor cores so they stay full f32 (no TF32).
// Every output is the same chain whichever tile computes it: the cross
// term and each row norm are fmaf chains over features 0 .. Dp - 1 from
// +0.0, with Dp = D rounded up to 16 and zeros past D (the first version's
// 16-feature chunks), and the epilogue is (q2 - 2 cross) + x2, or -cross.
// - One kernel, two tiles: 128 x 128 outputs a block, 8 x 16 a thread
//   (the ground truth, any call of four waves or more), and 64 x 64, 4 x 8
//   a thread (Stage B: Q = 100, N = a few thousand), both 128 threads.
//   The launcher picks by the large tile's grid; a call's rows get the same
//   bits from either.
// - D streams through a double-buffered ring of 16-feature chunks filled by
//   16-byte cp.async copies whose source addresses are worked out once a
//   block; the next chunk is in flight while the current one is multiplied.
// - What bounds the loop is shared memory as much as the FMAs: a warp's
//   128-bit shared load moves 512 bytes at 128 bytes a clock, so at 4 x 4
//   outputs a thread (the first version's kernel) the loads cost twice
//   the FMAs.  A row is staged k-contiguous with a stride of 20 floats, a
//   thread owns
//   rows ty + 16 i and columns tx + 8 j, and a quarter-warp reads one q
//   row (a broadcast) and 8 x rows in 8 different bank quads: each
//   LDS.128 feeds 4 TN or 4 TM FMAs.
// - Blocks are numbered with the query tile fastest, so the blocks that
//   share a point tile run together and the points leave device memory
//   once.  Row norms are summed from the same staged chunks.
// - Rows that are not 16-byte aligned (D % 4 != 0, or an offset base) take
//   4-byte copies; ragged Q, N and D are zero-filled by the copies
//   themselves (cp.async with a short source size), so the caller pads
//   nothing and the bits do not change.
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

// cp.async copies of cp bytes, of which the first src are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Rows [row0, row0 + ROWS) x features [k0, k0 + K) of the (R, D)
// row-major src into dst (row stride STRIDE floats) by 4-byte copies, for
// rows that are not 16-byte aligned; rows >= R and features >= D become 0.
template <int ROWS, int K, int STRIDE, int THREADS>
__device__ __forceinline__ void copy_chunk4(float* dst, const float* __restrict__ src, int R,
                                            int D, int row0, int k0, int tid) {
#pragma unroll 4
  for (int e = tid; e < ROWS * K; e += THREADS) {
    const int r = e / K, c = e % K;
    const bool ok = row0 + r < R && k0 + c < D;
    cp_async4(dst + r * STRIDE + c, ok ? src + (size_t)(row0 + r) * D + k0 + c : src, ok ? 4 : 0);
  }
}

// One thread's 16-byte copies into a ring stage (D % 4 == 0, aligned rows,
// so a 4-feature group is all in or all out): rows tid / 4 + 32 i of a
// tile of ROWS rows, features 4 (tid % 4) .. + 3 of each 16-feature chunk;
// the source rows' addresses are worked out once, not per chunk.
template <int ROWS, int STRIDE>
struct ChunkCopies {
  static constexpr int N = ROWS / 32;
  const float* src[N];  // nullptr: the row is past R
  int c;
  __device__ __forceinline__ ChunkCopies(const float* base, int R, int D, int row0, int tid)
      : c((tid & 3) * 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int row = row0 + (tid >> 2) + 32 * i;
      src[i] = row < R ? base + (size_t)row * D + c : nullptr;
    }
  }
  __device__ __forceinline__ void start(float* dst, int k0, int D, const float* any, int tid) const {
    float* d = dst + (tid >> 2) * STRIDE + c;
    const bool in_d = k0 + c < D;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool ok = in_d && src[i] != nullptr;
      cp_async16(d + 32 * i * STRIDE, ok ? src[i] + k0 : any, ok ? 16 : 0);
    }
  }
};

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float rd_out(float q2, float cross, float x2, int metric) {
  return metric == 0 ? (q2 - 2.0f * cross) + x2 : -cross;
}

// A tile of 16 TM query rows x 8 TN point rows, 128 threads of TM x TN
// outputs each: lane l of warp w owns rows ty + 16 i and columns tx + 8 j,
// tx = l % 8, ty = l / 8 + 4 w.  A quarter-warp reads one q row (a
// broadcast) and 8 consecutive x rows; with a row stride of 4 mod 8 floats
// those 8 fall in 8 different bank quads.  Each float4 read from shared
// memory feeds 4 TN (or 4 TM) FMAs: a warp's 128-bit load moves 512 bytes
// at 128 bytes a clock, so at 4 x 4 a thread the loads, not the FMAs,
// would set the pace.
template <int TM, int TN>
struct Tile {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 8 * TN;
  static constexpr int THREADS = 128;
  static constexpr int NORMS = (BM + BN) / THREADS;  // rows whose norm a thread sums
  static_assert((BM + BN) % THREADS == 0, "norm rows split evenly");
};
constexpr int LT_TM = 8, LT_TN = 16;    // the large tile: 128 x 128
constexpr int ST_TM = 4, ST_TN = 8;     // the small tile: 64 x 64
constexpr int CHUNK = 16;               // features a chunk of the ring
constexpr int ROW_STRIDE = CHUNK + 4;   // floats a staged row: 8 rows, 8 bank quads
constexpr int LARGE_MIN = 4 * 132;      // the large tile from four waves of 132 SMs

// acc += the products of the CHUNK features of one staged chunk (A rows,
// then B rows, ROW_STRIDE floats apart), nrm += the squares of the rows this
// thread sums (row t + 128 r of [A rows; B rows])
template <int TM, int TN>
__device__ __forceinline__ void multiply(const float* A, int tx, int ty, int tid,
                                         float (&acc)[TM][TN], float (&nrm)[Tile<TM, TN>::NORMS]) {
  using T = Tile<TM, TN>;
  const float* B = A + T::BM * ROW_STRIDE;
#pragma unroll
  for (int c = 0; c < CHUNK; c += 4) {
#pragma unroll
    for (int r = 0; r < T::NORMS; ++r) {  // [A rows; B rows] are contiguous
      const float4 v = *reinterpret_cast<const float4*>(A + (tid + T::THREADS * r) * ROW_STRIDE + c);
      fma4(nrm[r], v, v);
    }
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ROW_STRIDE + c);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * ROW_STRIDE + c);
#pragma unroll
      for (int i = 0; i < TM; ++i) fma4(acc[i][j], a[i], b);
    }
  }
}

// norms to shared memory, then the (Q, N) outputs of the tile
template <int TM, int TN>
__device__ __forceinline__ void write_tile(float* q2s, float* x2s, const float (&acc)[TM][TN],
                                           const float (&nrm)[Tile<TM, TN>::NORMS], float* out,
                                           int Q, int N, int row0, int col0, int tx, int ty,
                                           int tid, int metric) {
  using T = Tile<TM, TN>;
#pragma unroll
  for (int r = 0; r < T::NORMS; ++r) {
    const int row = tid + T::THREADS * r;
    if (row < T::BM) q2s[row] = nrm[r];
    else x2s[row - T::BM] = nrm[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= Q) continue;
    const float q2 = q2s[ty + 16 * i];
    float* orow = out + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 8 * j;
      if (c < N) orow[c] = rd_out(q2, acc[i][j], x2s[tx + 8 * j], metric);
    }
  }
}

// D streams through a double-buffered ring of CHUNK-feature chunks in
// dynamic shared memory, the next chunk's cp.async copies in flight while
// the current chunk is multiplied.  Blocks are numbered with the query tile
// fastest.  MINB: blocks an SM, for the register budget.
template <int TM, int TN, int MINB, bool VEC>
__global__ void __launch_bounds__(128, MINB)
rerank_kernel(const float* __restrict__ q, const float* __restrict__ x, float* __restrict__ out,
              int Q, int N, int D, int metric, int q_tiles) {
  using T = Tile<TM, TN>;
  constexpr int STAGE = (T::BM + T::BN) * ROW_STRIDE;  // [A rows; B rows] a stage
  extern __shared__ __align__(16) float sm[];
  float* q2s = sm + 2 * STAGE;
  float* x2s = q2s + T::BM;
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = (tid >> 3 & 3) + 4 * (tid >> 5);
  const int row0 = (blockIdx.x % q_tiles) * T::BM;
  const int col0 = (blockIdx.x / q_tiles) * T::BN;
  const int chunks = (D + CHUNK - 1) / CHUNK;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float nrm[T::NORMS];
#pragma unroll
  for (int r = 0; r < T::NORMS; ++r) nrm[r] = 0.f;
  static_assert(CHUNK == 16 && T::THREADS == 128, "ChunkCopies: 4 threads a row, 32 rows a pass");
  const ChunkCopies<T::BM, ROW_STRIDE> qc(q, Q, D, row0, tid);
  const ChunkCopies<T::BN, ROW_STRIDE> xc(x, N, D, col0, tid);
  auto stage = [&](int buf, int k0) {
    float* A = sm + buf * STAGE;
    if (VEC) {
      qc.start(A, k0, D, q, tid);
      xc.start(A + T::BM * ROW_STRIDE, k0, D, x, tid);
    } else {
      copy_chunk4<T::BM, CHUNK, ROW_STRIDE, T::THREADS>(A, q, Q, D, row0, k0, tid);
      copy_chunk4<T::BN, CHUNK, ROW_STRIDE, T::THREADS>(A + T::BM * ROW_STRIDE, x, N, D, col0, k0, tid);
    }
    cp_async_commit();
  };
  stage(0, 0);
  for (int kc = 0; kc < chunks; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < chunks) {
      stage(buf ^ 1, (kc + 1) * CHUNK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    multiply<TM, TN>(sm + buf * STAGE, tx, ty, tid, acc, nrm);
    __syncthreads();
  }
  write_tile<TM, TN>(q2s, x2s, acc, nrm, out, Q, N, row0, col0, tx, ty, tid, metric);
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

template <int TM, int TN, int MINB>
int launch_tile(bool vec, const float* q, const float* x, float* out, int Q, int N, int D,
                int metric, cudaStream_t stream) {
  using T = Tile<TM, TN>;
  const int q_tiles = (Q + T::BM - 1) / T::BM;
  const long long blocks = (long long)q_tiles * ((N + T::BN - 1) / T::BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * (T::BM + T::BN) * ROW_STRIDE + T::BM + T::BN) * sizeof(float);
  auto kernel = vec ? rerank_kernel<TM, TN, MINB, true> : rerank_kernel<TM, TN, MINB, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), T::THREADS, smem, stream>>>(q, x, out, Q, N, D, metric,
                                                                      q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 0: the small tile, 1: the large tile, for a (Q, N, D) call
int rerank_tile(int Q, int N, int D) {
  using L = Tile<LT_TM, LT_TN>;
  const long long large = (long long)((Q + L::BM - 1) / L::BM) * ((N + L::BN - 1) / L::BN);
  return large < LARGE_MIN ? 0 : 1;
}

int rerank_distances(const float* q, const float* x, float* out, int Q, int N,
                     int D, int metric, cudaStream_t stream) {
  if (Q <= 0 || N <= 0) return 0;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (rerank_tile(Q, N, D) == 1)
    return launch_tile<LT_TM, LT_TN, 2>(vec, q, x, out, Q, N, D, metric, stream);
  return launch_tile<ST_TM, ST_TN, 4>(vec, q, x, out, Q, N, D, metric, stream);
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
