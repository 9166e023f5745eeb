// Masked top-k kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// One entry point, masked_topk, serves three wrappers (kernels/masked_topk.py):
//
// - masked_exact_topk replaces masked_exact_topk_pallas (f32) and
//   masked_exact_topk_multi_pallas (f32) of src/repro/kernels/masked_topk.py
//   (body _masked_exact_kernel): per query, the k rows of the (N, D) point
//   matrix nearest by |q|^2 - 2 q.x + |x|^2 (metric 0) or -q.x (metric 1)
//   among the rows its mask lets through.
// - masked_pq_topk replaces masked_pq_topk_pallas and
//   masked_pq_topk_multi_pallas (body _masked_pq_kernel): the same top-k over
//   PQ-ADC scores sum_j lut[q, j, codes[n, j]].
// - unified_masked_topk replaces unified_masked_topk_pallas (body
//   _unified_kernel): each query scored by its own flavor, one launch.
// - masked_exact_topk_bf16 / _int8 (and their _multi forms) replace the
//   reduced-precision scans of masked_exact_topk_pallas and
//   masked_exact_topk_multi_pallas: bf16 (_masked_exact_kernel on bf16
//   inputs) loads bf16 and multiplies and adds in f32, the norms from the
//   upcast values; int8 (_masked_exact_q_kernel) sums the int8 x int8
//   cross in int32 (__dp4a on four packed values) and multiplies it by
//   q_scale * x_scale afterwards, and the norms are f32 sums of the squared
//   dequantized values (x * scale), as masked_topk.py:217-231 computes them.
//
// The three share all device code: the masked expanded-form distance tile,
// the ADC row score and the chunked top-k select and merge.  A score depends
// only on (query, row): the cross product and the norms are each one fused
// multiply-add chain in feature order, the ADC score one chain of adds in
// subquantizer order, and the rounding is spelled out with the _rn
// intrinsics so the compiler cannot contract differently in two places.
// The top-k orders by (score, row id), ties to the lowest id as lax.top_k
// does.  So an exact query gets the same bits from masked_exact_topk and
// from unified_masked_topk, and an ADC query the same from masked_pq_topk.
//
// Mask.  Bytes, read where they lie: U unique rows (U, N) and a (Q,) index
// naming each query's row, or one shared row (index null).  A heterogeneous
// batch's (Q, N) plane is never expanded, and the TPU's f32 mask plane (a
// BlockSpec need) has no counterpart.  A zero byte drops the row: its score
// is +inf before the reduction.
//
// Design.  The TPU walks the N tiles in order and carries a running top-k
// in VMEM; blocks here run in parallel, so the work splits in two launches.
// Pass 1: a grid of (query tile, chunk of CN rows).  A block scores its
// chunk for its queries into shared memory, then each warp takes one query
// and writes that chunk's kc = min(k, CN) best (score, id) pairs, ascending,
// to a (Q, chunks, kc) scratch: kc rounds of a warp argmin, stopping at the
// first +inf (the rest are sentinels).  Pass 2: one block per query merges
// the chunks' sorted lists (k rounds of a block argmin over the list heads).
// Splitting N keeps the 132 SMs busy at the small Q of a fallback; one block
// per query over a 250k-row shard would not.  Output slots past the passing
// rows (and past N when k > N) hold (+inf, -1).
//
// Exact tiles: 32 queries x 64 rows per step, 256 threads each holding a
// 2 x 4 register block, D streamed through shared memory in chunks of 16 as
// in rerank.cu, full f32 on the SIMT units (no TF32: the reference's scores
// are f32).  A step whose 64 rows no query of the tile may see is skipped,
// so a selective predicate reads and scores few rows.  ADC tiles: the LUTs of a few queries (m K 4 bytes each, 32 KB
// at m = 32, K = 256) and the chunk's codes (uint8, one contiguous range)
// sit in shared memory, and each thread scores whole rows.  The TPU's
// one-hot LUT matmul exists only because the TPU has no lane gather
// (src/repro/kernels/pq_scan.py); Hopper gathers from shared memory.  In the
// unified launch the first tiles are exact and the rest ADC, over a query
// order the wrapper gives (exact queries first), so a block scores only one
// flavor; the TPU kernel computes both planes and selects.
//
// Bound on this card.  Exact: 2 Q N D operations against 4 N D bytes of
// points, so operations at Q = 100 (0.096 ms at 67 TFLOP/s for N = 250k,
// D = 128, against 0.038 ms for the bytes).  ADC: m adds per (query, row)
// against N m code bytes read; bytes at the main-path shapes.  bf16 and
// int8: the same operations, which the tensor cores would run at 989 and
// 1,979 TOP/s, so their bound is the 2 or 1 bytes a value of the points
// (here they run on the SIMT units, int8 four products a __dp4a).  This first
// version is simple rather than fast: the argmin rounds cost k CN / 32 steps
// per warp and query, and the exact tiles run at SIMT rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CN = 512;  // rows per chunk
constexpr int TQ = 32;   // exact queries per tile
constexpr int BN = 64;   // exact rows per register tile
constexpr int BK = 16;   // feature dims per shared-memory stage
constexpr int TM = 2;    // register block: TM queries x TN rows
constexpr int TN = 4;
constexpr int MERGE_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int ADC_SMEM = 200 * 1024;  // dynamic shared bytes an ADC tile may take
constexpr int EXACT_SMEM = TQ * CN * 4;  // an exact tile's (TQ, CN) scores
constexpr int CHUNK_SMEM = ADC_SMEM > EXACT_SMEM ? ADC_SMEM : EXACT_SMEM;
constexpr int MERGE_SMEM = MAX_SMEM - 1024;  // leaves room for the static arrays
static_assert((TQ / TM) * (BN / TN) == THREADS, "one register block per thread");
static_assert(BK % 4 == 0, "int8 stages pack four features a word");

// element kinds of the exact flavor's queries and points
constexpr int F32 = 0, BF16 = 1, INT8 = 2;

struct Args {
  const void* q;           // (Q, D) queries (exact flavor): f32, bf16 or int8
  const void* x;           // (N, D) points, the same kind
  const float* luts;       // (Q, M, K) (ADC flavor)
  const uint8_t* codes;    // (N, M)
  const uint8_t* mask;     // (U, N) bytes, nonzero = row may win
  const int* mask_row;     // (Q,) query -> mask row, or null (row 0)
  const int* qperm;        // (Q,) exact queries first, then ADC; null = identity
  float* part_d;           // (Q, chunks, kc)
  int* part_i;
  int Q, N, D, M, K, metric;
  int n_exact;             // qperm[0, n_exact) score exact, the rest ADC
  int tiles_exact, tq_adc, chunks, kc;
  float q_scale, x_scale;  // int8: dequantization scales (1 otherwise)
};

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// One element as f32: bf16 upcast (exact), int8 dequantized (x * scale)
template <int KIND>
__device__ __forceinline__ float elem(const void* base, size_t i, float scale) {
  if constexpr (KIND == F32) return static_cast<const float*>(base)[i];
  else if constexpr (KIND == BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  else return __fmul_rn(static_cast<float>(static_cast<const int8_t*>(base)[i]), scale);
}

// |v|^2 of row ``row`` as one fused multiply-add chain in feature order,
// over the f32 values of elem
template <int KIND>
__device__ __forceinline__ float sq_norm(const void* base, size_t row, int D, float scale) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) {
    const float v = elem<KIND>(base, row * D + d, scale);
    s = __fmaf_rn(v, v, s);
  }
  return s;
}

// A stage holds BK features a row: f32 values for f32 and bf16, four
// int8 values packed in a word for int8 (features past D load as zeros).
template <int KIND> struct Stage {
  using T = float;   // staged word
  using Acc = float; // cross-product accumulator
  static constexpr int W = BK;
};
template <> struct Stage<INT8> {
  using T = int;
  using Acc = int;
  static constexpr int W = BK / 4;
};

// the staged word of features [gk, gk + 4) (int8) or gk (else) of one row
template <int KIND>
__device__ __forceinline__ typename Stage<KIND>::T load_word(const void* base, size_t row, int D,
                                                             int gk, bool valid) {
  if constexpr (KIND == INT8) {
    const int8_t* p = static_cast<const int8_t*>(base) + row * D;
    unsigned w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (valid && gk + b < D) w |= (static_cast<unsigned>(static_cast<uint8_t>(p[gk + b])) << (8 * b));
    return static_cast<int>(w);
  } else {
    return valid && gk < D ? elem<KIND>(base, row * D + gk, 1.f) : 0.f;
  }
}

__device__ __forceinline__ float mac(float a, float b, float acc) { return __fmaf_rn(a, b, acc); }
__device__ __forceinline__ int mac(int a, int b, int acc) { return __dp4a(a, b, acc); }

// add the squares of one staged word's f32 values to a norm, feature order
__device__ __forceinline__ float norm_add(float v, float s, float) { return __fmaf_rn(v, v, s); }
__device__ __forceinline__ float norm_add(int w, float s, float scale) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float v = __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> (8 * b))), scale);
    s = __fmaf_rn(v, v, s);
  }
  return s;
}

// the cross product as f32: int8 sums are scaled once, after the sum
__device__ __forceinline__ float cross_f32(float acc, float) { return acc; }
__device__ __forceinline__ float cross_f32(int acc, float qx) {
  return __fmul_rn(static_cast<float>(acc), qx);
}

// the expanded-form score from the chain sums
__device__ __forceinline__ float exact_score(float q2, float cross, float x2, int metric) {
  return metric == 0 ? __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), x2) : -cross;
}

// the ADC score of one row: adds in subquantizer order, from 0
__device__ __forceinline__ float adc_score(const float* lut, const uint8_t* code, int M, int K) {
  float s = 0.f;
  for (int j = 0; j < M; ++j) s = __fadd_rn(s, lut[j * K + code[j]]);
  return s;
}

// One warp: the kc best (score, row) of dist[0, rows), ascending, ties to the
// lowest row; taken entries are overwritten with +inf.  Stops at the first
// +inf and fills the remaining slots with (+inf, -1).
__device__ void warp_select(float* dist, int rows, int kc, int row0, float* out_d, int* out_i) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kc; ++r) {
    float bd = CUDART_INF_F;
    int bj = INT32_MAX;
    for (int j = lane; j < rows; j += 32) {
      const float d = dist[j];
      if (d < bd) { bd = d; bj = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (better(od, oj, bd, bj)) { bd = od; bj = oj; }
    }
    if (!(bd < CUDART_INF_F)) {
      for (int s = r + lane; s < kc; s += 32) { out_d[s] = CUDART_INF_F; out_i[s] = -1; }
      return;
    }
    if (lane == 0) { out_d[r] = bd; out_i[r] = row0 + bj; }
    if (lane == (bj & 31)) dist[bj] = CUDART_INF_F;
    __syncwarp();
  }
}

template <int KIND>
__device__ void exact_tile(const Args& a, float* dist, int tile, int chunk) {
  using T = typename Stage<KIND>::T;
  using Acc = typename Stage<KIND>::Acc;
  constexpr int W = Stage<KIND>::W;
  constexpr int PER = BK / W;  // features per staged word
  __shared__ T As[W][TQ + 1];
  __shared__ T Bs[W][BN + 1];
  __shared__ float q2s[TQ];
  __shared__ float x2s[BN];
  __shared__ int qids[TQ];
  __shared__ int mrow[TQ];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int first = tile * TQ;
  const int nq = min(TQ, a.n_exact - first);
  const int row0 = chunk * CN;
  const int rows = min(CN, a.N - row0);
  // int8: scale the int32 cross once; the product rounds as the reference's
  const float qx = __fmul_rn(a.q_scale, a.x_scale);
  if (tid < TQ) {
    const int qid = tid < nq ? (a.qperm ? a.qperm[first + tid] : first + tid) : -1;
    qids[tid] = qid;
    mrow[tid] = qid >= 0 && a.mask_row ? a.mask_row[qid] : 0;
    q2s[tid] = qid >= 0 ? sq_norm<KIND>(a.q, qid, a.D, a.q_scale) : 0.f;
  }
  __syncthreads();
  for (int sub = 0; sub < rows; sub += BN) {
    // a 64-row step no query of the tile may see is not scored at all
    int live = 0;
    for (int e = tid; e < TQ * BN; e += THREADS) {
      const int i = e / BN, j = e % BN;
      if (i < nq && sub + j < rows && a.mask[(size_t)mrow[i] * a.N + row0 + sub + j]) live = 1;
    }
    if (!__syncthreads_or(live)) {
      for (int e = tid; e < TQ * BN; e += THREADS) {
        const int i = e / BN, j = e % BN;
        if (i < nq && sub + j < rows) dist[i * CN + sub + j] = CUDART_INF_F;
      }
      __syncthreads();
      continue;
    }
    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
    float xn = 0.f;
    for (int k0 = 0; k0 < a.D; k0 += BK) {
      for (int e = tid; e < TQ * W; e += THREADS) {
        const int i = e / W, kk = e % W, qid = qids[i];
        As[kk][i] = load_word<KIND>(a.q, qid < 0 ? 0 : qid, a.D, k0 + kk * PER, qid >= 0);
      }
      for (int e = tid; e < BN * W; e += THREADS) {
        const int j = e / W, kk = e % W;
        Bs[kk][j] = load_word<KIND>(a.x, (size_t)row0 + sub + j, a.D, k0 + kk * PER, sub + j < rows);
      }
      __syncthreads();
      // features past D load as zeros, and a zero product leaves a sum as it is
      if (tid < BN) {
#pragma unroll
        for (int kk = 0; kk < W; ++kk) xn = norm_add(Bs[kk][tid], xn, a.x_scale);
      }
#pragma unroll
      for (int kk = 0; kk < W; ++kk) {
        T av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = mac(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < BN) x2s[tid] = xn;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = ty * TM + i;
      if (qi >= nq) continue;
      const uint8_t* m = a.mask + (size_t)mrow[qi] * a.N;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = sub + tx * TN + j;
        if (r >= rows) continue;
        dist[qi * CN + r] = m[row0 + r]
            ? exact_score(q2s[qi], cross_f32(acc[i][j], qx), x2s[tx * TN + j], a.metric)
            : CUDART_INF_F;
      }
    }
    __syncthreads();
  }
  for (int qi = tid / 32; qi < nq; qi += WARPS) {
    const size_t base = ((size_t)qids[qi] * a.chunks + chunk) * a.kc;
    warp_select(dist + qi * CN, rows, a.kc, row0, a.part_d + base, a.part_i + base);
  }
}

__device__ void adc_tile(const Args& a, float* smem, int tile, int chunk) {
  __shared__ int qids[TQ];
  __shared__ int mrow[TQ];
  const int tid = threadIdx.x;
  const int first = a.n_exact + tile * a.tq_adc;
  const int nq = min(a.tq_adc, a.Q - first);
  const int row0 = chunk * CN;
  const int rows = min(CN, a.N - row0);
  const int lut_len = a.M * a.K;
  float* dist = smem;                                   // [tq_adc][CN]
  float* lut = dist + a.tq_adc * CN;                    // [tq_adc][M][K]
  uint8_t* codes = reinterpret_cast<uint8_t*>(lut + (size_t)a.tq_adc * lut_len);  // [CN][M]
  if (tid < nq) {
    qids[tid] = a.qperm ? a.qperm[first + tid] : first + tid;
    mrow[tid] = a.mask_row ? a.mask_row[qids[tid]] : 0;
  }
  __syncthreads();
  for (int i = 0; i < nq; ++i) {
    const float* src = a.luts + (size_t)qids[i] * lut_len;
    for (int e = tid; e < lut_len; e += THREADS) lut[i * lut_len + e] = src[e];
  }
  const uint8_t* csrc = a.codes + (size_t)row0 * a.M;
  for (int e = tid; e < rows * a.M; e += THREADS) codes[e] = csrc[e];
  __syncthreads();
  for (int r = tid; r < rows; r += THREADS) {
    for (int i = 0; i < nq; ++i) {
      dist[i * CN + r] = a.mask[(size_t)mrow[i] * a.N + row0 + r]
          ? adc_score(lut + i * lut_len, codes + r * a.M, a.M, a.K)
          : CUDART_INF_F;
    }
  }
  __syncthreads();
  for (int qi = tid / 32; qi < nq; qi += WARPS) {
    const size_t base = ((size_t)qids[qi] * a.chunks + chunk) * a.kc;
    warp_select(dist + qi * CN, rows, a.kc, row0, a.part_d + base, a.part_i + base);
  }
}

// KIND is the exact flavor's element kind; only f32 launches carry ADC tiles
template <int KIND>
__global__ void __launch_bounds__(THREADS) chunk_topk_kernel(Args a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  if (tile < a.tiles_exact) exact_tile<KIND>(a, smem, tile, blockIdx.y);
  else if constexpr (KIND == F32) adc_tile(a, smem, tile - a.tiles_exact, blockIdx.y);
}

// Pass 2: one block per query; each chunk's list is sorted, so the heads
// (score, id, list) are all a round needs.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i, int chunks,
             int kc, int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float msm[];
  float* hd = msm;                                        // head score per list
  int* hi = reinterpret_cast<int*>(hd + chunks);          // head id per list
  int* hp = hi + chunks;                                  // head position per list
  __shared__ float rd[MERGE_THREADS / 32];
  __shared__ int ri[MERGE_THREADS / 32];
  __shared__ int rc[MERGE_THREADS / 32];
  __shared__ int done;
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const float* pd = part_d + (size_t)q * chunks * kc;
  const int* pi = part_i + (size_t)q * chunks * kc;
  for (int c = threadIdx.x; c < chunks; c += MERGE_THREADS) {
    hd[c] = pd[(size_t)c * kc];
    hi[c] = pi[(size_t)c * kc];
    hp[c] = 0;
  }
  if (threadIdx.x == 0) done = 0;
  __syncthreads();
  float* od = out_d + (size_t)q * k;
  int* oi = out_i + (size_t)q * k;
  int r = 0;
  for (; r < k; ++r) {
    float bd = CUDART_INF_F;
    int bi = INT32_MAX, bc = -1;
    for (int c = threadIdx.x; c < chunks; c += MERGE_THREADS) {
      const float d = hd[c];
      const int i = d < CUDART_INF_F ? hi[c] : INT32_MAX;
      if (better(d, i, bd, bi)) { bd = d; bi = i; bc = c; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od2 = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi2 = __shfl_xor_sync(0xffffffffu, bi, off);
      const int oc2 = __shfl_xor_sync(0xffffffffu, bc, off);
      if (better(od2, oi2, bd, bi)) { bd = od2; bi = oi2; bc = oc2; }
    }
    if (lane == 0) { rd[warp] = bd; ri[warp] = bi; rc[warp] = bc; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < MERGE_THREADS / 32; ++w)
        if (better(rd[w], ri[w], bd, bi)) { bd = rd[w]; bi = ri[w]; bc = rc[w]; }
      if (bd < CUDART_INF_F) {
        od[r] = bd;
        oi[r] = bi;
        const int p = ++hp[bc];
        hd[bc] = p < kc ? pd[(size_t)bc * kc + p] : CUDART_INF_F;
        hi[bc] = p < kc ? pi[(size_t)bc * kc + p] : -1;
      } else {
        done = 1;
      }
    }
    __syncthreads();
    if (done) break;
  }
  for (int s = r + threadIdx.x; s < k; s += MERGE_THREADS) { od[s] = CUDART_INF_F; oi[s] = -1; }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows per chunk: the wrapper sizes the (Q, chunks, kc) scratch with it
int masked_topk_chunk_rows() { return CN; }

// ADC queries per tile for (M, K); 0 when one query's LUT does not fit
int masked_topk_adc_tile(int M, int K) {
  const long long per_q = (long long)M * K * 4 + (long long)CN * 4;  // LUT + scores
  const long long room = (long long)ADC_SMEM - (long long)CN * M;    // after the codes
  if (M <= 0 || K <= 0 || per_q > room) return 0;
  const long long t = room / per_q;
  return (int)(t < TQ ? t : TQ);
}

// Masked top-k over Q queries.  qperm[0, n_exact) score exact (q, x), the
// rest ADC (luts, codes); for the exact-only and ADC-only wrappers n_exact is
// Q or 0.  kind is the element kind of q and x (0 f32, 1 bf16, 2 int8 with
// its q_scale and x_scale; ADC queries only with f32).  part_d / part_i are
// (Q, chunks, kc) scratch with chunks = ceil(N / CN) and kc = min(k, CN);
// out is (Q, k).  Returns a CUDA error code.
int masked_topk(const void* q, const void* x, const float* luts, const uint8_t* codes,
                const uint8_t* mask, const int* mask_row, const int* qperm, int Q, int N,
                int D, int M, int K, int metric, int n_exact, int k, int kind, float q_scale,
                float x_scale, float* part_d, int* part_i, float* out_d, int* out_i,
                cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || k <= 0) return 0;
  if (kind < F32 || kind > INT8 || (kind != F32 && n_exact != Q))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q_scale = q_scale; a.x_scale = x_scale;
  a.q = q; a.x = x; a.luts = luts; a.codes = codes; a.mask = mask; a.mask_row = mask_row;
  a.qperm = qperm; a.part_d = part_d; a.part_i = part_i;
  a.Q = Q; a.N = N; a.D = D; a.M = M; a.K = K; a.metric = metric; a.n_exact = n_exact;
  a.chunks = (N + CN - 1) / CN;
  a.kc = k < CN ? k : CN;
  a.tiles_exact = (n_exact + TQ - 1) / TQ;
  const int n_adc = Q - n_exact;
  size_t smem = a.tiles_exact > 0 ? (size_t)EXACT_SMEM : 0;
  a.tq_adc = 1;
  int tiles_adc = 0;
  if (n_adc > 0) {
    a.tq_adc = masked_topk_adc_tile(M, K);
    if (a.tq_adc <= 0) return static_cast<int>(cudaErrorInvalidValue);
    tiles_adc = (n_adc + a.tq_adc - 1) / a.tq_adc;
    const size_t adc = (size_t)a.tq_adc * CN * sizeof(float) +
                       (size_t)a.tq_adc * M * K * sizeof(float) + (size_t)CN * M;
    if (adc > smem) smem = adc;
  }
  if (a.chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // The ceiling is one value per process and executors launch from several
  // threads, so every call sets the same fixed ceilings: a launch's own size
  // never lowers another thread's between its set and its launch.
  void (*kern)(Args) = kind == F32 ? chunk_topk_kernel<F32>
                       : kind == BF16 ? chunk_topk_kernel<BF16> : chunk_topk_kernel<INT8>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       CHUNK_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.tiles_exact + tiles_adc, a.chunks);
  kern<<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t msmem = (size_t)a.chunks * (sizeof(float) + 2 * sizeof(int));
  if (msmem > (size_t)MERGE_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MERGE_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<<<Q, MERGE_THREADS, msmem, stream>>>(part_d, part_i, a.chunks, a.kc, k, out_d,
                                                     out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
