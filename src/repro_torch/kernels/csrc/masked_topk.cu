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
// to a (Q, chunks, kc) scratch.  Pass 2: one block per query merges the
// chunks' sorted lists.  Splitting N keeps the 132 SMs busy at the small Q
// of a fallback; one block per query over a 250k-row shard would not.
// Output slots past the passing rows (and past N when k > N) hold
// (+inf, -1).
//
// The select.  Every candidate is one 64-bit key: the order-preserving
// uint32 image of its f32 score (-0.0 taken onto +0.0 first, so the two
// tie) above 2 row + (the score is -0.0), so (score, id) order is one
// integer compare, ties go to the lowest id as lax.top_k orders them, and
// the key gives back the score's bits; a score that is not below +inf (a
// masked row, or NaN) is the DEAD key and never wins.  Pass 1 sorts a
// chunk's keys in registers with a bitonic network: all 512, 16 a lane (45
// stages of compare-exchange whatever k is, 30 within a lane and 15 across
// lanes by __shfl_xor_sync) when more than half the rows are live; else the
// live keys, compacted over the chunk's scores, padded to the next power of
// two >= 32; a chunk with no live key writes its sentinels and sorts
// nothing.  Pass 2 merges in warps: a lane holds the head of its list (or
// the best head of its few lists, the rest in shared memory) with that
// list's next entry fetched ahead, two warp min-reductions
// (__reduce_min_sync on the key's halves) pick the winner, and only the
// winning lane advances.  Up to 16 warps merge 32 lists each into sorted
// streams in shared memory, and after one barrier one warp merges the
// streams the same way: a few warp instructions an output slot, no block
// barrier and no dependent global load on the critical path.  So the
// select's cost follows the live rows, not k; only the k slots written and
// merged grow with it.
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
// (here they run on the SIMT units, int8 four products a __dp4a).  With the
// select's cost flat in k, what holds the exact tiles back is the scoring:
// f32 multiply-adds on the SIMT units, bf16 upcast to them, and int8 bytes
// staged one at a time; tensor-core tiles are the next step.

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
constexpr int SPT = CN / 32;  // keys a lane holds in a chunk's sort
constexpr int MERGE_WARPS = 16;  // at most: 32 lists a warp, then one warp over the streams
constexpr int MAX_SMEM = 227 * 1024;
constexpr int ADC_SMEM = 200 * 1024;  // dynamic shared bytes an ADC tile may take
constexpr int EXACT_SMEM = TQ * CN * 4;  // an exact tile's (TQ, CN) scores
constexpr int CHUNK_SMEM = ADC_SMEM > EXACT_SMEM ? ADC_SMEM : EXACT_SMEM;
constexpr int MERGE_SMEM = MAX_SMEM - 1024;  // leaves room for the static arrays
static_assert((TQ / TM) * (BN / TN) == THREADS, "one register block per thread");
static_assert(BK % 4 == 0, "int8 stages pack four features a word");
static_assert((CN & (CN - 1)) == 0 && SPT * 32 == CN, "the chunk sort holds CN keys, a power of two");
static_assert(MERGE_WARPS <= 32, "the second merge level gives each stream one lane");

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

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t DEAD = ~0ull;  // the key of a row that cannot win

// (score, row) as one key: the order-preserving image of the score, -0.0
// taken onto +0.0 so that the two tie, above 2 row + (score is -0.0); a
// lower key is the better candidate, and the key gives back the score's
// bits.  A score that is not below +inf (masked, or NaN) is DEAD.
__device__ __forceinline__ uint64_t make_key(float d, int row) {
  if (!(d < CUDART_INF_F)) return DEAD;
  const uint32_t u = __float_as_uint(__fadd_rn(d, 0.f));
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const uint32_t lo = (static_cast<uint32_t>(row) << 1) | (__float_as_uint(d) == 0x80000000u);
  return (static_cast<uint64_t>(o) << 32) | lo;
}

__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return (key & 1) ? -0.f : __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ int key_row(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key) >> 1);
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int m) {
  const uint32_t lo = __shfl_xor_sync(FULL, static_cast<uint32_t>(v), m);
  const uint32_t hi = __shfl_xor_sync(FULL, static_cast<uint32_t>(v >> 32), m);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// the smallest key over the warp: two reductions, on the high half and then
// on the low halves that share it.  Every lane gets it.
__device__ __forceinline__ uint64_t warp_min(uint64_t key) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t mh = __reduce_min_sync(FULL, hi);
  const uint32_t ml = __reduce_min_sync(FULL, hi == mh ? static_cast<uint32_t>(key) : 0xffffffffu);
  return (static_cast<uint64_t>(mh) << 32) | ml;
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

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// Sorts the warp's 32 M keys ascending into positions e = lane * M + r with
// a bitonic network: partners closer than M are in the lane's own
// registers, farther ones in lane ^ (distance / M).
template <int M>
__device__ __forceinline__ void warp_sort(uint64_t (&v)[M]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s <= 5 + ilog2(M); ++s) {
#pragma unroll
    for (int t = s - 1; t >= 0; --t) {
      // runs of 2^s ascend where bit s of the position is 0, else descend
      if ((1 << t) < M) {
#pragma unroll
        for (int r = 0; r < M; ++r) {
          if (r & (1 << t)) continue;
          const int o = r | (1 << t);
          const bool up = (((lane * M + r) >> s) & 1) == 0;
          const uint64_t a = v[r], b = v[o];
          const bool swap = (a > b) == up;
          v[r] = swap ? b : a;
          v[o] = swap ? a : b;
        }
      } else {
        const int m = (1 << t) / M;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int r = 0; r < M; ++r) {
          const bool up = (((lane * M + r) >> s) & 1) == 0;
          const uint64_t p = shfl_xor64(v[r], m);
          // the lower position of an ascending pair keeps the smaller key
          v[r] = (lower == up ? p < v[r] : p > v[r]) ? p : v[r];
        }
      }
    }
  }
}

// sorts v and writes the first kc positions as (score, row0 + row), DEAD
// keys and positions past 32 M as (+inf, -1)
template <int M>
__device__ __forceinline__ void sort_write(uint64_t (&v)[M], int kc, int row0, float* out_d,
                                           int* out_i) {
  const int lane = threadIdx.x & 31;
  warp_sort<M>(v);
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int e = lane * M + r;
    if (e >= kc) continue;
    out_d[e] = v[r] != DEAD ? key_score(v[r]) : CUDART_INF_F;
    out_i[e] = v[r] != DEAD ? row0 + key_row(v[r]) : -1;
  }
  for (int e = 32 * M + lane; e < kc; e += 32) { out_d[e] = CUDART_INF_F; out_i[e] = -1; }
}

// the ``live`` keys of buf (live <= 32 M), sorted and written
template <int M>
__device__ void sort_compacted(const uint64_t* buf, int live, int kc, int row0, float* out_d,
                               int* out_i) {
  const int lane = threadIdx.x & 31;
  uint64_t v[M];
#pragma unroll
  for (int r = 0; r < M; ++r) v[r] = r * 32 + lane < live ? buf[r * 32 + lane] : DEAD;
  sort_write<M>(v, kc, row0, out_d, out_i);
}

// One warp: the kc best (score, row) of dist[0, rows), ascending, ties to the
// lowest row, (+inf, -1) past the live rows.  The chunk's keys are read 16 a
// lane (a key carries its row, so the order is free: rows r * 32 + lane,
// without bank conflicts; rows past ``rows`` are DEAD and never read).  A
// chunk with no live key writes sentinels; one with more than half live
// sorts all CN keys; else the live keys are compacted over the chunk's
// scores (all read by then) and the next power of two >= 32 of them sorted.
__device__ void chunk_select(float* dist, int rows, int kc, int row0, float* out_d, int* out_i) {
  const int lane = threadIdx.x & 31;
  uint64_t v[SPT];
  int live = 0;
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = r * 32 + lane;
    v[r] = j < rows ? make_key(dist[j], j) : DEAD;
    live += __popc(__ballot_sync(FULL, v[r] != DEAD));
  }
  if (live == 0) {
    for (int s = lane; s < kc; s += 32) { out_d[s] = CUDART_INF_F; out_i[s] = -1; }
    return;
  }
  if (live > CN / 2) {
    sort_write<SPT>(v, kc, row0, out_d, out_i);
    return;
  }
  uint64_t* buf = reinterpret_cast<uint64_t*>(dist);
  __syncwarp();
  int base = 0;
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const unsigned bal = __ballot_sync(FULL, v[r] != DEAD);
    if (v[r] != DEAD) buf[base + __popc(bal & ((1u << lane) - 1))] = v[r];
    base += __popc(bal);
  }
  __syncwarp();
  if (live <= 32) sort_compacted<1>(buf, live, kc, row0, out_d, out_i);
  else if (live <= 64) sort_compacted<2>(buf, live, kc, row0, out_d, out_i);
  else if (live <= 128) sort_compacted<4>(buf, live, kc, row0, out_d, out_i);
  else sort_compacted<8>(buf, live, kc, row0, out_d, out_i);
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
    chunk_select(dist + qi * CN, rows, a.kc, row0, a.part_d + base, a.part_i + base);
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
    chunk_select(dist + qi * CN, rows, a.kc, row0, a.part_d + base, a.part_i + base);
  }
}

// KIND is the exact flavor's element kind; launches with ADC queries (f32
// only) take the ADC form.  An exact-only launch fits three blocks an SM
// (EXACT_SMEM each) and is held to their 80 registers; an ADC tile's shared
// memory leaves room for one block, which may take all the registers it
// wants (A/B on the H100 in PERF.md).
template <int KIND, bool ADC>
__global__ void __launch_bounds__(THREADS, ADC ? 1 : 3) chunk_topk_kernel(Args a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  if (tile < a.tiles_exact) exact_tile<KIND>(a, smem, tile, blockIdx.y);
  else if constexpr (ADC) adc_tile(a, smem, tile - a.tiles_exact, blockIdx.y);
}

// Pass 2: one block of ``warps`` warps per query.  Level 1: lane g of the
// block owns lists g, g + 32 warps, ...; it keeps its best head's key in a
// register with that list's next entry fetched ahead (its other lists' head
// keys and positions in shared memory, only it touches them), and each
// round a warp min picks the winner among the 32 lanes, which writes its
// head and advances.  With one warp the winners are the output; with more,
// each warp writes a sorted stream of keys to shared memory, and after one
// barrier warp 0 merges the streams (one a lane) the same way.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i, int chunks,
             int kc, int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ uint64_t msm[];
  __shared__ int slen[MERGE_WARPS];
  const int warps = blockDim.x / 32;
  const int lanes = blockDim.x, g = threadIdx.x, lane = g & 31, warp = g / 32;
  const bool multi = chunks > lanes;  // some lane owns several lists
  uint64_t* sk = msm;                                         // [warps][k] streams (warps > 1)
  uint64_t* hk = sk + (warps > 1 ? (size_t)warps * k : 0);    // [chunks] head keys (multi)
  int* hp = reinterpret_cast<int*>(hk + (multi ? chunks : 0));  // [chunks] head positions
  const int q = blockIdx.x;
  const float* pd = part_d + (size_t)q * chunks * kc;
  const int* pi = part_i + (size_t)q * chunks * kc;
  float* od = out_d + (size_t)q * k;
  int* oi = out_i + (size_t)q * k;

  int b = -1, bp = 0, ni = -1;
  float nd = CUDART_INF_F;
  uint64_t key = DEAD;
  for (int c = g; c < chunks; c += lanes) {
    const uint64_t kk = make_key(pd[(size_t)c * kc], pi[(size_t)c * kc]);
    if (multi) { hk[c] = kk; hp[c] = 0; }
    if (b < 0 || kk < key) { key = kk; b = c; }
  }
  if (key != DEAD && kc > 1) { nd = pd[(size_t)b * kc + 1]; ni = pi[(size_t)b * kc + 1]; }
  int r = 0;
  for (; r < k; ++r) {
    const uint64_t best = warp_min(key);
    if (best == DEAD) break;
    if (key != best) continue;
    if (warps == 1) {
      od[r] = key_score(key);
      oi[r] = key_row(key);
    } else {
      sk[(size_t)warp * k + r] = key;
    }
    ++bp;
    key = make_key(nd, ni);  // the entry fetched ahead, (+inf, -1) past kc
    if (multi) {
      hk[b] = key;
      hp[b] = bp;
      for (int c = g; c < chunks; c += lanes)
        if (hk[c] < key) { key = hk[c]; b = c; }
      bp = hp[b];
    }
    nd = CUDART_INF_F;
    ni = -1;
    if (key != DEAD && bp + 1 < kc) {
      nd = pd[(size_t)b * kc + bp + 1];
      ni = pi[(size_t)b * kc + bp + 1];
    }
  }
  if (warps > 1) {
    if (lane == 0) slen[warp] = r;
    __syncthreads();
    if (warp != 0) return;
    // level 2: lane w < warps walks stream w (shared memory, so no fetch ahead)
    const uint64_t* ws = sk + (size_t)lane * k;
    const int len = lane < warps ? slen[lane] : 0;
    int p = 0;
    key = len > 0 ? ws[0] : DEAD;
    for (r = 0; r < k; ++r) {
      const uint64_t best = warp_min(key);
      if (best == DEAD) break;
      if (key != best) continue;
      od[r] = key_score(key);
      oi[r] = key_row(key);
      key = ++p < len ? ws[p] : DEAD;
    }
  }
  for (int s = r + lane; s < k; s += 32) { od[s] = CUDART_INF_F; oi[s] = -1; }
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
  // Pass 2's warps: one list a lane where 16 warps reach (489 chunks of a
  // 250k-row shard: 16 warps), fewer where the streams (warps k 8 bytes)
  // would not fit; one warp needs no streams, only the heads of its lists
  // (12 bytes a list once a lane owns several): the old merge's bound.
  int mw = (a.chunks + 31) / 32 < MERGE_WARPS ? (a.chunks + 31) / 32 : MERGE_WARPS;
  auto merge_bytes = [&](int w) {
    const size_t heads = a.chunks > 32 * w ? (size_t)a.chunks * (sizeof(uint64_t) + sizeof(int)) : 0;
    return heads + (w > 1 ? (size_t)w * k * sizeof(uint64_t) : 0);
  };
  while (mw > 1 && merge_bytes(mw) > (size_t)MERGE_SMEM) --mw;
  const size_t msmem = merge_bytes(mw);
  if (msmem > (size_t)MERGE_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // The ceiling is one value per process and executors launch from several
  // threads, so every call sets the same fixed ceilings: a launch's own size
  // never lowers another thread's between its set and its launch.
  void (*kern)(Args) = n_adc > 0 ? chunk_topk_kernel<F32, true>
                       : kind == F32 ? chunk_topk_kernel<F32, false>
                       : kind == BF16 ? chunk_topk_kernel<BF16, false> : chunk_topk_kernel<INT8, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       CHUNK_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.tiles_exact + tiles_adc, a.chunks);
  kern<<<grid, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MERGE_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<<<Q, mw * 32, msmem, stream>>>(part_d, part_i, a.chunks, a.kc, k, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
