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
//   inputs) multiplies bf16 values on the tensor cores and sums in f32, the
//   norms f32 sums of the upcast values; int8 (_masked_exact_q_kernel) sums
//   the int8 x int8 cross in int32 on the tensor cores and multiplies it by
//   q_scale * x_scale afterwards, and the norms are f32 sums of the squared
//   dequantized values (x * scale), as masked_topk.py:217-231 computes
//   them.
//
// The three share all device code: the masked expanded-form distance
// tiles, the ADC row score and the chunked top-k select and merge.  An f32
// or int8 score depends only on (query, row): the cross product and the
// norms are each one fused multiply-add chain in feature order from +0.0,
// the ADC score one chain of adds in subquantizer order, and the rounding
// is spelled out with the _rn intrinsics so the compiler cannot contract
// differently in two places.  The top-k orders by (score, row id), ties to
// the lowest id as lax.top_k does.  So an exact query gets the same bits
// from masked_exact_topk and from unified_masked_topk, and an ADC query
// the same from masked_pq_topk.
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
// Mask pass (every tile).  A block reads its chunk's mask bytes
// once for each distinct mask row of its tile (8-byte loads where the
// rows allow), packs them into bits in shared memory, and works out from
// the bits which 64-row units of the chunk any query of the tile may see.
// The skip, the staging and the score write read those bits: a unit no
// query may see is neither copied nor scored, so a selective predicate
// (price < 4 passes 0.04 % of the rows) reads and scores few rows.
//
// f32 tile (rows 5, 7 and the exact half of 9): 32 queries x the whole
// 512-row chunk, 256 threads each holding an 8 x 8 register block (8
// queries x 8 rows); warp w covers all 32 queries x the chunk's rows
// [64 w, 64 w + 64) and skips its multiply-adds when no query of the tile
// may see them.  D streams through a double-buffered ring of 16-feature
// stages (64 bytes of a row a copy round) filled by 16-byte cp.async copies
// (4-byte ones where rows are not 16-byte aligned), zero-filled past D, N
// and the dead units; once it is spent the chunk's scores overlay it, so a
// block takes 74 KB of shared memory and two fit an SM with the 128
// registers the 64 sums need.  Each multiply-add step reads a pair of
// features of 8 query rows and 8 point rows with 64-bit shared loads and
// does 128 multiply-adds; the 16-byte quads of a staged row are swizzled
// (point rows by (row >> 1) & 3, query rows by (row >> 1) & 1) so a warp's
// 8 point rows and 4 query rows fall in distinct banks.  |x|^2 (two rows a
// thread) and |q|^2 (a thread a query) are summed from the same stages,
// once a row a block.  Full f32 on the SIMT units (no TF32: the
// reference's scores are f32), each cross product one __fmaf_rn chain in
// feature order, so a score's bits do not depend on the tile shape.  A last
// query tile of 16 or fewer queries runs a 4, 2 or 1 x 8 block (Q = 100:
// 100 query slots scored, not 128).  A chunk no query of the tile may see
// writes its sentinels and nothing else.  The launch's tile_q (the
// autotuner's knob, kernels/autotune.py) can ask for a tile of 16 or 8
// queries, the same layout with a 4 x 8 or 2 x 8 block a thread: more
// blocks where the queries are few (phase 6's unified shape: 16 blocks on
// 132 SMs at 32 queries, 56 at 8).
//
// Tensor-core tiles, bf16 (rows 5', 7') and int8 (rows 4, 6; replaces
// _masked_exact_q_kernel, masked_topk.py:289 and :357): one template
// (tc_tile) on mma.sync, m16n8k16 for bf16 (f32 sums) and m16n8k32 for int8
// (int32 sums), points on the M side (16 rows), queries on the N side (8 a
// fragment), both (rows, D) row-major, so neither is transposed; fragments
// come from shared memory by ldmatrix, and the int8 fragments are the bf16
// ones in bytes (a register holds 4 int8 values where it held 2 bf16).  A
// block stages its whole chunk, 32 bytes of each row a stage (16 bf16 or
// 32 int8 features; the two 16-byte halves swizzled by (row >> 2) & 1 so
// each 8 x 8 b16 matrix hits 8 bank quads), through the same cp.async ring
// (16-byte copies where rows are 16-byte aligned, element loads
// otherwise), features past D zero.  Warp w owns the chunk's rows
// [64 w, 64 w + 64) (four 16-row fragments against every 8-query fragment
// of the tile) and skips a unit no query of the tile may see.  Norms stay
// f32 __fmaf_rn chains over the upcast (bf16) or dequantized (int8) values
// in feature order, once a row a block.  The int8 cross is an exact int32
// sum (at D = 128 at most 128 x 127^2), so its bits do not depend on the
// order; the score is exact_score(q2, acc * (q_scale * x_scale), x2), as
// the SIMT tile it replaces computed it, bit for bit.  The tile's query
// count (16, 8 or 4) is the largest that still gives every SM a block: at
// N = 4,096 (8 chunks) and Q = 100, 4 queries a tile and 200 blocks (an
// explicit tile_q of 16, 8 or 4 overrides the rule).  A
// dead chunk writes its sentinels, as in the f32 tile.  Bound: int8 reads
// a quarter of f32's bytes and its operations take microseconds on the
// tensor cores, so what is left is the select (latency-bound: two blocks
// an SM, 16 warps) and the mask pass.
//
// ADC tile (rows 8, 8' and the ADC half of 9; replaces _masked_pq_kernel,
// masked_topk.py:406 and :590, and the ADC planes of _unified_kernel,
// :539).  The TPU's one-hot LUT matmul exists only because the TPU has no
// lane gather (src/repro/kernels/pq_scan.py); Hopper gathers from shared
// memory.  A tile is 8, 4, 2 or 1 queries (the most whose LUTs fit
// ADC_BUDGET: 2 at m = 32, K = 256; one where a single LUT is larger), its
// LUTs interleaved two queries an entry (lut[g][j][c][w]) so one 8-byte
// shared load serves both.  The work is (tile, batch of chunks) items; a
// grid of one block a slot of the card (two an SM) walks them, each block a
// contiguous share, tile-major, so a block stages its tile's LUTs once (by
// 16-byte loads) for every batch of the tile it takes, not once a (tile,
// chunk): at the phase-2 shape about 35 MB from L2 where a (tile, chunk)
// block staged 1.6 GB.  A batch: each chunk's mask bits, the list of rows
// some query of the tile may see (ascending), those rows scored (a thread
// a row, its m codes read as 16-byte vectors where the codes are aligned
// and m is 16 to 64, else bytes; each sum one __fadd_rn chain in
// subquantizer order, so the bits are the plain version's), and one warp
// a (chunk, query) list selecting over the compacted list (the batch holds
// 8 / tq chunks, so every warp selects).  Bound: its lookups are cheap
// beside the select, which at two blocks an SM (the most the footprint
// and the select's 128 registers allow without spilling) is latency-bound
// with little scoring to hide behind.  In the unified launch the first
// grid columns are exact tiles and the rest ADC blocks, over a query
// order the wrapper gives (exact queries first), so a block scores only one
// flavor; the TPU kernel computes both planes and selects.
//
// Bound on this card, as chip_smoke.py's _masked_bound reckons it: each
// row that passes for some query read once (4, 2 or 1 bytes a value), the
// masks and queries read once, the outputs written once; 2 D operations for
// each passing (query, row) cell at 67 TFLOP/s for f32 and at the tensor
// cores' 989 and 1,979 TOP/s for bf16 and int8.  At the phase-2 shape
// (Q = 100, N = 250k, D = 128, half the rows passing) f32 is bound by its
// operations, 0.048 ms against 0.038 ms for the bytes; bf16 and int8 are
// bound by their bytes.  What holds the f32 tile back from its bound is
// the scoring of every cell of a live unit (masked cells too) and the
// select; bf16's scoring is a few microseconds, so its select, mask pass
// and staging are what is left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CN = 512;  // rows per chunk
constexpr int TQ = 32;   // queries a tile at most: the f32 tile takes 32, 16 or 8, the others fewer
constexpr int UNIT = 64;             // rows a skip unit
constexpr int UNITS = CN / UNIT;     // skip units a chunk
constexpr int MASK_BYTES = CN / 8;   // one mask row's bits over a chunk
constexpr int SPT = CN / 32;  // keys a lane holds in a chunk's sort
constexpr int MERGE_WARPS = 16;  // at most: 32 lists a warp, then one warp over the streams
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MERGE_SMEM = MAX_SMEM - 1024;  // leaves room for the static arrays
constexpr int CHUNK_SMEM = MAX_SMEM - 4096;  // every pass-1 kernel's ceiling (static arrays < 4 KB)
static_assert((CN & (CN - 1)) == 0 && SPT * 32 == CN, "the chunk sort holds CN keys, a power of two");
static_assert(MERGE_WARPS <= 32, "the second merge level gives each stream one lane");

// f32 tile of FQ queries (32, 16 or 8): an (FQ / 4) x 8 register block a
// thread (FQ / 4 queries x 8 rows), a warp FQ queries x one 64-row unit,
// the block the whole chunk; KS features of each staged row a ring stage
constexpr int F_TN = 8;
constexpr int KS = 16;
constexpr int RING = 2;  // stages of the f32 and bf16 rings
template <int FQ>
struct F32Tile {
  static constexpr int TM = FQ / 4;               // queries a thread
  static constexpr int STAGE = (FQ + CN) * KS;    // floats of one ring stage: query rows, then point rows
  // the ring, and over it once it is spent the (FQ, CN) scores; then the
  // row norms and the mask bits
  static constexpr int RING_FLOATS = RING * STAGE > FQ * CN ? RING * STAGE : FQ * CN;
  static constexpr int SMEM = (RING_FLOATS + CN) * 4 + FQ * MASK_BYTES;
  static_assert((FQ / TM) * (UNIT / F_TN) == 32, "a warp: FQ queries x one 64-row unit, 32 lanes");
  static_assert(FQ <= TQ, "the tile's queries fit the tile arrays");
};
// tensor-core tiles (bf16, int8): the whole chunk staged, 32 bytes of each
// row a stage (16 bf16 or 32 int8 features), warp w on rows [64 w, 64 w + 64)
constexpr int B_TQ = 16;  // queries a tile at most (the launch takes 16, 8 or 4)
constexpr int ROW_BYTES = 32;                    // bytes of a staged row a stage
constexpr int B_STAGE = (B_TQ + CN) * ROW_BYTES;  // bytes of one ring stage
// the ring, and over it the (tq, CN) scores; the row norms; the mask bits
__host__ __device__ constexpr int tc_smem(int tq) {
  return (RING * B_STAGE > tq * CN * 4 ? RING * B_STAGE : tq * CN * 4) + CN * 4 + tq * MASK_BYTES;
}
static_assert(UNITS == WARPS && 2 * THREADS == CN, "one 64-row unit a warp, two row norms a thread");
// blocks an SM each tile's launch bound asks for: the f32 tile's 64 sums
// need 128 registers; the tensor-core tiles' 32 sums, their fragments and
// the select fit the same (A/B of the int8 tile at three in PERF.md)
constexpr int F32_BLOCKS = 2, TC_BLOCKS = 2;
// ADC tile: at most ADC_TQ queries, their LUTs in shared memory once a
// block; a footprint of at most ADC_BUDGET bytes leaves ADC_BLOCKS blocks
// an SM (228 KB an SM, 1 KB reserved a block, the static arrays)
constexpr int ADC_TQ = 8;
constexpr int ADC_BLOCKS = 2;
constexpr int ADC_BUDGET = 110 * 1024;
// the ADC tile's dynamic shared bytes: tq LUTs (rounded to 16 bytes), and
// for each of nb chunks a batch its (tq, CN) scores, its live-row list and
// its mask bits
__host__ __device__ constexpr size_t adc_smem(int tq, int nb, int M, int K) {
  return ((size_t)tq * M * K + 3) / 4 * 16 + (size_t)nb * (tq * CN * 4 + CN * 2 + tq * MASK_BYTES);
}
static_assert(F32Tile<TQ>::SMEM <= CHUNK_SMEM && tc_smem(B_TQ) <= CHUNK_SMEM && ADC_BUDGET <= CHUNK_SMEM,
              "one fixed ceiling covers every tile");
static_assert(ADC_TQ <= TQ, "an ADC tile's queries fit the tile arrays");

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
  int tiles_exact, tq_exact, chunks, kc;
  // ADC: queries a tile, queries a LUT group (interleaved), chunks a batch;
  // tiles x batches work items shared by blocks_adc blocks, cols_adc
  // columns of the grid past the exact tiles
  int tq_adc, w_adc, b_adc, tiles_adc, batches_adc, blocks_adc, cols_adc;
  int code_vecs;           // 16-byte code vectors a row held in registers (0: byte loads)
  bool lut_vec;            // LUTs staged by 16-byte loads
  bool vec;                // q and x rows 16-byte aligned: 16-byte copies
  bool mask_vec;           // mask rows 8-byte aligned: 8-byte mask loads
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


// the expanded-form score from the chain sums
__device__ __forceinline__ float exact_score(float q2, float cross, float x2, int metric) {
  return metric == 0 ? __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), x2) : -cross;
}

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// the lane index, read afresh each time (volatile: never hoisted)
__device__ __forceinline__ int lane_id() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(l));
  return l;
}

// Sorts the warp's 32 M keys ascending into positions e = lane * M + r with
// a bitonic network: partners closer than M are in the lane's own
// registers, farther ones in lane ^ (distance / M).
template <int M>
__device__ __forceinline__ void warp_sort(uint64_t (&v)[M], int lane) {
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
// keys and positions past 32 M as (+inf, -1); with MAP the key's row is a
// position in ``rowmap``, which names the chunk row
template <int M, bool MAP>
__device__ __forceinline__ void sort_write(uint64_t (&v)[M], int kc, int row0, float* out_d,
                                           int* out_i, const uint16_t* rowmap, int lane) {
  warp_sort<M>(v, lane);
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int e = lane * M + r;
    if (e >= kc) continue;
    out_d[e] = v[r] != DEAD ? key_score(v[r]) : CUDART_INF_F;
    out_i[e] = v[r] != DEAD ? row0 + (MAP ? rowmap[key_row(v[r])] : key_row(v[r])) : -1;
  }
  // the sentinel loops stay rolled: unrolled, their trip counts are worked
  // out at the kernel's start and held (or spilled) across the whole tile
#pragma unroll 1
  for (int e = 32 * M + lane; e < kc; e += 32) { out_d[e] = CUDART_INF_F; out_i[e] = -1; }
}

// the ``live`` keys of buf (live <= 32 M), sorted and written
template <int M, bool MAP>
__device__ void sort_compacted(const uint64_t* buf, int live, int kc, int row0, float* out_d,
                               int* out_i, const uint16_t* rowmap, int lane) {
  uint64_t v[M];
#pragma unroll
  for (int r = 0; r < M; ++r) v[r] = r * 32 + lane < live ? buf[r * 32 + lane] : DEAD;
  sort_write<M, MAP>(v, kc, row0, out_d, out_i, rowmap, lane);
}

// One warp: the kc best (score, row) of dist[0, rows), ascending, ties to the
// lowest row, (+inf, -1) past the live rows.  The chunk's keys are read 16 a
// lane (a key carries its row, so the order is free: rows r * 32 + lane,
// without bank conflicts; rows past ``rows`` are DEAD and never read).  A
// chunk with no live key writes sentinels; one with more than half live
// sorts all CN keys; else the live keys are compacted over the chunk's
// scores (all read by then) and the next power of two >= 32 of them sorted.
// With MAP, dist holds the scores of a compacted list of rows, ascending,
// and rowmap[j] names the chunk row of position j: positions order as their
// rows do, so the select and its ties are the uncompacted chunk's.  That
// form runs inside the ADC tile's loop over batches; it reads its lane with
// volatile asm, so the network's lane-only flags and addresses are worked
// out where they are used, not hoisted out of the loop and held (or
// spilled) across the scoring.
template <bool MAP = false>
__device__ void chunk_select(float* dist, int rows, int kc, int row0, float* out_d, int* out_i,
                             const uint16_t* rowmap = nullptr) {
  const int lane = MAP ? lane_id() : threadIdx.x & 31;
  uint64_t v[SPT];
  int live = 0;
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = r * 32 + lane;
    v[r] = j < rows ? make_key(dist[j], j) : DEAD;
    live += __popc(__ballot_sync(FULL, v[r] != DEAD));
  }
  if (live == 0) {
#pragma unroll 1
    for (int s = lane; s < kc; s += 32) { out_d[s] = CUDART_INF_F; out_i[s] = -1; }
    return;
  }
  if (live > CN / 2) {
    sort_write<SPT, MAP>(v, kc, row0, out_d, out_i, rowmap, lane);
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
  if (live <= 32) sort_compacted<1, MAP>(buf, live, kc, row0, out_d, out_i, rowmap, lane);
  else if (live <= 64) sort_compacted<2, MAP>(buf, live, kc, row0, out_d, out_i, rowmap, lane);
  else if (live <= 128) sort_compacted<4, MAP>(buf, live, kc, row0, out_d, out_i, rowmap, lane);
  else sort_compacted<8, MAP>(buf, live, kc, row0, out_d, out_i, rowmap, lane);
}


// cp.async copies of 16 or 4 bytes, of which the first src_bytes are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Feeds a ring of RING stages: stage(buf, k0) starts the copies of the
// features [k0, k0 + W) into buffer buf and commits them; body(buf) runs
// once a stage has landed, with the next RING - 1 stages' copies in flight.
// When it returns every copy has landed (the buffers may be reused).
template <int W, typename Stage, typename Body>
__device__ __forceinline__ void ring(int D, Stage stage, Body body) {
  const int stages = (D + W - 1) / W;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < stages) stage(s, s * W);
    else cp_async_commit();  // an empty group keeps the count
  }
  for (int s = 0; s < stages; ++s) {
    const int next = s + RING - 1;
    if (next < stages) stage(next % RING, next * W);
    else cp_async_commit();
    cp_async_wait<RING - 1>();  // stage s's group has landed
    __syncthreads();
    body(s % RING);
    __syncthreads();
  }
}

// Query side of a tile, shared by every tile: each query's id, its mask
// row, its slot (the first query of the tile with the same mask row) and
// its |q|^2 (summed from the staged rows), and the bits of every distinct
// mask row over the chunk's rows [row0, row0 + rows): each row's bytes read
// once, 8 at a time where rows are 8-byte aligned; bits past ``rows`` are
// 0.  Then live[u]: some query of the tile may see a row of unit u (warp u
// looks, one 8-byte read of the unit's bits a query).
struct TileQueries {
  int qid[TQ];
  int mrow[TQ];
  int slot[TQ];
  float q2[TQ];
  bool live[UNITS];
};

// the ids, mask rows and slots of the queries at positions [first, first + nq)
__device__ void tile_queries(const Args& a, TileQueries& t, int first, int nq) {
  const int tid = threadIdx.x;
  if (tid < nq) {
    const int qid = a.qperm ? a.qperm[first + tid] : first + tid;
    t.qid[tid] = qid;
    t.mrow[tid] = a.mask_row ? a.mask_row[qid] : 0;
  }
  __syncthreads();
  if (tid < nq) {
    int s = 0;
    while (t.mrow[s] != t.mrow[tid]) ++s;
    t.slot[tid] = s;
  }
  __syncthreads();
}

// bits [8 w, 8 w + 8) of query i's mask row over the chunk's rows
// [row0, row0 + rows): 8 bytes read at once where rows are 8-byte aligned;
// bits past ``rows`` are 0
__device__ __forceinline__ uint8_t mask_byte(const Args& a, const TileQueries& t, int i, int w, int row0,
                                             int rows) {
  const int r = 8 * w;
  const uint8_t* m = a.mask + (size_t)t.mrow[i] * a.N + row0 + r;
  unsigned b = 0;
  if (a.mask_vec && r < rows) {  // rows is a multiple of 8 here
    const uint2 v = *reinterpret_cast<const uint2*>(m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b |= ((v.x >> (8 * j)) & 0xffu ? 1u : 0u) << j;
      b |= ((v.y >> (8 * j)) & 0xffu ? 1u : 0u) << (4 + j);
    }
  } else {
    for (int j = 0; j < 8 && r + j < rows; ++j) b |= (m[j] ? 1u : 0u) << j;
  }
  return static_cast<uint8_t>(b);
}

__device__ void tile_setup(const Args& a, TileQueries& t, uint8_t* bits, int first, int nq,
                           int row0, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  tile_queries(a, t, first, nq);
  // each distinct mask row's bits, into bits[slot][MASK_BYTES]
  for (int e = threadIdx.x; e < nq * MASK_BYTES; e += THREADS) {
    const int i = e / MASK_BYTES, w = e % MASK_BYTES;
    if (t.slot[i] == i) bits[e] = mask_byte(a, t, i, w, row0, rows);
  }
  __syncthreads();
  const int q = lane;
  const bool any = q < nq && *reinterpret_cast<const uint64_t*>(bits + t.slot[q] * MASK_BYTES + 8 * warp);
  const bool l = __any_sync(FULL, any);
  if (lane == 0) t.live[warp] = l;
  __syncthreads();
}

// the 64 bits of query q's mask over unit u (bit 8 j + i: row 64 u + 8 j + i)
__device__ __forceinline__ uint64_t unit_bits(const TileQueries& t, const uint8_t* bits, int q, int u) {
  return *reinterpret_cast<const uint64_t*>(bits + t.slot[q] * MASK_BYTES + 8 * u);
}

// a chunk no query of the tile may see: every query's kc slots are
// sentinels, as chunk_select writes them for a chunk with no live key
__device__ void dead_chunk(const Args& a, const TileQueries& t, int nq, int chunk) {
  const int lane = threadIdx.x & 31;
  for (int qi = threadIdx.x >> 5; qi < nq; qi += WARPS) {
    const size_t base = ((size_t)t.qid[qi] * a.chunks + chunk) * a.kc;
#pragma unroll 1
    for (int s = lane; s < a.kc; s += 32) {
      a.part_d[base + s] = CUDART_INF_F;
      a.part_i[base + s] = -1;
    }
  }
}

// f32 staged point row r, quad c (features 4 c .. 4 c + 3 of the stage):
// the four quads of a row swizzled by (r >> 1) & 3, so 8 consecutive rows'
// pair of features lie in 8 different bank pairs; a query row's by
// (r >> 1) & 1, enough for the 4 consecutive ones a warp reads.
__device__ __forceinline__ int f_swz(int r, int c) { return r * KS + ((c ^ ((r >> 1) & 3)) << 2); }
__device__ __forceinline__ int q_swz(int r, int c) { return r * KS + ((c ^ ((r >> 1) & 1)) << 2); }

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  acc = __fmaf_rn(a.w, b.w, acc);
}

// The f32 tile's multiply-adds over one staged stage: lane (tx, ty) =
// (lane & 7, lane >> 3) of warp w holds queries ty + 4 i (i < TMA) x rows
// 64 w + tx + 8 j (j < 8), feature pairs read by 64-bit shared loads in
// order.  TMA < TM when the tile's queries end early (the last tile).  A
// query's sums are the same chains whatever TMA and TM are.
template <int TMA, int TM>
__device__ __forceinline__ void f32_multiply(const float* Qs, const float* Xs, int tx, int ty, int w,
                                             float (&acc)[TM][F_TN]) {
  const float* qr = Qs + ty * KS;
  const float* xr = Xs + (UNIT * w + tx) * KS;
  const int sx = (tx >> 1) & 3, sq = (ty >> 1) & 1;  // the swizzles of the rows this lane reads
  // one feature pair an iteration, not unrolled: the 64 sums and one
  // pair's 16 loads fit the 128 registers two blocks an SM leave a thread
#pragma unroll 1
  for (int p = 0; p < KS / 2; ++p) {
    const int qc = 4 * ((p >> 1) ^ sq) + 2 * (p & 1);
    const int xc = 4 * ((p >> 1) ^ sx) + 2 * (p & 1);
    float2 av[TMA];
#pragma unroll
    for (int i = 0; i < TMA; ++i) av[i] = *reinterpret_cast<const float2*>(qr + 4 * i * KS + qc);
#pragma unroll
    for (int j = 0; j < F_TN; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(xr + 8 * j * KS + xc);
#pragma unroll
      for (int i = 0; i < TMA; ++i) {
        acc[i][j] = __fmaf_rn(av[i].x, b.x, acc[i][j]);
        acc[i][j] = __fmaf_rn(av[i].y, b.y, acc[i][j]);
      }
    }
  }
}

// f32 tile of FQ queries (see the header).  Dynamic shared memory: the ring
// (the (FQ, CN) scores over it once it is spent), the chunk's row norms,
// the mask bits.
template <int FQ>
__device__ void f32_tile(const Args& a, float* smem, int tile, int chunk) {
  using F = F32Tile<FQ>;
  constexpr int TM = F::TM;
  float* ringb = smem;                          // [RING][FQ + CN][KS]
  float* dist = smem;                           // [FQ][CN], once the ring is spent
  float* x2s = smem + F::RING_FLOATS;           // [CN]
  uint8_t* bits = reinterpret_cast<uint8_t*>(x2s + CN);  // [FQ][MASK_BYTES]
  __shared__ TileQueries tq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = tile * FQ;
  const int nq = min(FQ, a.n_exact - first);
  const int row0 = chunk * CN;
  const int rows = min(CN, a.N - row0);
  tile_setup(a, tq, bits, first, nq, row0, rows);
  bool any = false;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) any = any || tq.live[u];
  if (!any) {
    dead_chunk(a, tq, nq, chunk);
    return;
  }
  const float* qb = static_cast<const float*>(a.q);
  const float* xb = static_cast<const float*>(a.x);
  const int D = a.D;
  const int tx = lane & 7, ty = lane >> 3;
  // copies (16-byte path): quad h = tid & 1 of query row tid >> 1 and of
  // point rows (tid >> 1) + 128 i; rows past N or in a unit no query may
  // see are zero-filled (row index -1)
  const int h = tid & 3;
  const int qrow = tid < 4 * FQ && (tid >> 2) < nq ? tq.qid[tid >> 2] : -1;
  const bool wlive = tq.live[warp];
  const bool nlive[2] = {tq.live[tid / UNIT], tq.live[(tid + THREADS) / UNIT]};
  float xn[2] = {0.f, 0.f};  // |x|^2 of rows tid and tid + 256
  float qn = 0.f;            // |q|^2 of query tid (tid < nq)
  const int tma = nq > 16 ? 8 : nq > 8 ? 4 : nq > 4 ? 2 : 1;
  float acc[TM][F_TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;
  auto stage = [&](int buf, int k0) {
    float* Qs = ringb + buf * F::STAGE;
    float* Xs = Qs + FQ * KS;
    if (a.vec) {
      const bool in_d = k0 + 4 * h < D;
      if (tid < 4 * FQ) {
        const bool ok = qrow >= 0 && in_d;
        cp_async16(Qs + q_swz(tid >> 2, h), ok ? qb + (size_t)qrow * D + k0 + 4 * h : qb, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < UNITS; ++i) {
        const int r = row0 + (tid >> 2) + UNIT * i;
        const bool ok = tq.live[i] && r < a.N && in_d;
        cp_async16(Xs + f_swz((tid >> 2) + UNIT * i, h), ok ? xb + (size_t)r * D + k0 + 4 * h : xb, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < (FQ + CN) * KS; e += THREADS) {
        const int r = e / KS, f = e % KS, k = k0 + f;
        const float* src = nullptr;
        float* dst;
        if (r < FQ) {
          dst = Qs + q_swz(r, f >> 2) + (f & 3);
          if (r < nq && k < D) src = qb + (size_t)tq.qid[r] * D + k;
        } else {
          const int rr = r - FQ, g = row0 + rr;
          dst = Xs + f_swz(rr, f >> 2) + (f & 3);
          if (tq.live[rr / UNIT] && g < a.N && k < D) src = xb + (size_t)g * D + k;
        }
        cp_async4(dst, src ? src : qb, src ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  ring<KS>(D, stage, [&](int buf) {
    const float* Qs = ringb + buf * F::STAGE;
    const float* Xs = Qs + FQ * KS;
    // norms: one fused chain a row in feature order (zeros past D leave it)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!nlive[i]) continue;
      const int r = tid + THREADS * i;
#pragma unroll
      for (int c = 0; c < KS / 4; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(Xs + f_swz(r, c));
        fma4(xn[i], v, v);
      }
    }
    if (tid < nq) {
#pragma unroll
      for (int c = 0; c < KS / 4; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(Qs + q_swz(tid, c));
        fma4(qn, v, v);
      }
    }
    if (!wlive) return;
    if constexpr (TM >= 8) {
      if (tma == 8) { f32_multiply<8, TM>(Qs, Xs, tx, ty, warp, acc); return; }
    }
    if constexpr (TM >= 4) {
      if (tma == 4) { f32_multiply<4, TM>(Qs, Xs, tx, ty, warp, acc); return; }
    }
    if (tma == 2) f32_multiply<2, TM>(Qs, Xs, tx, ty, warp, acc);
    else f32_multiply<1, TM>(Qs, Xs, tx, ty, warp, acc);
  });
  x2s[tid] = xn[0];
  x2s[tid + THREADS] = xn[1];
  if (tid < nq) tq.q2[tid] = qn;
  __syncthreads();
  // masked cells (every cell of a unit the warp skipped) are +inf
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = ty + 4 * i;
    if (q >= nq) continue;
    const uint64_t mb = unit_bits(tq, bits, q, warp) >> tx;
    const float q2 = tq.q2[q];
#pragma unroll
    for (int j = 0; j < F_TN; ++j) {
      const int row = UNIT * warp + tx + 8 * j;
      if (row >= rows) continue;
      dist[q * CN + row] = (mb >> (8 * j)) & 1 ? exact_score(q2, acc[i][j], x2s[row], a.metric) : CUDART_INF_F;
    }
  }
  __syncthreads();
  for (int qi = warp; qi < nq; qi += WARPS) {
    const size_t base = ((size_t)tq.qid[qi] * a.chunks + chunk) * a.kc;
    chunk_select(dist + qi * CN, rows, a.kc, row0, a.part_d + base, a.part_i + base);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 bf16 fragment (rows = points), b 16 x 8 (columns =
// queries), f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b: a 16 x 32 int8 fragment (rows = points), b 32 x 8 (columns =
// queries), int32 sums.  The fragments are the bf16 ones in bytes: a
// register holds 4 int8 values where it held 2 bf16, so the same ldmatrix
// loads serve (PTX ISA, mma.m16n8k32 fragments for .s8).
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// adds the squares of 8 staged bf16 values (one 16-byte half), upcast, to a
// norm in feature order
__device__ __forceinline__ float norm8_bf16(const __nv_bfloat16* p, float s) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
    s = __fmaf_rn(lo, lo, s);
    s = __fmaf_rn(hi, hi, s);
  }
  return s;
}

// adds the squares of 16 staged int8 values (one 16-byte half),
// dequantized (v * scale), to a norm in feature order
__device__ __forceinline__ float norm16_int8(const int8_t* p, float s, float scale) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float f = __fmul_rn(static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b))), scale);
      s = __fmaf_rn(f, f, s);
    }
  return s;
}

// What the two tensor-core tiles differ in: the element (PER of them a
// 16-byte half), its zero, the norm of a staged half, the MMA and its sum,
// and the cross product from the sum.
template <int KIND>
struct Tc;
template <>
struct Tc<BF16> {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int PER = 8;
  static __device__ __forceinline__ T zero() { return __float2bfloat16_rn(0.f); }
  static __device__ __forceinline__ float norm(const T* p, float s, float) { return norm8_bf16(p, s); }
  static __device__ __forceinline__ void mma(Acc (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    mma_bf16(d, a, b);
  }
  static __device__ __forceinline__ float cross(Acc acc, float) { return acc; }
};
template <>
struct Tc<INT8> {
  using T = int8_t;
  using Acc = int;
  static constexpr int PER = 16;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ float norm(const T* p, float s, float scale) {
    return norm16_int8(p, s, scale);
  }
  static __device__ __forceinline__ void mma(Acc (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    mma_s8(d, a, b);
  }
  // the exact int32 cross, scaled once by q_scale * x_scale as the reference scales it
  static __device__ __forceinline__ float cross(Acc acc, float qx) {
    return __fmul_rn(static_cast<float>(acc), qx);
  }
};

// staged row r, 16-byte half h, in elements (PER a half, 2 PER a row): the
// halves of a row swizzled by (r >> 2) & 1, so an 8 x 8 b16 matrix's 8 rows
// lie in 8 different bank quads
template <int PER>
__device__ __forceinline__ int tc_swz(int r, int h) { return r * 2 * PER + (h ^ ((r >> 2) & 1)) * PER; }

constexpr int B_MT = UNIT / 16;  // 16-row fragments a warp
constexpr int B_NT = B_TQ / 8;   // 8-query fragments at most

// Tensor-core tile, bf16 or int8 (see the header).  Dynamic shared memory:
// the ring (the (tq, CN) scores over it once it is spent), the chunk's row
// norms, the mask bits.
template <int KIND>
__device__ void tc_tile(const Args& a, float* smem, int tile, int chunk) {
  using C = Tc<KIND>;
  using T = typename C::T;
  constexpr int PER = C::PER, FS = 2 * PER;   // elements a half, a staged row
  constexpr int STAGE = (B_TQ + CN) * FS;     // elements a ring stage
  T* ringb = reinterpret_cast<T*>(smem);      // [RING][B_TQ + CN][FS]
  const int tqn = a.tq_exact;
  float* dist = smem;                           // [tq][CN], once the ring is spent
  float* x2s = smem + (tc_smem(tqn) - CN * 4 - tqn * MASK_BYTES) / 4;  // [CN]
  uint8_t* bits = reinterpret_cast<uint8_t*>(x2s + CN);  // [tq][MASK_BYTES]
  __shared__ TileQueries tq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = tile * tqn;
  const int nq = min(tqn, a.n_exact - first);
  const int row0 = chunk * CN;
  const int rows = min(CN, a.N - row0);
  tile_setup(a, tq, bits, first, nq, row0, rows);
  bool any = false;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) any = any || tq.live[u];
  if (!any) {
    dead_chunk(a, tq, nq, chunk);
    return;
  }
  const int ntiles = (nq + 7) / 8;
  typename C::Acc acc[B_MT][B_NT][4];
#pragma unroll
  for (int m = 0; m < B_MT; ++m)
#pragma unroll
    for (int n = 0; n < B_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
  const T* qb = static_cast<const T*>(a.q);
  const T* xb = static_cast<const T*>(a.x);
  const int D = a.D;
  // copies (16-byte path): half tid & 1 of query row tid >> 1 and of point
  // rows (tid >> 1) + 128 i; rows past N or in a unit no query may see are
  // zero-filled (row index -1)
  const int h = tid & 1;
  const int qrow = tid < 2 * B_TQ && (tid >> 1) < nq ? tq.qid[tid >> 1] : -1;
  int xrow[CN / 128];
#pragma unroll
  for (int i = 0; i < CN / 128; ++i) {
    const int r = (tid >> 1) + 128 * i;
    xrow[i] = tq.live[r / UNIT] && row0 + r < a.N ? row0 + r : -1;
  }
  const bool wlive = tq.live[warp];
  const bool nlive[2] = {tq.live[tid / UNIT], tq.live[(tid + THREADS) / UNIT]};
  float xn[2] = {0.f, 0.f};  // norms of rows tid and tid + 256
  float qn = 0.f;            // norm of query tid (tid < nq)
  auto stage = [&](int buf, int k0) {
    T* Qs = ringb + buf * STAGE;
    T* Xs = Qs + B_TQ * FS;
    if (a.vec) {
      const bool in_d = k0 + PER * h < D;
      if (tid < 2 * B_TQ) {
        const bool ok = qrow >= 0 && in_d;
        cp_async16(Qs + tc_swz<PER>(tid >> 1, h), ok ? qb + (size_t)qrow * D + k0 + PER * h : qb, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < CN / 128; ++i) {
        const bool ok = xrow[i] >= 0 && in_d;
        cp_async16(Xs + tc_swz<PER>((tid >> 1) + 128 * i, h), ok ? xb + (size_t)xrow[i] * D + k0 + PER * h : xb,
                   ok ? 16 : 0);
      }
    } else {
      // rows not 16-byte aligned (D = 33, or an offset view): element
      // loads, stored as they arrive
      for (int e = tid; e < (B_TQ + CN) * FS; e += THREADS) {
        const int r = e / FS, f = e % FS, k = k0 + f;
        T v = C::zero();
        if (r < B_TQ) {
          if (r < nq && k < D) v = qb[(size_t)tq.qid[r] * D + k];
        } else {
          const int rr = r - B_TQ;
          if (tq.live[rr / UNIT] && row0 + rr < a.N && k < D) v = xb[(size_t)(row0 + rr) * D + k];
        }
        Qs[tc_swz<PER>(r, f / PER) + f % PER] = v;
      }
    }
    cp_async_commit();
  };
  ring<FS>(D, stage, [&](int buf) {
    const T* Qs = ringb + buf * STAGE;
    const T* Xs = Qs + B_TQ * FS;
    // norms: one fused chain a row in feature order (zeros past D leave it)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!nlive[i]) continue;
      const int r = tid + THREADS * i;
      xn[i] = C::norm(Xs + tc_swz<PER>(r, 0), xn[i], a.x_scale);
      xn[i] = C::norm(Xs + tc_swz<PER>(r, 1), xn[i], a.x_scale);
    }
    if (tid < nq) {
      qn = C::norm(Qs + tc_swz<PER>(tid, 0), qn, a.q_scale);
      qn = C::norm(Qs + tc_swz<PER>(tid, 1), qn, a.q_scale);
    }
    if (!wlive) return;
    unsigned bq[B_NT][2];
#pragma unroll
    for (int n = 0; n < B_NT; ++n)
      if (n < ntiles) ldmatrix_x2(bq[n], Qs + tc_swz<PER>(8 * n + (lane & 7), (lane >> 3) & 1));
#pragma unroll
    for (int m = 0; m < B_MT; ++m) {
      unsigned ax[4];
      ldmatrix_x4(ax, Xs + tc_swz<PER>(UNIT * warp + 16 * m + (lane & 15), lane >> 4));
#pragma unroll
      for (int n = 0; n < B_NT; ++n)
        if (n < ntiles) C::mma(acc[m][n], ax, bq[n]);
    }
  });
  x2s[tid] = xn[0];
  x2s[tid + THREADS] = xn[1];
  if (tid < nq) tq.q2[tid] = qn;
  __syncthreads();
  // lane (g, t) = (lane >> 2, lane & 3) holds rows g, g + 8 of each
  // fragment against queries 2 t, 2 t + 1; masked cells are +inf
  const float qx = __fmul_rn(a.q_scale, a.x_scale);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < B_NT; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int q = 8 * n + 2 * t4 + c;
      if (q >= nq) continue;
      const uint64_t mb = unit_bits(tq, bits, q, warp) >> g;
      const float q2 = tq.q2[q];
#pragma unroll
      for (int m = 0; m < B_MT; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = UNIT * warp + 16 * m + g + 8 * hh;
          if (row >= rows) continue;
          dist[q * CN + row] = (mb >> (8 * (2 * m + hh))) & 1
              ? exact_score(q2, C::cross(acc[m][n][2 * hh + c], qx), x2s[row], a.metric) : CUDART_INF_F;
        }
    }
  __syncthreads();
  for (int qi = warp; qi < nq; qi += WARPS) {
    const size_t base = ((size_t)tq.qid[qi] * a.chunks + chunk) * a.kc;
    chunk_select(dist + qi * CN, rows, a.kc, row0, a.part_d + base, a.part_i + base);
  }
}

// ---- ADC (see the header) -------------------------------------------------

// W queries' LUT entries side by side: one shared load a (j, code) for all W
template <int W>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };

__device__ __forceinline__ void adc_add(float* s, const float& v) { s[0] = __fadd_rn(s[0], v); }
__device__ __forceinline__ void adc_add(float* s, const float2& v) {
  s[0] = __fadd_rn(s[0], v.x);
  s[1] = __fadd_rn(s[1], v.y);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// entry c of each of W loaded quads, side by side
template <int W>
__device__ __forceinline__ typename Vec<W>::T side(const float4 (&v)[W], int c);
template <>
__device__ __forceinline__ float side<1>(const float4 (&v)[1], int c) { return comp(v[0], c); }
template <>
__device__ __forceinline__ float2 side<2>(const float4 (&v)[2], int c) {
  return make_float2(comp(v[0], c), comp(v[1], c));
}

// Stages the tile's LUTs, once: group g of W queries as lut[g][j][c][w];
// queries past nq are zeros.  Each step loads 4 entries of each query of a
// group (16-byte loads) and stores them as 4 side-by-side W-entry vectors;
// element loads where the LUTs are not 16-byte aligned.
template <int W>
__device__ void adc_stage_luts(const Args& a, const TileQueries& t, float* lut, int nq) {
  using V = typename Vec<W>::T;
  const int lut_len = a.M * a.K;
  const int groups = (nq + W - 1) / W;
  if (a.lut_vec) {
    // 4 steps a thread in flight at once
    const int n4 = lut_len / 4, total = groups * n4;
    for (int e0 = threadIdx.x; e0 < total; e0 += 4 * THREADS) {
      float4 v[4][W];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS, g = e / n4, c4 = e - g * n4;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int q = g * W + w;
          v[u][w] = e < total && q < nq
              ? __ldg(reinterpret_cast<const float4*>(a.luts + (size_t)t.qid[q] * lut_len) + c4)
              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS, g = e / n4, c4 = e - g * n4;
        if (e >= total) break;
        V* dst = reinterpret_cast<V*>(lut) + (size_t)g * lut_len + 4 * c4;
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = side<W>(v[u], c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < groups * W * lut_len; e += THREADS) {
      const int w = e % W, jc = (e / W) % lut_len, q = (e / (W * lut_len)) * W + w;
      lut[e] = q < nq ? a.luts[(size_t)t.qid[q] * lut_len + jc] : 0.f;
    }
  }
}

// Scores the batch's listed rows for every query of the tile.  Listed row
// f of the batch (chunk b, position i of its list) is one thread's: for
// each group of W queries its m codes come in 16 at a time (one 16-byte
// load, code_vecs of them; rolled, so 16 lookups' loads are in flight and
// the select's registers are not crowded) or a byte at a time; a group's
// sums are adds in subquantizer order from 0, as the plain version's; a
// query whose mask drops the row gets +inf, and a group with no such query
// is not summed.  Scores land at dist[(b tq + q) CN + i].
template <int W>
__device__ void adc_score(const Args& a, const TileQueries& t, const float* lut, const uint8_t* bits,
                          const uint16_t* rows, const int* start, float* dist, int nq, int c0, int nb) {
  using V = typename Vec<W>::T;
  const int M = a.M, K = a.K, tq = a.tq_adc, lut_len = M * K;
  const int groups = (nq + W - 1) / W;
  const V* lv = reinterpret_cast<const V*>(lut);
#pragma unroll 1
  for (int f = threadIdx.x; f < start[nb]; f += THREADS) {
    int b = 0;
    while (b + 1 < nb && start[b + 1] <= f) ++b;
    const int i = f - start[b], r = rows[b * CN + i];
    const uint8_t* code = a.codes + ((size_t)(c0 + b) * CN + r) * M;
    const uint8_t* rb = bits + b * tq * MASK_BYTES + (r >> 3);
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      bool ok[W];
      bool any = false;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int q = g * W + w;
        ok[w] = q < nq && ((rb[t.slot[q] * MASK_BYTES] >> (r & 7)) & 1);
        any = any || ok[w];
      }
      float s[W];
#pragma unroll
      for (int w = 0; w < W; ++w) s[w] = 0.f;
      if (any) {
        const V* lg = lv + (size_t)g * lut_len;
        if (a.code_vecs > 0) {
#pragma unroll 1
          for (int v = 0; v < a.code_vecs; ++v) {
            const uint4 c4 = __ldg(reinterpret_cast<const uint4*>(code) + v);
            const unsigned word[4] = {c4.x, c4.y, c4.z, c4.w};
            const V* lj = lg + 16 * v * K;
#pragma unroll
            for (int c = 0; c < 16; ++c) adc_add(s, lj[c * K + ((word[c / 4] >> (8 * (c % 4))) & 0xffu)]);
          }
        } else {
          for (int j = 0; j < M; ++j) adc_add(s, lg[j * K + __ldg(code + j)]);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int q = g * W + w;
        if (q < nq) dist[(b * tq + q) * CN + i] = ok[w] ? s[w] : CUDART_INF_F;
      }
    }
  }
}

// One batch of a tile's work, the chunks [c0, c0 + nb): the mask bits of
// each chunk for each distinct mask row of the tile; each chunk's list of
// the rows some query of the tile may see, ascending; those rows scored;
// then one warp a (chunk, query) list selects over the compacted list
// (chunk_select with its row map), every warp busy when nb tq >= WARPS.
// Dynamic shared memory (adc_smem): the LUTs, then for each chunk of a
// batch its scores, its row list and its mask bits.
__device__ void adc_batch(const Args& a, const TileQueries& t, float* smem, int nq, int batch) {
  __shared__ uint64_t ub[WARPS][UNITS];  // the tile's union of bits, by chunk and unit
  __shared__ int ubase[WARPS][UNITS];    // a unit's first position in its chunk's list
  __shared__ int live[WARPS], start[WARPS + 1];
  const int tid = threadIdx.x, tq = a.tq_adc;
  const float* lut = smem;
  float* dist = smem + ((size_t)tq * a.M * a.K + 3) / 4 * 4;
  uint16_t* rows = reinterpret_cast<uint16_t*>(dist + (size_t)a.b_adc * tq * CN);
  uint8_t* bits = reinterpret_cast<uint8_t*>(rows + (size_t)a.b_adc * CN);
  const int c0 = batch * a.b_adc, nb = min(a.b_adc, a.chunks - c0);
  // every chunk's bits at once: bits[b][slot][MASK_BYTES]
#pragma unroll 1
  for (int e = tid; e < nb * nq * MASK_BYTES; e += THREADS) {
    const int b = e / (nq * MASK_BYTES), i = (e / MASK_BYTES) % nq, w = e % MASK_BYTES;
    const int row0 = (c0 + b) * CN;
    if (t.slot[i] == i) bits[(b * tq + i) * MASK_BYTES + w] = mask_byte(a, t, i, w, row0, min(CN, a.N - row0));
  }
  __syncthreads();
  if (tid < nb * UNITS) {
    const int b = tid / UNITS, u = tid % UNITS;
    uint64_t m = 0;
    for (int q = 0; q < nq; ++q) m |= unit_bits(t, bits + b * tq * MASK_BYTES, q, u);
    ub[b][u] = m;
    ubase[b][u] = __popcll(m);
  }
  __syncthreads();
  if (tid < nb) {
    int s = 0;
    for (int u = 0; u < UNITS; ++u) {
      const int c = ubase[tid][u];
      ubase[tid][u] = s;
      s += c;
    }
    live[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int b = 0; b < nb; ++b) {
      start[b] = s;
      s += live[b];
    }
    start[nb] = s;
  }
#pragma unroll 1
  for (int e = tid; e < nb * CN; e += THREADS) {
    const int b = e / CN, r = e % CN, u = r / UNIT, j = r % UNIT;
    const uint64_t m = ub[b][u];
    if ((m >> j) & 1)
      rows[b * CN + ubase[b][u] + __popcll(m & ((1ull << j) - 1))] = static_cast<uint16_t>(r);
  }
  __syncthreads();
  if (a.w_adc == 2) adc_score<2>(a, t, lut, bits, rows, start, dist, nq, c0, nb);
  else adc_score<1>(a, t, lut, bits, rows, start, dist, nq, c0, nb);
  __syncthreads();
#pragma unroll 1
  for (int l = tid >> 5; l < nb * nq; l += WARPS) {
    const int b = l / nq, q = l % nq;
    const size_t base = ((size_t)t.qid[q] * a.chunks + c0 + b) * a.kc;
    chunk_select<true>(dist + (b * tq + q) * CN, live[b], a.kc, (c0 + b) * CN, a.part_d + base,
                       a.part_i + base, rows + b * CN);
  }
  __syncthreads();  // the next batch reuses the bits, lists and scores
}

// ADC block blk of blocks_adc: a contiguous share of the (tile, batch)
// items, tile-major, so it stages a tile's LUTs once for every batch of
// that tile it takes.  The walk's state lives in shared memory and is read
// after each barrier, so no register holds it across the select.
__device__ void adc_block(const Args& a, float* smem, int blk) {
  __shared__ TileQueries t;
  __shared__ long long walk[2];  // the next item, the end of the share
  __shared__ int staged[2];      // the tile whose LUTs are staged, its query count
  if (threadIdx.x == 0) {
    const long long items = (long long)a.tiles_adc * a.batches_adc;
    walk[0] = items * blk / a.blocks_adc;
    walk[1] = items * (blk + 1) / a.blocks_adc;
    staged[0] = -1;
  }
  __syncthreads();
  for (;;) {
    const long long it = walk[0];
    if (it >= walk[1]) return;
    const int tile = static_cast<int>(it / a.batches_adc);
    if (tile != staged[0]) {
      const int first = a.n_exact + tile * a.tq_adc;
      const int nq = min(a.tq_adc, a.Q - first);
      tile_queries(a, t, first, nq);
      if (a.w_adc == 2) adc_stage_luts<2>(a, t, smem, nq);
      else adc_stage_luts<1>(a, t, smem, nq);
      if (threadIdx.x == 0) {
        staged[0] = tile;
        staged[1] = nq;
      }
      __syncthreads();
    }
    adc_batch(a, t, smem, staged[1], static_cast<int>(it - (long long)tile * a.batches_adc));
    if (threadIdx.x == 0) walk[0] = it + 1;
    __syncthreads();
  }
}

// Pass 1.  KIND is the exact flavor's element kind (FQ the f32 tile's
// queries); launches with ADC
// queries (f32 only) take the ADC form: the exact tiles at blockIdx.x <
// tiles_exact (chunk blockIdx.y), then cols_adc columns of ADC blocks that
// walk the (tile, batch) items, so a unified call's two flavors share one
// grid.  Each template is held to two blocks an SM (128 registers): the
// f32 tile's 64 sums need them, the tensor-core tiles' 32 sums and the
// select fit them without spilling (at three, 80 registers, the select
// spills), and the ADC footprint (ADC_BUDGET) leaves the unified launch's
// f32 tiles their two.  ptxas (-Xptxas -v, CUDA 12.8): 128 registers and no
// spill in each template (PERF.md §6).
template <int KIND, bool ADC, int FQ = TQ>
__global__ void __launch_bounds__(THREADS, ADC ? ADC_BLOCKS : KIND == F32 ? F32_BLOCKS : TC_BLOCKS)
chunk_topk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  if (tile < a.tiles_exact) {
    if constexpr (KIND == F32) f32_tile<FQ>(a, smem, tile, blockIdx.y);
    else tc_tile<KIND>(a, smem, tile, blockIdx.y);
  } else if constexpr (ADC) {
    adc_block(a, smem, blockIdx.y * a.cols_adc + tile - a.tiles_exact);
  }
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

// ADC queries a tile for (M, K): the largest of 8, 4, 2 or 1 whose LUTs
// (and one chunk's scores, list and bits) fit ADC_BUDGET; one where a
// single LUT needs more, up to the ceiling; 0 where it does not fit
int masked_topk_adc_tile(int M, int K) {
  if (M <= 0 || K <= 0) return 0;
  for (int tq = ADC_TQ; tq >= 1; tq /= 2)
    if (adc_smem(tq, 1, M, K) <= (size_t)ADC_BUDGET) return tq;
  return adc_smem(1, 1, M, K) <= (size_t)CHUNK_SMEM ? 1 : 0;
}

// Masked top-k over Q queries.  qperm[0, n_exact) score exact (q, x), the
// rest ADC (luts, codes); for the exact-only and ADC-only wrappers n_exact is
// Q or 0.  kind is the element kind of q and x (0 f32, 1 bf16, 2 int8 with
// its q_scale and x_scale; ADC queries only with f32).  tile_q is the query
// tile, 0 for the launch's own rule: the f32 tile takes 32, 16 or 8, the
// bf16 / int8 tile 16, 8 or 4 (skipping the SM-count rule), and the ADC
// tile min(tile_q, masked_topk_adc_tile(M, K)), a power of two.  A tile
// changes the grid, never a score: each query's sums are the same chains
// whichever queries share its tile.  part_d / part_i are (Q, chunks, kc)
// scratch with chunks = ceil(N / CN) and kc = min(k, CN); out is (Q, k).
// Returns a CUDA error code.
int masked_topk(const void* q, const void* x, const float* luts, const uint8_t* codes,
                const uint8_t* mask, const int* mask_row, const int* qperm, int Q, int N,
                int D, int M, int K, int metric, int n_exact, int k, int kind, int tile_q,
                float q_scale, float x_scale, float* part_d, int* part_i, float* out_d,
                int* out_i, cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || k <= 0) return 0;
  if (kind < F32 || kind > INT8 || (kind != F32 && n_exact != Q) || tile_q < 0 ||
      (tile_q & (tile_q - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_exact > 0 && tile_q > 0 &&
      (kind == F32 ? tile_q < 8 || tile_q > TQ : tile_q < 4 || tile_q > B_TQ))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q_scale = q_scale; a.x_scale = x_scale;
  a.q = q; a.x = x; a.luts = luts; a.codes = codes; a.mask = mask; a.mask_row = mask_row;
  a.qperm = qperm; a.part_d = part_d; a.part_i = part_i;
  a.Q = Q; a.N = N; a.D = D; a.M = M; a.K = K; a.metric = metric; a.n_exact = n_exact;
  a.chunks = (N + CN - 1) / CN;
  a.kc = k < CN ? k : CN;
  // 16-byte copies where every row starts 16-byte aligned (4 f32, 8 bf16 or
  // 16 int8 values); 8-byte mask loads where every mask row starts 8-byte
  // aligned
  const int per16 = kind == F32 ? 4 : kind == BF16 ? 8 : 16;
  a.vec = D % per16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.mask_vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // bf16 / int8 queries a tile, without an explicit tile: the largest of
  // 16, 8, 4 that still gives every SM a block (N = 4,096, Q = 100: 4, 200
  // blocks); f32: 32
  a.tq_exact = tile_q > 0 ? tile_q : kind == F32 ? TQ : B_TQ;
  if (kind != F32 && tile_q == 0)
    while (a.tq_exact > 4 && (long long)((n_exact + a.tq_exact - 1) / a.tq_exact) * a.chunks < sms)
      a.tq_exact /= 2;
  a.tiles_exact = (n_exact + a.tq_exact - 1) / a.tq_exact;
  const int n_adc = Q - n_exact;
  // The ceiling is one value per process and executors launch from several
  // threads, so every call sets the same fixed ceilings: a launch's own size
  // never lowers another thread's between its set and its launch.
  const int fq = a.tq_exact;
  void (*kern)(Args) =
      kind == BF16 ? chunk_topk_kernel<BF16, false>
      : kind == INT8 ? chunk_topk_kernel<INT8, false>
      : n_adc > 0 ? (fq == 8 ? chunk_topk_kernel<F32, true, 8> : fq == 16 ? chunk_topk_kernel<F32, true, 16>
                                                               : chunk_topk_kernel<F32, true, 32>)
                  : (fq == 8 ? chunk_topk_kernel<F32, false, 8> : fq == 16 ? chunk_topk_kernel<F32, false, 16>
                                                                : chunk_topk_kernel<F32, false, 32>);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, CHUNK_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = a.tiles_exact == 0 ? 0
                : kind != F32 ? (size_t)tc_smem(a.tq_exact)
                : fq == 8 ? (size_t)F32Tile<8>::SMEM : fq == 16 ? (size_t)F32Tile<16>::SMEM : (size_t)F32Tile<32>::SMEM;
  unsigned gx = a.tiles_exact, gy = a.chunks;
  a.tq_adc = a.w_adc = a.b_adc = 1;
  a.tiles_adc = a.batches_adc = a.blocks_adc = a.cols_adc = a.code_vecs = 0;
  a.lut_vec = false;
  if (n_adc > 0) {
    a.tq_adc = masked_topk_adc_tile(M, K);
    if (a.tq_adc <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (tile_q > 0 && tile_q < a.tq_adc) a.tq_adc = tile_q;
    a.w_adc = a.tq_adc < 2 ? 1 : 2;
    a.lut_vec = (M * K) % 4 == 0 && reinterpret_cast<uintptr_t>(luts) % 16 == 0;
    a.code_vecs = M % 16 == 0 && M <= 64 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 ? M / 16 : 0;
    a.tiles_adc = (n_adc + a.tq_adc - 1) / a.tq_adc;
    // chunks a batch: enough (chunk, query) lists for every warp's select,
    // within the footprint, and few enough that every block slot on the
    // card still gets a batch (N = 4,096, Q = 100: 1; one 250k shard: 4)
    const size_t room = adc_smem(a.tq_adc, 1, M, K) > (size_t)ADC_BUDGET ? adc_smem(a.tq_adc, 1, M, K)
                                                                          : (size_t)ADC_BUDGET;
    int nb = WARPS / a.tq_adc > 1 ? WARPS / a.tq_adc : 1;
    while (nb > 1 && adc_smem(a.tq_adc, nb, M, K) > room) --nb;
    while (nb > 1 && (long long)a.tiles_adc * ((a.chunks + nb - 1) / nb) < (long long)sms * ADC_BLOCKS) --nb;
    a.b_adc = nb;
    a.batches_adc = (a.chunks + nb - 1) / nb;
    const size_t adc_bytes = adc_smem(a.tq_adc, nb, M, K);
    if (adc_bytes > smem) smem = adc_bytes;
    // one block a slot of the card (blocks an SM as the occupancy
    // calculator gives them), each a contiguous share of the items; in a
    // unified launch the ADC blocks take columns past the exact tiles'
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long items = (long long)a.tiles_adc * a.batches_adc;
    long long blocks = (long long)sms * (per_sm > 1 ? per_sm : 1);
    if (blocks > items) blocks = items;
    gy = a.tiles_exact > 0 ? a.chunks : 1;
    a.cols_adc = static_cast<int>((blocks + gy - 1) / gy);
    a.blocks_adc = a.cols_adc * static_cast<int>(gy);
    gx = a.tiles_exact + a.cols_adc;
  }
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
  kern<<<dim3(gx, gy), THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MERGE_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<<<Q, mw * 32, msmem, stream>>>(part_d, part_i, a.chunks, a.kc, k, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
