// Key, sort and butterfly helpers shared by rerank.cu (gather_rerank) and
// kmeans_assign.cu.  _build._lib_path hashes every header a source
// includes with quotes, so an edit here rebuilds both libraries.
// csrc/masked_topk.cu keeps its own copy of the key and sort helpers.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t DEAD = ~0ull;  // the key of a candidate that cannot win

// (score, slot) as one key: the order-preserving image of the score, -0.0
// taken onto +0.0 so that the two tie, above 2 slot + (score is -0.0); a
// lower key is the better candidate, and the key gives back the score's
// bits.  A score that is not below +inf (NaN too) is DEAD.
__device__ __forceinline__ uint64_t make_key(float d, int slot) {
  if (!(d < CUDART_INF_F)) return DEAD;
  const uint32_t u = __float_as_uint(__fadd_rn(d, 0.f));
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const uint32_t lo = (static_cast<uint32_t>(slot) << 1) | (__float_as_uint(d) == 0x80000000u);
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

// One level of a transposed butterfly over a warp's lane partial sums:
// lanes with bit OFF set keep v[H, 2H), the others v[0, H), each adding
// the partner's copy of the half it keeps into v[0, H).  Levels at offsets
// 16, 8, ... leave each lane one value, which xor shuffles at the smaller
// offsets complete; every addition pairs the same two partial sums as the
// xor tree of one value at a time (s += shfl_xor(s, 16), 8, ..., 1), so the
// totals have that tree's bits.
template <int H, int OFF, int M>
__device__ __forceinline__ void butterfly_level(float (&v)[M]) {
  const bool up = (threadIdx.x & OFF) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

}  // namespace
