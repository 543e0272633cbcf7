// Exact top-K of a score row by a bitonic sort of packed keys in shared
// memory (sm_90a), in `lax.top_k`'s order: scores descending, ties by
// ascending index.  Used by the chunk-prefill landmark step; written so
// that the paged finalize (the same top-K of a slot's context) can call it.
//
// Each candidate c with score s becomes one 64-bit key: the high word is
// the float's bits made order-preserving (negative floats inverted,
// positive ones with the sign bit set; -0 counts as +0), the low word is
// ~c, so that among equal scores the smaller index has the larger key.
// Keys are unique, so a descending sort of them IS the order wanted, and
// the result does not depend on the number of threads or on scheduling.
//
// A row of any length goes through a buffer of N keys (N a power of two,
// N >= 2K): the first K entries hold the running best, the other N - K are
// filled with the next slice of candidates, the buffer is sorted, and its
// first K entries are the top K of everything seen so far.  This is exact:
// the top K of a union lies in the union of the parts' top K.  A row of at
// most N - K candidates takes one sort.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace topk_sort {

constexpr uint64_t kEmpty = 0;  // below every packed key

__device__ __forceinline__ uint64_t pack_key(float s, int c) {
  uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint64_t)(~(uint32_t)c);
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return (int)~(uint32_t)key;
}

// Sorts a[0..N) descending with all threads of the block; starts with the
// keys in place (the caller's barrier) and ends with a barrier.
template <int N>
__device__ void bitonic_sort_desc(uint64_t* a, int tid, int n_threads) {
  for (int k = 2; k <= N; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < N / 2; p += n_threads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));  // bit j clear
        const int ixj = i | j;
        const uint64_t x = a[i], y = a[ixj];
        // runs with bit k clear end descending, the others ascending
        if (((i & k) == 0) ? (x < y) : (x > y)) {
          a[i] = y;
          a[ixj] = x;
        }
      }
      __syncthreads();
    }
}

// Top-k of the n scores score(c), c in [0, n), into buf[0..min(k, n)) as
// packed keys (`key_index` gives c), sorted; buf holds N keys, k <= N / 2.
// Ends with a barrier.
template <int N, typename ScoreFn>
__device__ void topk_desc(uint64_t* buf, int n, int k, ScoreFn score,
                          int tid, int n_threads) {
  for (int i = tid; i < k; i += n_threads) buf[i] = kEmpty;
  if (n <= 0) __syncthreads();
  for (int c0 = 0; c0 < n; c0 += N - k) {
    for (int i = tid; i < N - k; i += n_threads) {
      const int c = c0 + i;
      buf[k + i] = c < n ? pack_key(score(c), c) : kEmpty;
    }
    __syncthreads();
    bitonic_sort_desc<N>(buf, tid, n_threads);
  }
}

}  // namespace topk_sort
