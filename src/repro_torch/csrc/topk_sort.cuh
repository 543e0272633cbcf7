// Exact top-K of a score row over packed keys (sm_90a), in `lax.top_k`'s
// order: scores descending, ties by ascending index.  `topk_desc` (a
// bitonic sort) serves the chunk-prefill landmark step and the paged
// finalize's merge for large K; `topk_radix` (a radix select) the
// finalize's merge for K <= 128.
//
// Each candidate c with score s becomes one 64-bit key: the high word is
// the float's bits made order-preserving (negative floats inverted,
// positive ones with the sign bit set; -0 counts as +0), the low word is
// ~c, so that among equal scores the smaller index has the larger key.
// Keys are unique, so a descending sort of them IS the order wanted, and
// the result does not depend on the number of threads or on scheduling.
//
// A row of any length goes through a buffer of N keys (N a power of two,
// N >= 2K; in shared memory, or in global memory where a large K needs a
// buffer beyond it): the first K entries hold the running best, the other
// N - K are filled with the next slice of candidates, the buffer is sorted,
// and its first K entries are the top K of everything seen so far.  This
// is exact: the top K of a union lies in the union of the parts' top K.  A
// row of at most N - K candidates takes one sort.

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

// Sorts a[0..n_buf) descending (n_buf a power of two) with all threads of
// the block; starts with the keys in place (the caller's barrier) and ends
// with a barrier.  `a` may lie in shared or in global memory.
__device__ __forceinline__ void bitonic_sort_desc(uint64_t* a, int n_buf,
                                                  int tid, int n_threads) {
  for (int k = 2; k <= n_buf; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < n_buf / 2; p += n_threads) {
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
// packed keys (`key_index` gives c), sorted; buf holds n_buf keys (a power
// of two), k <= n_buf / 2.  Ends with a barrier.
template <typename ScoreFn>
__device__ __forceinline__ void topk_desc(uint64_t* buf, int n_buf, int n,
                                          int k, ScoreFn score, int tid,
                                          int n_threads) {
  for (int i = tid; i < k; i += n_threads) buf[i] = kEmpty;
  if (n <= 0) __syncthreads();
  for (int c0 = 0; c0 < n; c0 += n_buf - k) {
    for (int i = tid; i < n_buf - k; i += n_threads) {
      const int c = c0 + i;
      buf[k + i] = c < n ? pack_key(score(c), c) : kEmpty;
    }
    __syncthreads();
    bitonic_sort_desc(buf, n_buf, tid, n_threads);
  }
}

template <int N, typename ScoreFn>
__device__ __forceinline__ void topk_desc(uint64_t* buf, int n, int k,
                                          ScoreFn score, int tid,
                                          int n_threads) {
  topk_desc(buf, N, n, k, score, tid, n_threads);
}

// Top-kk of the keys a block holds in registers, E a thread (kEmpty for
// none), kk <= the number of keys: sorted descending into out[0..kk).  A
// radix select finds the smallest selected key: 8 bits a pass from the
// top, a 256-bin histogram of the keys that share the digits fixed so far
// (integer atomics in shared memory: counts, so the result does not depend
// on their order; two histograms in turn, so a pass takes two barriers),
// stopping at the first digit whose bucket holds exactly the keys still
// needed -- keys are unique, so the last digit always does.  The kk keys at
// or above it are gathered in any order; each one's place is the number of
// gathered keys above it.  So the result is exact and in `topk_desc`'s
// order.  hist: 519 ints of shared memory; n_threads even and kk <=
// n_threads / 2 (two threads place each key, all in one pass, since the
// keys are placed within `out` itself; a larger kk traps).  Ends with a
// barrier.
template <int E>
__device__ __forceinline__ void topk_radix(const uint64_t (&key)[E], int kk,
                                           uint64_t* out, int* hist,
                                           int tid, int n_threads) {
  if (2 * kk > n_threads) __trap();
  for (int i = tid; i < 256; i += n_threads) hist[i] = 0;
  if (tid == 0) hist[518] = 0;  // the gather's count
  __syncthreads();
  uint64_t prefix = 0;  // the digits fixed so far
  int need = kk;        // keys still to take at or below the prefix
  for (int shift = 56, p = 0;; shift -= 8, p ^= 1) {
    int* h = hist + 256 * p;
    int* res = hist + 512 + 3 * p;  // digit, keys still needed, bin count
    const uint64_t above = shift == 56 ? 0 : ~0ull << (shift + 8);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (key[e] != kEmpty && (key[e] & above) == prefix)
        atomicAdd(&h[(key[e] >> shift) & 255], 1);
    }
    __syncthreads();
    if (tid < 32) {  // lane l scans bins 255 - 8l down to 248 - 8l
      int c[8], sum = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = h[255 - 8 * tid - b];
        sum += c[b];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      int higher = incl - sum;  // keys in the bins above this lane's
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (higher < need && higher + c[b] >= need) {
          res[0] = 255 - 8 * tid - b;
          res[1] = need - higher;
          res[2] = c[b];
        }
        higher += c[b];
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) hist[256 * (p ^ 1) + 8 * tid + b] = 0;
    }
    __syncthreads();
    prefix |= (uint64_t)res[0] << shift;
    const bool whole = res[1] == res[2];
    need = res[1];
    if (whole) break;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (key[e] != kEmpty && key[e] >= prefix)
      out[atomicAdd(&hist[518], 1)] = key[e];
  }
  __syncthreads();
  // each gathered key's place: two threads count the keys above it
  const int i = tid / 2, half = tid & 1;
  const uint64_t mine = i < kk ? out[i] : kEmpty;
  int place = 0;
  for (int j = half; j < kk; j += 2) place += out[j] > mine;
  place += __shfl_xor_sync(0xffffffffu, place, 1);
  __syncthreads();
  if (i < kk && half == 0) out[place] = mine;
  __syncthreads();
}

}  // namespace topk_sort
