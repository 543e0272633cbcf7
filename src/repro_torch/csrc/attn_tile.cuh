// Tile machinery shared by the CUDA-core attention kernels,
// `mita_expert_attn.cu`, `flash_attn.cu` and `mita_chunk_prefill.cu`
// (sm_90a).
//
// One block of kThreads threads owns a tile of TQ query rows and walks key
// tiles of TK rows with the online softmax of the Pallas kernels it
// replaces (`_expert_kernel`, `_flash_kernel`):
//
//   s      = q_scaled . k           (float32, masked lanes = NEG_INF)
//   m_cur  = max(m_prev, max_j s)
//   alpha  = m_prev == NEG_INF ? 0 : exp(m_prev - m_cur)
//   p      = s == NEG_INF ? 0 : exp(s - m_cur)
//   l      = l * alpha + sum_j p
//   acc    = acc * alpha + p . v
//
// Every product runs on the CUDA cores in float32 (inputs are float32 or
// bf16, widened on load), so float32 results agree with the plain PyTorch
// versions to rounding.  Shared memory holds the pre-scaled query tile, one
// key-or-value tile (the value tile overwrites the key tile once the scores
// are in shared memory), the score tile and the per-row statistics; rows
// are padded by one word so that the column walks of the score product hit
// distinct banks.  At d = 128 a block takes 84 KB, two blocks per SM.
// The output accumulator lives in registers: thread (tq, tc) owns rows
// 4*tq .. 4*tq+3 and columns tc + 16*j.  No atomics: each output element
// is written by one thread, so results do not depend on scheduling.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace attn_tile {

constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the mask value
constexpr int TQ = 64;               // query rows per block
constexpr int TK = 64;               // keys per tile (two per lane)
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;    // accumulator columns per thread
// The wide instance (head dims up to 256, recurrentgemma-9b's): twice the
// accumulator columns per thread; the tiles keep 64 rows, and at d = 256
// the block takes 149.5 KB of shared memory (one block per SM).
constexpr int kMaxDWide = 256;
constexpr int kColsWide = kMaxDWide / 16;
static_assert(TQ == TK, "load_tile serves both tiles");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory layout, in 4-byte words.
struct Smem {
  float* q;      // [TQ][d + 1] query tile, pre-scaled
  float* kv;     // [TK][d + 1] key tile, then value tile
  float* s;      // [TQ][TK + 1] scores, then softmax weights
  float* m;      // [TQ] running max
  float* l;      // [TQ] running sum
  float* alpha;  // [TQ] rescale factor of the current key tile
  int* qi;       // [TQ] per-row integer (the expert kernel's assignment)
  int* ki;       // [TK] per-key integer (the expert kernel's validity)
  __device__ Smem(float* base, int d) {
    q = base;
    kv = q + TQ * (d + 1);
    s = kv + TK * (d + 1);
    m = s + TQ * (TK + 1);
    l = m + TQ;
    alpha = l + TQ;
    qi = reinterpret_cast<int*>(alpha + TQ);
    ki = qi + TQ;
  }
};

__host__ __device__ inline long long smem_bytes(int d) {
  return 4LL * (TQ * (d + 1) + TK * (d + 1) + TQ * (TK + 1) + 3 * TQ + TQ +
                TK);
}

// rows x d elements of src (row-major, row stride d) into dst [64][d + 1],
// times scale; rows >= n_rows are zero (so masked lanes never meet NaN).
template <typename T>
__device__ void load_tile(float* dst, const T* src, int n_rows, int d,
                          float scale) {
  for (int idx = threadIdx.x; idx < TQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    dst[r * (d + 1) + c] =
        r < n_rows ? ld(src + (int64_t)r * d + c) * scale : 0.f;
  }
}

// 64 rows into dst [64][d + 1] as float, times scale: row r from src(r)
// (d contiguous values of any type `ld` reads), zeros where src(r) is
// null.
template <typename RowFn>
__device__ void gather_tile(float* dst, RowFn src, int d, float scale) {
  for (int idx = threadIdx.x; idx < TQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const auto p = src(r);
    dst[r * (d + 1) + c] = p != nullptr ? ld(p + c) * scale : 0.f;
  }
}

__device__ inline void init_stats(const Smem& S) {
  for (int r = threadIdx.x; r < TQ; r += kThreads) {
    S.m[r] = kNegInf;
    S.l[r] = 0.f;
  }
}

// s[r][j] = (q[r] . k[j]) * scale for the 4 x 4 micro-tile of this thread
// (rows 4*tq + i, keys tk + 16*j); lanes where ok(r, j) is false get
// NEG_INF.  Equal products stay equal (the scale multiplies the finished
// dot product).
template <typename OkFn>
__device__ __forceinline__ void score_tile(const Smem& S, int d, OkFn ok,
                                           float scale = 1.f) {
  const int tq = threadIdx.x >> 4, tk = threadIdx.x & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* qp = S.q + (tq * 4) * (d + 1);
  const float* kp = S.kv + tk * (d + 1);
  for (int c = 0; c < d; ++c) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = qp[i * (d + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = kp[j * 16 * (d + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tq * 4 + i, kk = tk + 16 * j;
      S.s[r * (TK + 1) + kk] = ok(r, kk) ? acc[i][j] * scale : kNegInf;
    }
}

// The online-softmax step over the score tile, one warp per row.
__device__ __forceinline__ void softmax_tile(const Smem& S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TQ; r += kThreads / 32) {
    float* s = S.s + r * (TK + 1);
    const float s0 = s[lane], s1 = s[lane + 32];
    const float m_prev = S.m[r];
    const float m_cur = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
    const float alpha = (m_prev == kNegInf) ? 0.f : expf(m_prev - m_cur);
    const float p0 = (s0 == kNegInf) ? 0.f : expf(s0 - m_cur);
    const float p1 = (s1 == kNegInf) ? 0.f : expf(s1 - m_cur);
    s[lane] = p0;
    s[lane + 32] = p1;
    const float sum = warp_sum(p0 + p1);
    if (lane == 0) {
      S.m[r] = m_cur;
      S.l[r] = S.l[r] * alpha + sum;
      S.alpha[r] = alpha;
    }
  }
}

// acc = acc * alpha + p . v for this thread's rows and columns (NC
// accumulator columns: kCols, or kColsWide for head dims above 128).
template <int NC>
__device__ __forceinline__ void pv_tile(const Smem& S, int d,
                                        float (&acc)[4][NC]) {
  const int tq = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int nc = d / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = S.alpha[tq * 4 + i];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (j < nc) acc[i][j] *= a;
  }
  const float* pp = S.s + (tq * 4) * (TK + 1);
  for (int k = 0; k < TK; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = pp[i * (TK + 1) + k];
    const float* vp = S.kv + k * (d + 1) + tc;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (j < nc) {
        const float v = vp[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
      }
  }
}

// One key tile: scores (masked by ok), softmax step, value product.  The
// caller has the query tile in place; keys/values are rows [0, n_keys) of
// k_rows / v_rows (row stride d).  Starts with a barrier, so per-key data
// that ok() reads may be written just before the call; ends with the value
// tile in use.
template <typename T, typename OkFn, int NC>
__device__ __forceinline__ void attend_tile(const Smem& S, const T* k_rows,
                                            const T* v_rows, int n_keys,
                                            int d, OkFn ok,
                                            float (&acc)[4][NC]) {
  __syncthreads();  // the previous tile's value product is done
  load_tile(S.kv, k_rows, n_keys, d, 1.f);
  __syncthreads();
  score_tile(S, d, ok);
  __syncthreads();
  load_tile(S.kv, v_rows, n_keys, d, 1.f);
  softmax_tile(S);
  __syncthreads();
  pv_tile(S, d, acc);
}

}  // namespace attn_tile
