// Fused batched chunk prefill for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `mita_chunk_prefill_fused`
//   (src/repro/kernels/mita_chunk_prefill.py:428, body `_chunk_kernel` at
//   :121), whose oracle is `core.mita_decode._batched_chunk_prefill_xla`.
//
// One prefill chunk of nc tokens for each of P rows (prefilling slots),
// per KV head.  The work has three steps that must run in order, and each
// is its own kernel, so the launch boundaries order them:
//
//   1. append_kernel, grid (nc, Hkv, P): each valid chunk row lands in the
//      pools at page_table[p, pos/w]*w + pos%w.  Padding and inactive rows
//      write nothing (the reference sends them to the scratch row, which
//      nothing reads).
//   2. landmark_kernel, grid (2M, Hkv, P): one block per landmark ordinal
//      of each of the two landmark systems -- B (the decode cache: w-sized
//      windows, lm_q / q_sum) and A (the training head's n//m-sized prompt
//      windows, pre_lm_q / pre_q_sum).  It resumes the system's open-window
//      query sum, commits the landmark query the chunk completes, and if
//      the landmark's key context is now complete scores it against the
//      slot's context, takes the top-K with first-index ties and the
//      softmax-weighted value.  B commits go to the state (expert rows as
//      GLOBAL pool rows, validity as bool bytes); the A products feed only
//      this chunk's attention and go to a workspace (context positions,
//      float32 values).
//   3. attend kernel, grid (ceil(nc / (64 / G)), Hkv, P): one block per
//      tile of 64 / G chunk positions of one (row, KV head), all G query
//      heads together: 64 query rows that share every key and value row
//      the block stages.  Prompt positions (< n_train) read the A system,
//      generated positions (the preemption-recompute shape) the B system
//      with decode-time landmark availability.  One online softmax per
//      query row runs over masked tiles of at most 64 keys:
//        - shared: the <= M landmark key/value rows of each system present
//          (masked per row by availability); the tile's masked scores are
//          the routing logits;
//        - routed: each row's n_route first-index argmax picks; the block
//          walks the DISTINCT picked experts (A and B experts apart) in
//          ascending order, gathers each one's K rows from the pools (B:
//          pool rows `expert_idx`, A: context positions `ws_tl`), masked by
//          validity and by whether the row picked it;
//        - local: the block walks the distinct windows of its rows; keys
//          are tiled from the window's first position (an absolute
//          position: the chunk's t0 never sets the tiling), masked
//          causally.
//      A row's bits therefore depend only on its own inputs: a tile in
//      which a row has no key leaves it unchanged bit for bit (its running
//      max does not move, so the rescale factor is exactly 1, and its
//      weights are exactly 0), so neither nc, t0, the other rows of the
//      batch nor the other positions of the tile change it (the engine's
//      chunk-size invariance and recompute-from-prompt preemption rest on
//      this).  B expert rows are read straight from the pools, so rows of
//      pages attached from the prefix cache need no mapping.
//
// Top-K: a bitonic sort of packed (score, index) keys in shared memory
// (topk_sort.cuh): exact, in lax.top_k's order, first-index ties included;
// a context longer than the sort buffer goes through it in slices, the
// running top-K merged with each slice.
//
// What bounds it on the H100: at the serving shapes (P = 4, Hkv = 8, G = 2,
// nc = 256, d = 128, M = 6, K = w = 128) the call must move ~3.6 MB (the
// chunk, the context rows before t0 once, the state), ~1 us, and do
// ~0.4 GFLOP of products: bytes, in bf16 and float32 alike.  What costs
// time is latency: three dependent launches, and in each block chains of
// gathers from L2, products and reductions.  The design shortens the
// chains:
//  * the attend step stages each key and value row once per block for 64
//    query rows (the first version read it once per query position and
//    head) and runs its products as 64 x 64 tiles:
//    - `attend_mma_kernel` (bf16, d = 64 or 128): one warpgroup; rows by
//      cp.async into the 128-byte-swizzled layout of attn_mma.cuh
//      (float32 A-system landmark values rounded to bf16 on the way),
//      S = Q K^T and O += P V as wgmma (P rounded to bf16, float32
//      accumulators), the softmax in registers with exp2;
//    - `attend_core_kernel` (float32, and bf16 at other head dims): the
//      same walk on the CUDA-core tile of attn_tile.cuh in full float32,
//      so float32 meets its 1e-5 tolerance.
//    A tile's pool rows are looked up once per key, not once per copy
//    (a routed expert's for all its tiles, a local tile's per tile: the
//    page-table division is per key), and its mask is a row part, read
//    once for each of a thread's rows, and a column part (a routed
//    tile's valid keys as one 64-bit ballot), built while S runs.
//    Per-tile timestamps on the card had put ~1.7 us of a ~4.6 us tile
//    into a mask read from shared memory per score, and ~0.8 us into the
//    copies' page-table divisions;
//  * the landmark step's top-K is O(vis log^2 vis) in shared memory (the
//    first version ranked every position against every other, O(vis^2)),
//    the two systems' builds run in separate blocks, two threads score a
//    context position with their half rows in flight, and the value sum
//    spreads positions over the block;
//  * the state on exit is written by the landmark step (no copies of the
//    state before the launches) and the append moves 16-byte vectors.
// What is left: issuing a tile's 16-byte copies (~1.2 us a tile) and the
// softmax.  Card times: PERF.md section 6 (scripts/ab_kernel.py).
//
// Float32 statistics, 64-bit row offsets, no atomics: the result does not
// depend on scheduling.  The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

#include "attn_mma.cuh"
#include "attn_tile.cuh"
#include "topk_sort.cuh"

namespace {

using attn_tile::ld;
using attn_tile::st;

constexpr float kNegInf = -FLT_MAX;
constexpr int kLmThreads = 256;
constexpr int kLmWarps = kLmThreads / 32;
constexpr int kSortN = 1024;   // top-K sort buffer, K <= kSortN / 2
constexpr int kRows = 64;      // query rows (position, head) per attend block
constexpr int kKeys = 64;      // keys per attend tile

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ float block_max(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = attn_tile::warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kLmWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = attn_tile::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < kLmWarps; ++i) r += red[i];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int64_t pool_row(const int32_t* pt, int c, int w) {
  return (int64_t)pt[c / w] * w + c % w;
}

// 8 consecutive values (16-byte aligned for bf16, 32 for float) as float.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Landmark-kernel shared memory, in 4-byte words (the sort buffer 8-byte
// aligned).
struct LmLayout {
  int q, red, vsum, wsum, sc, buf, total;
  __host__ __device__ LmLayout(int d, int m_slot, int w) {
    const int ctx = m_slot * w;
    q = 0;
    red = q + d;
    vsum = red + kLmWarps;
    wsum = vsum + 8 * kLmThreads;  // <= kLmThreads / (d / 8) slices of d
    sc = wsum + 8 * kLmThreads;
    buf = (sc + ctx + 1) & ~1;
    total = buf + 2 * kSortN;
  }
};

// ---------------------------------------------------------------- append --

// 16-byte vectors: a block of 128 threads moves 128 / (d * sizeof(T) / 16)
// chunk rows.
template <typename T>
__global__ void append_kernel(const T* __restrict__ k,
                              const T* __restrict__ v, T* k_pool, T* v_pool,
                              const int32_t* __restrict__ pt,
                              const int32_t* __restrict__ t0,
                              const int32_t* __restrict__ nv,
                              const uint8_t* __restrict__ active, int hkv,
                              int nc, int d, int m_slot, int w) {
  const int h = blockIdx.y, p = blockIdx.z;
  const int chunks = d * (int)sizeof(T) / 16, rows = blockDim.x / chunks;
  const int n = blockIdx.x * rows + threadIdx.x / chunks;
  const int c = threadIdx.x % chunks;
  if (!active[p] || threadIdx.x >= rows * chunks || n >= nv[p]) return;
  const int pos = t0[p] + n;
  const int page = min(pos / w, m_slot - 1);
  const int64_t row = (int64_t)pt[(int64_t)p * m_slot + page] * w + pos % w;
  const int64_t src = (((int64_t)p * hkv + h) * nc + n) * d;
  const int64_t dst = (row * hkv + h) * d;
  reinterpret_cast<uint4*>(k_pool + dst)[c] =
      reinterpret_cast<const uint4*>(k + src)[c];
  reinterpret_cast<uint4*>(v_pool + dst)[c] =
      reinterpret_cast<const uint4*>(v + src)[c];
}

// -------------------------------------------------------------- landmark --

// Score the landmark query sm[L.q] against context positions [0, vis),
// take the top-K (sort-based, first-index ties) and the softmax-weighted
// value.  B outputs (ei non-null): the picks committed as global rows +
// validity and the value in the landmark dtype.  A outputs (ws_tl
// non-null): the picks as context positions (-1 = masked lane) and the
// value in float32.  One call may write both.
template <typename T, int D>
__device__ void build_landmark(float* sm, const LmLayout& L, int vis,
                               const T* __restrict__ k_pool,
                               const T* __restrict__ v_pool,
                               const int32_t* pt, int h, int hkv, int k_w,
                               int w, int32_t* ei, uint8_t* ev, T* lmv,
                               int32_t* ws_tl, float* ws_v) {
  float* sc = sm + L.sc;
  uint64_t* buf = reinterpret_cast<uint64_t*>(sm + L.buf);
  const float* qv = sm + L.q;
  const float scale = sqrtf((float)D);
  const int64_t rs = (int64_t)hkv * D;

  // two threads per context position, each with half its key row in
  // flight; the halves are added by one shuffle
  constexpr int HALF = D / 2;
  const int half = threadIdx.x & 1;
  for (int c0 = 0; c0 < vis; c0 += kLmThreads / 2) {
    const int c = c0 + threadIdx.x / 2;
    float acc = 0.f;
    if (c < vis) {
      const T* kr = k_pool + pool_row(pt, c, w) * rs + (int64_t)h * D +
                    half * HALF;
      float x[HALF];
#pragma unroll
      for (int i = 0; i < HALF; i += 8)
        load8(kr + i, *reinterpret_cast<float(*)[8]>(x + i));
#pragma unroll
      for (int i = 0; i < HALF; ++i)
        acc = fmaf(qv[half * HALF + i], x[i], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (c < vis && half == 0) sc[c] = acc / scale;
  }
  __syncthreads();

  topk_sort::topk_desc<kSortN>(buf, vis, k_w, [&](int c) { return sc[c]; },
                               threadIdx.x, kLmThreads);
  const int kvis = min(k_w, vis);
  for (int r = threadIdx.x; r < k_w; r += kLmThreads) {
    const bool valid = r < kvis;
    // masked lanes follow in index order, as lax.top_k returns them
    const int c = valid ? topk_sort::key_index(buf[r]) : vis + (r - kvis);
    if (ei != nullptr) {
      ei[r] = (int32_t)pool_row(pt, c, w);
      ev[r] = valid ? 1 : 0;
    }
    if (ws_tl != nullptr) ws_tl[r] = valid ? c : -1;
  }

  // softmax over the visible lanes (masked lanes weigh exactly 0)
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < vis; c += kLmThreads) mx = fmaxf(mx, sc[c]);
  mx = block_max(mx, sm + L.red);
  float sum = 0.f;
  for (int c = threadIdx.x; c < vis; c += kLmThreads)
    sum += expf(sc[c] - mx);
  sum = block_sum(sum, sm + L.red);
  for (int c = threadIdx.x; c < vis; c += kLmThreads)
    sc[c] = expf(sc[c] - mx) / sum;
  __syncthreads();

  // the weighted value: thread (slice s, 8 features f) sums positions
  // s, s + n_slices, ...; the slices' sums are added in slice order
  constexpr int n_chunks = D / 8, n_slices = kLmThreads / n_chunks;
  const int f8 = 8 * (threadIdx.x % n_chunks), slice = threadIdx.x / n_chunks;
  if (slice < n_slices) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = slice; c < vis; c += n_slices) {
      float x[8];
      load8(v_pool + pool_row(pt, c, w) * rs + (int64_t)h * D + f8, x);
      const float pc = sc[c];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(pc, x[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sm[L.vsum + slice * D + f8 + j] = acc[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kLmThreads) {
    float a = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) a += sm[L.vsum + sl * D + i];
    if (lmv != nullptr) st(lmv + i, a);
    if (ws_v != nullptr) ws_v[i] = a;
  }
  __syncthreads();
}

// The landmark step's operands (pointers in the pool dtype where not
// stated); `*_in` is the rows' state on entry, the rest the state on exit
// (written whole) and the A-system workspace.
struct LmArgs {
  const void *q, *k_pool, *v_pool, *lmq_in, *lmv_in, *plmq_in;
  const int32_t* ei_in;
  const uint8_t* ev_in;
  const float *qs_in, *pqs_in;
  void *lmq, *lmv, *plmq;
  int32_t* ei;
  uint8_t* ev;
  float *qs, *pqs, *ws_v;
  int32_t* ws_tl;
  const int32_t *page_table, *t0, *nv, *ntr;
  const uint8_t* active;
  int hkv, g, nc, m_slot, k_w, w;
};

// Block (li + M * sys, h, p): landmark li of one system -- sys 0 the B
// system (the decode cache), sys 1 the A system (the prompt windows) --
// so the two systems' builds run side by side.
template <typename T, int D>
__global__ void __launch_bounds__(kLmThreads)
    landmark_kernel(const LmArgs a) {
  const int m_slot = a.m_slot;
  const int li = blockIdx.x % m_slot, b_sys = blockIdx.x < m_slot;
  const int h = blockIdx.y, p = blockIdx.z;
  const int hkv = a.hkv, g = a.g, nc = a.nc, k_w = a.k_w, w = a.w;
  const T* q = static_cast<const T*>(a.q);
  const T* k_pool = static_cast<const T*>(a.k_pool);
  const T* v_pool = static_cast<const T*>(a.v_pool);
  // this system's landmark queries on entry and on exit
  const T* lq_in = static_cast<const T*>(b_sys ? a.lmq_in : a.plmq_in);
  T* lq = static_cast<T*>(b_sys ? a.lmq : a.plmq);
  T* lmv = static_cast<T*>(a.lmv);
  const float* sum_in = b_sys ? a.qs_in : a.pqs_in;
  float* sum_out = b_sys ? a.qs : a.pqs;
  extern __shared__ float sm[];
  const LmLayout L(D, m_slot, w);
  const int64_t ph = (int64_t)p * hkv + h;
  const int64_t lm_off = (ph * m_slot + li) * D;
  const int64_t e_off = (ph * m_slot + li) * k_w;

  // 0. the state on exit starts as the state on entry (this landmark's
  // rows of this system; the open-window sum by block 0 of an inactive
  // row -- an active row's is written whole below)
  for (int i = threadIdx.x; i < D; i += kLmThreads) {
    lq[lm_off + i] = lq_in[lm_off + i];
    if (b_sys) lmv[lm_off + i] = static_cast<const T*>(a.lmv_in)[lm_off + i];
  }
  if (b_sys)
    for (int r = threadIdx.x; r < k_w; r += kLmThreads) {
      a.ei[e_off + r] = a.ei_in[e_off + r];
      a.ev[e_off + r] = a.ev_in[e_off + r];
    }
  if (!a.active[p]) {              // inactive rows pass through
    if (li == 0)
      for (int i = threadIdx.x; i < D; i += kLmThreads)
        sum_out[ph * D + i] = sum_in[ph * D + i];
    return;
  }
  const int tp = a.t0[p], new_end = tp + a.nv[p], ntp = a.ntr[p];
  const int m_train = ntp / w;
  const int m_a = max(m_train, 1);
  const int w_a = max(ntp / m_a, 1);
  const int32_t* pt = a.page_table + (int64_t)p * m_slot;
  // this system's window: B w-sized, A w_a-sized over the prompt
  const int ww = b_sys ? w : w_a;
  const int wend = (li + 1) * ww;
  const int hi = b_sys ? min(wend, new_end) : min(wend, min(new_end, ntp));

  // 1. the window's query sum: thread (slice, 8 features) adds the
  // group-mean queries of its positions p with p % n_slices == slice;
  // the slices' sums are added in slice order
  constexpr int n_chunks = D / 8, n_slices = kLmThreads / n_chunks;
  const int f8 = 8 * (threadIdx.x % n_chunks), slice = threadIdx.x / n_chunks;
  if (slice < n_slices) {
    const T* qb = q + ph * g * nc * D + f8;
    const int lo = max(li * ww, tp);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int pos = lo + (slice - lo % n_slices + n_slices) % n_slices;
         pos < hi; pos += n_slices) {
      float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int gg = 0; gg < g; ++gg) {      // group mean of the query
        float x[8];
        load8(qb + ((int64_t)gg * nc + (pos - tp)) * D, x);
#pragma unroll
        for (int j = 0; j < 8; ++j) s8[j] += x[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += s8[j] / (float)g;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sm[L.wsum + slice * D + f8 + j] = acc[j];
  }
  __syncthreads();
  // B commits a query whose window the chunk completes; A likewise, for
  // landmarks of the prompt
  const bool q_due = wend > tp && wend <= new_end && (b_sys || li < m_a);
  const int open = new_end / ww;
  for (int i = threadIdx.x; i < D; i += kLmThreads) {
    float sum = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) sum += sm[L.wsum + sl * D + i];
    if (li == tp / ww && tp % ww != 0 && (b_sys || tp < ntp))
      sum += sum_in[ph * D + i];           // resume the open window
    float lq_i = ld(lq_in + lm_off + i);
    if (q_due) {
      lq_i = round_to(sum / (float)ww, lq);
      st(lq + lm_off + i, lq_i);
    }
    sm[L.q + i] = lq_i;
    if (li == open)
      sum_out[ph * D + i] = sum;
    else if (li == 0 && open >= m_slot)
      sum_out[ph * D + i] = 0.f;
  }
  __syncthreads();

  // 2. B: commit the landmark once its key context is complete (prompt
  // landmarks see the prompt's w_a-sized windows);
  // 3. A: the products for the landmarks this chunk's prompt positions can
  // see (recomputed every chunk; pages are append-only)
  if (b_sys) {
    const int ends_b = li < m_train ? (li + 1) * w_a : wend;
    if (ends_b > tp && ends_b <= new_end)
      build_landmark<T, D>(sm, L, ends_b, k_pool, v_pool, pt, h, hkv, k_w, w,
                           a.ei + e_off, a.ev + e_off, lmv + lm_off, nullptr,
                           nullptr);
  } else if (li < m_a && wend <= min(new_end, ntp)) {
    build_landmark<T, D>(sm, L, wend, k_pool, v_pool, pt, h, hkv, k_w, w,
                         nullptr, nullptr, nullptr, a.ws_tl + e_off,
                         a.ws_v + lm_off);
  }
}

// ---------------------------------------------------------------- attend --

// The CUDA-core tile engine: attn_tile.cuh's float32 64 x 64 tile, 256
// threads; scores are the finished dot products times 1/sqrt(d), as the
// reference divides them, so exactly equal products stay tied.
template <typename T>
struct CoreEngine {
  static constexpr int kThreads = attn_tile::kThreads;
  using Elem = T;
  attn_tile::Smem S;
  int d;
  float scale;
  float acc[4][attn_tile::kCols];

  const void* any_ = nullptr;  // unused: every copy is synchronous

  __host__ __device__ static size_t smem_bytes(int d) {
    return (size_t)attn_tile::smem_bytes(d);
  }

  __device__ CoreEngine(uint8_t* base, int d_, float scale_)
      : S(reinterpret_cast<float*>(base), d_), d(d_), scale(scale_) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < attn_tile::kCols; ++j) acc[i][j] = 0.f;
    attn_tile::init_stats(S);
  }

  template <typename RowFn>
  __device__ void load_q(RowFn src) {
    attn_tile::gather_tile(S.q, src, d, 1.f);
  }

  // One tile of <= 64 keys: key / value row kk from krow(kk) / vrow(kk)
  // (null: zeros); the lane (r, kk) is kept where
  // col_ok(row_ok(r), kk) -- the mask in a row part, looked up once per
  // row, and a cheap column part; with kCap, cap(r, kk, s) sees every
  // masked score before the softmax.
  template <bool kCap, typename KF, typename VF, typename RowFn,
            typename ColFn, typename CapFn>
  __device__ void attend(KF krow, VF vrow, RowFn row_ok, ColFn col_ok,
                         CapFn cap) {
    __syncthreads();  // the previous tile's value product is done
    attn_tile::gather_tile(S.kv, krow, d, 1.f);
    __syncthreads();
    attn_tile::score_tile(
        S, d, [&](int r, int kk) { return col_ok(row_ok(r), kk); }, scale);
    __syncthreads();
    if constexpr (kCap) {
      for (int i = threadIdx.x; i < kRows * kKeys; i += kThreads)
        cap(i / kKeys, i % kKeys, S.s[(i / kKeys) * (kKeys + 1) + i % kKeys]);
      __syncthreads();
    }
    attn_tile::gather_tile(S.kv, vrow, d, 1.f);
    attn_tile::softmax_tile(S);
    __syncthreads();
    attn_tile::pv_tile(S, d, acc);
  }

  // out(r, col, o) for every row and column, o = acc / l (0 where l = 0).
  template <typename OutFn>
  __device__ void finish(OutFn out) {
    __syncthreads();
    const int tq = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tq * 4 + i;
      const float l = S.l[r];
#pragma unroll
      for (int j = 0; j < attn_tile::kCols; ++j)
        if (j < d / 16) out(r, tc + 16 * j, l > 0.f ? acc[i][j] / l : 0.f);
    }
  }
};

// The tensor-core tile engine (bf16, D = 64 or 128): one warpgroup, the
// query, key and value tiles in the 128-byte-swizzled layout, S and P V as
// wgmma, statistics in raw-score units with exp2.
template <int D>
struct MmaEngine {
  static constexpr int kThreads = 128;
  using Elem = __nv_bfloat16;
  static constexpr int kTile = kRows * D * 2;  // bytes of one 64-row tile
  uint32_t sq, sk, sv;
  int r0, c0;
  float scale_log2;
  float acc[D / 2];
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  __host__ __device__ static size_t smem_bytes(int) {
    return 3 * kTile + 1024;
  }

  __device__ MmaEngine(uint8_t* base, int, float scale) {
    sq = (attn_mma::smem_u32(base) + 1023u) & ~1023u;
    sk = sq + kTile;
    sv = sk + kTile;
    const int lane = threadIdx.x % 32;
    r0 = 16 * (threadIdx.x / 32) + lane / 4;
    c0 = 2 * (lane % 4);
    scale_log2 = scale * 1.4426950408889634f;
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  }

  const void* any_ = nullptr;  // a readable address for zero-filled copies

  template <typename RowFn>
  __device__ void load_q(RowFn src) {
    attn_mma::gather_tile_async<D, kRows, kThreads>(sq, src, any_,
                                                    threadIdx.x);
    attn_mma::cp_async_commit();
  }

  template <bool kCap, typename KF, typename VF, typename RowFn,
            typename ColFn, typename CapFn>
  __device__ void attend(KF krow, VF vrow, RowFn row_ok, ColFn col_ok,
                         CapFn cap) {
    using namespace attn_mma;
    const int tid = threadIdx.x;
    __syncthreads();  // the previous tile's products are done
    gather_tile_async<D, kKeys, kThreads>(sk, krow, any_, tid);
    cp_async_commit();
    gather_tile_async<D, kKeys, kThreads>(sv, vrow, any_, tid);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K are in
    fence_proxy_async();
    __syncthreads();

    float s[kKeys / 2];
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x) s[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          make_desc(sq + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          make_desc(sk + (kk / 4) * kKeys * 128 + (kk % 4) * 32, 16, 1024);
      wgmma_ss_n64(s, da, db, kk > 0);
    }
    wgmma_commit();
    // the mask of this thread's 32 scores while the product runs: the
    // row part once for each of its two rows
    const int rk[2] = {row_ok(r0), row_ok(r0 + 8)};
    uint32_t okm = 0;
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x)
      okm |= (uint32_t)col_ok(rk[(x >> 1) & 1], 8 * (x >> 2) + c0 + (x & 1))
             << x;
    wgmma_wait<0>();
    fence_regs(s);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int x = 0; x < kKeys / 2; ++x) {
      const int i = (x >> 1) & 1;
      if (!((okm >> x) & 1u)) s[x] = kNegInf;
      if constexpr (kCap)
        cap(r0 + 8 * i, 8 * (x >> 2) + c0 + (x & 1), s[x]);
      mx[i] = fmaxf(mx[i], s[x]);
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // exactly 1 where the max does not move (a row with no key here)
      alpha[i] = m_new == m_run[i]     ? 1.f
                 : m_run[i] == kNegInf ? 0.f
                                       : ex2((m_run[i] - m_new) * scale_log2);
      mc[i] = (m_new == kNegInf) ? 0.f : m_new * scale_log2;
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int x = 0; x < kKeys / 2; x += 2) {
      const int i = (x >> 1) & 1, jb = x >> 2;
      const float p0 = ex2(fmaf(s[x], scale_log2, -mc[i]));
      const float p1 = ex2(fmaf(s[x + 1], scale_log2, -mc[i]));
      l_run[i] += p0 + p1;
      // S register 4 jb + 2 i -> A fragment [jb / 2][2 (jb % 2) + i]
      pa[jb >> 1][2 * (jb & 1) + i] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];

    cp_async_wait<0>();  // V is in
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t db = make_desc(sv + kk * 16 * 128, kKeys * 128, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128(acc, pa[kk], db, 1);
      else
        wgmma_rs_n64(acc, pa[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  template <typename OutFn>
  __device__ void finish(OutFn out) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
#pragma unroll
    for (int x = 0; x < D / 2; ++x) {
      const int i = (x >> 1) & 1;
      const float l = l_run[i];
      out(r0 + 8 * i, 8 * (x >> 2) + c0 + (x & 1),
          l > 0.f ? acc[x] / l : 0.f);
    }
  }
};

// Per-row bookkeeping of an attend block.
struct Rows {
  int pos[kRows];      // absolute position; -1: no output computed here
  int start[kRows];    // the row's local window's first position
  int sys[kRows];      // 1: prompt position (A system), 0: generated (B)
  uint8_t sel[kRows];  // the row takes part in the current routed tile
  uint64_t kmask;      // the current routed tile's valid keys, bit t
  int red[2];
};

// The attend step's operands (pointers in the pool dtype where not
// stated); see the entry point for what each holds.
struct AttendArgs {
  const void *q, *k_pool, *v_pool, *lmq, *lmv, *plmq;
  const int32_t* ei;
  const uint8_t* ev;
  const float* ws_v;
  const int32_t* ws_tl;
  void* out;
  const int32_t *page_table, *t0, *nv, *ntr;
  const uint8_t* active;
  int hkv, g, nc, d, m_slot, k_w, w, n_route, external;
};

template <typename Eng>
__device__ __forceinline__ void attend_body(const AttendArgs& a) {
  using T = typename Eng::Elem;
  constexpr int NT = Eng::kThreads;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ Rows R;
  const T* q = static_cast<const T*>(a.q);
  const T* k_pool = static_cast<const T*>(a.k_pool);
  const T* v_pool = static_cast<const T*>(a.v_pool);
  const T* lmq = static_cast<const T*>(a.lmq);
  const T* lmv = static_cast<const T*>(a.lmv);
  const T* plmq = static_cast<const T*>(a.plmq);
  const int32_t *ei = a.ei, *ws_tl = a.ws_tl;
  const uint8_t* ev = a.ev;
  const float* ws_v = a.ws_v;
  T* out = static_cast<T*>(a.out);
  const int hkv = a.hkv, g = a.g, nc = a.nc, d = a.d, m_slot = a.m_slot;
  const int k_w = a.k_w, w = a.w, n_route = a.n_route;
  const bool external = a.external != 0;
  const int h = blockIdx.y, p = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % 32;
  const int tp = kRows / g, n0 = blockIdx.x * tp;
  const int64_t ph = (int64_t)p * hkv + h;
  const int64_t rs = (int64_t)hkv * d;
  const int32_t* pt = a.page_table + (int64_t)p * m_slot;
  const int t0p = a.t0[p], nvp = a.nv[p], ntp = a.ntr[p];
  const bool act = a.active[p] != 0;
  const int m_a = max(ntp / w, 1);
  const int w_a = max(ntp / m_a, 1);
  const float scale = 1.f / sqrtf((float)d);

  auto out_row = [&](int r) -> T* {  // null past the chunk or G
    const int gg = r / tp, n = n0 + r % tp;
    return (gg < g && n < nc) ? out + ((ph * g + gg) * nc + n) * d : nullptr;
  };
  if (!act || n0 >= nvp) {  // padding / inactive rows: zeros
    for (int i = tid; i < kRows * d; i += NT) {
      T* o = out_row(i / d);
      if (o != nullptr) st(o + i % d, 0.f);
    }
    return;
  }
  for (int r = tid; r < kRows; r += NT) {
    const int gg = r / tp, n = n0 + r % tp;
    int pos = -1, start = 0, sys = 0;
    if (gg < g && n < nvp) {
      pos = t0p + n;
      sys = pos < ntp;
      start = sys ? (pos / w_a) * w_a : (pos / w) * w;
    }
    R.pos[r] = pos;
    R.start[r] = start;
    R.sys[r] = sys;
  }
  Eng E(smem_raw, d, scale);
  E.any_ = k_pool;
  // dynamic shared memory past the engine's: the routing logits
  // [64][M], the picks [64][n_route], the current routed expert's pool
  // rows [K] and the current local tile's [64] (-1: masked)
  float* rlog = reinterpret_cast<float*>(smem_raw + Eng::smem_bytes(d));
  int* picks = reinterpret_cast<int*>(rlog + kRows * m_slot);
  int* erow = picks + kRows * n_route;
  int* lrow = erow + k_w;
  for (int i = tid; i < kRows * m_slot; i += NT) rlog[i] = kNegInf;
  __syncthreads();
  auto prow = [&](int c) { return pool_row(pt, c, w); };  // pool row
  E.load_q(
      [&](int r) -> const T* {
        return R.pos[r] >= 0
                   ? q + ((ph * g + r / tp) * nc + n0 + r % tp) * d
                   : nullptr;
      });

  // the largest position of the block's rows in system `sys` (-1: none),
  // then the landmarks it can see (a prefix of the ordinals)
  auto n_visible = [&](int sys) {
    if (tid < 32) {
      int mp = -1;
      for (int r = lane; r < kRows; r += 32)
        if (R.pos[r] >= 0 && R.sys[r] == sys) mp = max(mp, R.pos[r]);
      mp = __reduce_max_sync(0xffffffffu, mp);
      if (lane == 0) R.red[0] = mp;
    }
    __syncthreads();
    const int mp = R.red[0];
    __syncthreads();
    if (mp < 0) return 0;
    return sys ? min(m_a, (mp + 1) / w_a)
               : min(m_slot, (mp + (external ? 0 : 1)) / w);
  };
  auto avail = [&](int sys, int li, int pos) {
    return sys ? ((li + 1) * w_a <= pos + 1 && li < m_a)
               : ((li + 1) * w <= pos + (external ? 0 : 1));
  };

  // ---- shared branch; its masked scores are the routing logits
  for (int sys = 1; sys >= 0; --sys) {
    const int n_av = n_visible(sys);
    const T* kbase = (sys ? plmq : lmq) + ph * m_slot * d;
    for (int li0 = 0; li0 < n_av; li0 += kKeys) {
      auto krow = [&](int kk) -> const T* {
        return li0 + kk < n_av ? kbase + (int64_t)(li0 + kk) * d : nullptr;
      };
      // row part: the row's position if it reads this system, else -1
      auto row_ok = [&](int r) {
        return R.sys[r] == sys ? R.pos[r] : -1;
      };
      auto col_ok = [&](int pos, int kk) {
        return pos >= 0 && li0 + kk < n_av && avail(sys, li0 + kk, pos);
      };
      auto cap = [&](int r, int kk, float s) {
        if (R.pos[r] >= 0 && R.sys[r] == sys && li0 + kk < n_av)
          rlog[r * m_slot + li0 + kk] = s;
      };
      if (sys)
        E.template attend<true>(
            krow,
            [&](int kk) -> const float* {
              return li0 + kk < n_av ? ws_v + (ph * m_slot + li0 + kk) * d
                                     : nullptr;
            },
            row_ok, col_ok, cap);
      else
        E.template attend<true>(
            krow,
            [&](int kk) -> const T* {
              return li0 + kk < n_av ? lmv + (ph * m_slot + li0 + kk) * d
                                     : nullptr;
            },
            row_ok, col_ok, cap);
    }
  }
  __syncthreads();  // routing logits complete

  // ---- routed branch: n_route first-index argmax picks per row, as
  // expert keys sys * M + ordinal
  for (int r = tid; r < kRows; r += NT) {
    float* rr = rlog + r * m_slot;
    int* pk = picks + r * n_route;
    for (int j = 0; j < n_route; ++j) pk[j] = -1;
    if (R.pos[r] < 0) continue;
    for (int j = 0; j < n_route; ++j) {
      float best = -INFINITY;
      int bi = 0;
      for (int li = 0; li < m_slot; ++li)
        if (rr[li] > best) {
          best = rr[li];
          bi = li;
        }
      if (!(best > kNegInf / 2)) break;  // only masked lanes remain
      rr[bi] = -INFINITY;                 // retired
      pk[j] = R.sys[r] * m_slot + bi;
    }
  }
  const T* kb = k_pool + (int64_t)h * d;
  const T* vb = v_pool + (int64_t)h * d;
  auto no_cap = [](int, int, float) {};
  for (int e_prev = -1;;) {
    __syncthreads();  // picks in place; the last tile's products are done
    if (tid < 32) {   // the smallest picked expert key above e_prev
      int e = INT_MAX;
      for (int i = lane; i < kRows * n_route; i += 32)
        if (picks[i] > e_prev && picks[i] < e) e = picks[i];
      e = __reduce_min_sync(0xffffffffu, e);
      if (lane == 0) R.red[0] = e;
    }
    __syncthreads();
    const int ek = R.red[0];
    if (ek == INT_MAX) break;
    const int sys = ek >= m_slot ? 1 : 0, e = ek - sys * m_slot;
    const int64_t e_off = (ph * m_slot + e) * k_w;
    for (int r = tid; r < kRows; r += NT) {
      bool s = false;
      for (int j = 0; j < n_route; ++j) s |= picks[r * n_route + j] == ek;
      R.sel[r] = s;
    }
    // the expert's pool rows, all K at once (B: expert_idx where valid;
    // A: the context positions ws_tl)
    for (int kk = tid; kk < k_w; kk += NT) {
      int row = -1;
      if (sys) {
        const int c = ws_tl[e_off + kk];
        if (c >= 0) row = (int)prow(c);
      } else if (ev[e_off + kk]) {
        row = ei[e_off + kk];
      }
      erow[kk] = row;
    }
    __syncthreads();  // the rows in place for the tiles' key masks
    for (int kk0 = 0; kk0 < k_w; kk0 += kKeys) {
      auto key_row = [&](int t) {
        return kk0 + t < k_w ? erow[kk0 + t] : -1;
      };
      if (tid < 32) {  // the tile's valid keys as one 64-bit mask
        const uint32_t lo = __ballot_sync(0xffffffffu, key_row(tid) >= 0);
        const uint32_t hi =
            __ballot_sync(0xffffffffu, key_row(tid + 32) >= 0);
        if (tid == 0) R.kmask = (uint64_t)hi << 32 | lo;
      }
      E.template attend<false>(
          [&](int t) -> const T* {
            return key_row(t) >= 0 ? kb + key_row(t) * rs : nullptr;
          },
          [&](int t) -> const T* {
            return key_row(t) >= 0 ? vb + key_row(t) * rs : nullptr;
          },
          [&](int r) { return (int)R.sel[r]; },
          [&](int sel, int t) {
            return sel != 0 && ((R.kmask >> t) & 1u);
          },
          no_cap);
    }
    e_prev = ek;
  }

  // ---- local branch: each row's own window [start, pos]
  for (int s_prev = -1;;) {
    __syncthreads();
    if (tid < 32) {  // the smallest window start above s_prev, its last row
      int s = INT_MAX;
      for (int r = lane; r < kRows; r += 32)
        if (R.pos[r] >= 0 && R.start[r] > s_prev && R.start[r] < s)
          s = R.start[r];
      s = __reduce_min_sync(0xffffffffu, s);
      int mp = -1;
      for (int r = lane; r < kRows; r += 32)
        if (R.pos[r] >= 0 && R.start[r] == s) mp = max(mp, R.pos[r]);
      mp = __reduce_max_sync(0xffffffffu, mp);
      if (lane == 0) {
        R.red[0] = s;
        R.red[1] = mp;
      }
    }
    __syncthreads();
    const int s = R.red[0], mp = R.red[1];
    if (s == INT_MAX) break;
    for (int c0 = s; c0 <= mp; c0 += kKeys) {
      // the tile's pool rows, one lookup per key (not per copy)
      for (int t = tid; t < kKeys; t += NT)
        lrow[t] = c0 + t <= mp ? (int)prow(c0 + t) : -1;
      E.template attend<false>(
          [&](int t) -> const T* {
            return lrow[t] >= 0 ? kb + (int64_t)lrow[t] * rs : nullptr;
          },
          [&](int t) -> const T* {
            return lrow[t] >= 0 ? vb + (int64_t)lrow[t] * rs : nullptr;
          },
          // row part: the row's position if its window starts at s
          [&](int r) { return R.start[r] == s ? R.pos[r] : -1; },
          [&](int pos, int t) { return pos >= 0 && c0 + t <= pos; },
          no_cap);
    }
    s_prev = s;
  }

  E.finish([&](int r, int col, float o) {
    T* dst = out_row(r);
    if (dst != nullptr) st(dst + col, o);
  });
}

// The two attend kernels, named by the path they take.
template <int D>
__global__ void __launch_bounds__(MmaEngine<D>::kThreads)
    attend_mma_kernel(const AttendArgs a) {
  attend_body<MmaEngine<D>>(a);
}
template <typename T>
__global__ void __launch_bounds__(CoreEngine<T>::kThreads)
    attend_core_kernel(const AttendArgs a) {
  attend_body<CoreEngine<T>>(a);
}

// The attend step runs on the tensor cores for bf16 at d = 64 or 128.
bool mma_path(int dtype, int d) { return dtype == 1 && (d == 64 || d == 128); }

template <typename Eng>
size_t attend_smem(int d, int m_slot, int k_w, int n_route) {
  return Eng::smem_bytes(d) +
         (size_t)(kRows * (m_slot + n_route) + k_w + kKeys) * 4;
}

size_t attend_smem_of(int dtype, int d, int m_slot, int k_w, int n_route) {
  if (mma_path(dtype, d))
    return d == 128 ? attend_smem<MmaEngine<128>>(d, m_slot, k_w, n_route)
                    : attend_smem<MmaEngine<64>>(d, m_slot, k_w, n_route);
  return dtype == 0
             ? attend_smem<CoreEngine<float>>(d, m_slot, k_w, n_route)
             : attend_smem<CoreEngine<__nv_bfloat16>>(d, m_slot, k_w,
                                                      n_route);
}

template <typename Eng, typename Kern>
cudaError_t launch_attend(Kern kern, void* const* ptr, int P, int hkv, int g,
                          int nc, int d, int m_slot, int k_w, int w,
                          int n_route, int external, cudaStream_t stream) {
  const size_t smem = attend_smem<Eng>(d, m_slot, k_w, n_route);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const AttendArgs a{ptr[0], ptr[5], ptr[6], ptr[13], ptr[14], ptr[18],
                     (const int32_t*)ptr[15], (const uint8_t*)ptr[16],
                     (const float*)ptr[20], (const int32_t*)ptr[21], ptr[12],
                     (const int32_t*)ptr[7], (const int32_t*)ptr[8],
                     (const int32_t*)ptr[9], (const int32_t*)ptr[10],
                     (const uint8_t*)ptr[11], hkv, g, nc, d, m_slot, k_w, w,
                     n_route, external};
  const int tp = kRows / g;
  kern<<<dim3((nc + tp - 1) / tp, hkv, P), Eng::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_landmark(void* const* ptr, int P, int hkv, int g, int nc,
                            int m_slot, int k_w, int w, cudaStream_t stream) {
  const size_t smem = (size_t)LmLayout(D, m_slot, w).total * 4;
  auto kern = landmark_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const LmArgs a{ptr[0], ptr[5], ptr[6], ptr[22], ptr[23], ptr[26],
                 (const int32_t*)ptr[24], (const uint8_t*)ptr[25],
                 (const float*)ptr[3], (const float*)ptr[4], ptr[13],
                 ptr[14], ptr[18], (int32_t*)ptr[15], (uint8_t*)ptr[16],
                 (float*)ptr[17], (float*)ptr[19], (float*)ptr[20],
                 (int32_t*)ptr[21], (const int32_t*)ptr[7],
                 (const int32_t*)ptr[8], (const int32_t*)ptr[9],
                 (const int32_t*)ptr[10], (const uint8_t*)ptr[11], hkv, g,
                 nc, m_slot, k_w, w};
  kern<<<dim3(2 * m_slot, hkv, P), kLmThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(void* const* ptr, int P, int hkv, int g, int nc, int d,
                   int m_slot, int k_w, int w, int n_route, int external,
                   cudaStream_t stream) {
  const int rows = 128 / (d * (int)sizeof(T) / 16);
  append_kernel<T><<<dim3((nc + rows - 1) / rows, hkv, P), 128, 0,
                     stream>>>(
      (const T*)ptr[1], (const T*)ptr[2], (T*)ptr[5], (T*)ptr[6],
      (const int32_t*)ptr[7], (const int32_t*)ptr[8], (const int32_t*)ptr[9],
      (const uint8_t*)ptr[11], hkv, nc, d, m_slot, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  switch (d) {
    case 32: e = launch_landmark<T, 32>(ptr, P, hkv, g, nc, m_slot, k_w, w,
                                        stream); break;
    case 64: e = launch_landmark<T, 64>(ptr, P, hkv, g, nc, m_slot, k_w, w,
                                        stream); break;
    case 96: e = launch_landmark<T, 96>(ptr, P, hkv, g, nc, m_slot, k_w, w,
                                        stream); break;
    default: e = launch_landmark<T, 128>(ptr, P, hkv, g, nc, m_slot, k_w, w,
                                         stream); break;
  }
  if (e != cudaSuccess) return e;

  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (d == 128)
      return launch_attend<MmaEngine<128>>(attend_mma_kernel<128>, ptr, P,
                                           hkv, g, nc, d, m_slot, k_w, w,
                                           n_route, external, stream);
    if (d == 64)
      return launch_attend<MmaEngine<64>>(attend_mma_kernel<64>, ptr, P, hkv,
                                          g, nc, d, m_slot, k_w, w, n_route,
                                          external, stream);
  }
  return launch_attend<CoreEngine<T>>(attend_core_kernel<T>, ptr, P, hkv, g,
                                      nc, d, m_slot, k_w, w, n_route,
                                      external, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 pools, 1 = bfloat16 pools.  ptr holds 27 pointers:
// q, k, v, q_sum in, pre_q_sum in, k_pool, v_pool, page_table, t0,
// n_valid, n_train, active (bool bytes), out, then the state on exit --
// lm_q, lm_v, expert_idx (int32), expert_valid (bool bytes), q_sum,
// pre_lm_q, pre_q_sum -- the A-system workspace ws_v, ws_tl, and the state
// on entry: lm_q, lm_v, expert_idx, expert_valid, pre_lm_q.  The state on
// exit is written whole; the 16-byte-vector operands (q, k, v, the pools)
// must be 16-byte aligned.
int mita_chunk_prefill(int dtype, void* const* ptr, int P, int hkv, int g,
                       int nc, int d, int m_slot, int k_w, int w, int n_route,
                       int external, void* stream) {
  if (g < 1 || g > kRows || d % 32 != 0 || d < 32 || d > 128 ||
      k_w > kSortN / 2 || n_route < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(ptr, P, hkv, g, nc, d, m_slot, k_w, w, n_route,
                              external, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(ptr, P, hkv, g, nc, d, m_slot, k_w, w,
                                      n_route, external, st);
  return (int)cudaErrorInvalidValue;
}

// Largest dynamic shared memory of the call's kernels, in bytes.
long long mita_chunk_prefill_smem_bytes(int dtype, int d, int m_slot, int w,
                                        int k_w, int n_route) {
  const long long lm = (long long)LmLayout(d, m_slot, w).total * 4;
  const long long at =
      (long long)attend_smem_of(dtype, d, m_slot, k_w, n_route);
  return lm > at ? lm : at;
}

}  // extern "C"
