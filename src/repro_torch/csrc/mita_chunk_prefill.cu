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
//   2. landmark_kernel, grid (M, Hkv, P): one block per landmark ordinal.
//      It resumes the open-window query sums of both landmark systems --
//      B (the decode cache: w-sized windows, lm_q / q_sum) and A (the
//      training head's n//m-sized prompt windows, pre_lm_q / pre_q_sum) --
//      commits the landmark queries the chunk completes, and for each
//      landmark whose key context is now complete scores it against the
//      slot's context, takes the top-K with first-index ties and the
//      softmax-weighted value.  B commits go to the state (expert rows as
//      GLOBAL pool rows); the A products feed only this chunk's attention
//      and go to a workspace (context positions, float32 values).
//   3. attend_kernel, grid (ceil(nc/8), Hkv, P): one warp per chunk
//      position, all G query heads of the KV group together.  Shared,
//      routed and local branches in one online softmax per head; prompt
//      positions (< n_train) read the A system, generated positions (the
//      preemption-recompute shape) the B system with decode-time landmark
//      availability.  B expert rows are read straight from the pools, so
//      rows of pages attached from the prefix cache need no mapping.
//
// Top-K: rank selection.  Lane c's rank is the number of lanes before it
// in the order (score descending, index ascending); the lanes of rank < K
// are the top-K in lax.top_k's order.  Masked lanes (NEG_INF) past the
// visible context come after every visible lane in index order, so their
// ranks are known without comparing.  No serial argmax rounds.
//
// What bounds it on the H100: at the serving shapes the attention step
// does about 4*d flops per (position, head, key) over ~400 keys per
// position against K/V rows that are re-read by every position of the
// window: it is bound by on-chip operations, not by the bytes it must move
// (each context row once).  This first version keeps every product on the
// CUDA cores in float32 (no tensor cores) and reads K/V rows through the
// L1/L2 caches; the context never has to fit in shared memory (the Pallas
// kernel stages it whole in VMEM, 384 KiB per (row, head) in bf16 at the
// production shape, beyond a block's 227 KB).
//
// Float32 statistics, 64-bit row offsets, no atomics: the result does not
// depend on scheduling.  The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -FLT_MAX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 4;
constexpr int kMaxEpl = 4;     // d / 32 <= 4, so d <= 128

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
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

__device__ float block_max(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < kWarps; ++i) r += red[i];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int64_t pool_row(const int32_t* pt, int c, int w) {
  return (int64_t)pt[c / w] * w + c % w;
}

// Landmark-kernel shared memory, in 4-byte words.
struct LmLayout {
  int q, red, top, sc, total;
  __host__ __device__ LmLayout(int d, int k_w, int ctx) {
    q = 0;
    red = q + d;
    top = red + kWarps;
    sc = top + k_w;
    total = sc + ctx;
  }
};

// ---------------------------------------------------------------- append --

template <typename T>
__global__ void append_kernel(const T* __restrict__ k,
                              const T* __restrict__ v, T* k_pool, T* v_pool,
                              const int32_t* __restrict__ pt,
                              const int32_t* __restrict__ t0,
                              const int32_t* __restrict__ nv,
                              const uint8_t* __restrict__ active, int hkv,
                              int nc, int d, int m_slot, int w) {
  const int n = blockIdx.x, h = blockIdx.y, p = blockIdx.z;
  if (!active[p] || n >= nv[p]) return;
  const int pos = t0[p] + n;
  const int page = min(pos / w, m_slot - 1);
  const int64_t row = (int64_t)pt[(int64_t)p * m_slot + page] * w + pos % w;
  const int64_t src = (((int64_t)p * hkv + h) * nc + n) * d;
  const int64_t dst = (row * hkv + h) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    k_pool[dst + i] = k[src + i];
    v_pool[dst + i] = v[src + i];
  }
}

// -------------------------------------------------------------- landmark --

// Score the landmark query sm[L.q] against context positions [0, vis),
// take the top-K (rank selection) and the softmax-weighted value.  With
// b_system the picks are committed as global rows + validity and the value
// in the landmark dtype; otherwise picks go to ws_tl as context positions
// (-1 = masked lane) and the value to ws_v in float32.
template <typename T>
__device__ void build_landmark(float* sm, const LmLayout& L, int vis,
                               const T* __restrict__ k_pool,
                               const T* __restrict__ v_pool,
                               const int32_t* pt, int h, int hkv, int d,
                               int k_w, int w, bool b_system,
                               int32_t* ei, int32_t* ev, T* lmv,
                               int32_t* ws_tl, float* ws_v) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sc = sm + L.sc;
  int* top = reinterpret_cast<int*>(sm + L.top);
  const float* qv = sm + L.q;
  const float scale = sqrtf((float)d);
  const int64_t rs = (int64_t)hkv * d;

  for (int c = warp; c < vis; c += kWarps) {
    const T* kr = k_pool + pool_row(pt, c, w) * rs + (int64_t)h * d;
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += qv[i] * ld(kr + i);
    acc = warp_sum(acc);
    if (lane == 0) sc[c] = acc / scale;
  }
  __syncthreads();

  for (int c = threadIdx.x; c < vis; c += kThreads) {
    const float s = sc[c];
    int r = 0;
    for (int j = 0; j < vis; ++j) {
      const float sj = sc[j];
      r += (sj > s) || (sj == s && j < c);
    }
    if (r < k_w) top[r] = c;
  }
  __syncthreads();

  const int kvis = min(k_w, vis);
  for (int r = threadIdx.x; r < k_w; r += kThreads) {
    const bool valid = r < kvis;
    const int c = valid ? top[r] : vis + (r - kvis);  // masked lanes in order
    if (b_system) {
      ei[r] = (int32_t)pool_row(pt, c, w);
      ev[r] = valid ? 1 : 0;
    } else {
      ws_tl[r] = valid ? c : -1;
    }
  }

  // softmax over the visible lanes (masked lanes weigh exactly 0)
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < vis; c += kThreads) mx = fmaxf(mx, sc[c]);
  mx = block_max(mx, sm + L.red);
  float sum = 0.f;
  for (int c = threadIdx.x; c < vis; c += kThreads) sum += expf(sc[c] - mx);
  sum = block_sum(sum, sm + L.red);
  for (int c = threadIdx.x; c < vis; c += kThreads)
    sc[c] = expf(sc[c] - mx) / sum;
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float acc = 0.f;
    for (int c = 0; c < vis; ++c)
      acc += sc[c] * ld(v_pool + pool_row(pt, c, w) * rs + (int64_t)h * d + i);
    if (b_system)
      st(lmv + i, acc);
    else
      ws_v[i] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) landmark_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const float* __restrict__ qs_in,
    const float* __restrict__ pqs_in, T* lmq, T* lmv, int32_t* ei,
    int32_t* ev, float* qs, T* plmq, float* pqs, float* ws_v, int32_t* ws_tl,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ t0,
    const int32_t* __restrict__ nv, const int32_t* __restrict__ ntr,
    const uint8_t* __restrict__ active, int hkv, int g, int nc, int d,
    int m_slot, int k_w, int w) {
  const int li = blockIdx.x, h = blockIdx.y, p = blockIdx.z;
  if (!active[p]) return;          // inactive rows pass through
  extern __shared__ float sm[];
  const int ctx = m_slot * w;
  const LmLayout L(d, k_w, ctx);
  const int tp = t0[p], new_end = tp + nv[p], ntp = ntr[p];
  const int m_train = ntp / w;
  const int m_a = max(m_train, 1);
  const int w_a = max(ntp / m_a, 1);
  const int64_t ph = (int64_t)p * hkv + h;
  const int64_t lm_off = (ph * m_slot + li) * d;
  const int64_t e_off = (ph * m_slot + li) * k_w;
  const int32_t* pt = page_table + (int64_t)p * m_slot;

  // 1. window query sums of both systems (one thread per feature)
  const int wend = (li + 1) * w;
  const int ends_a = (li + 1) * w_a;
  const int tr_end = min(new_end, ntp);
  float qa = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const T* qi = q + ph * g * nc * d + i;
    auto pooled = [&](int pos) {           // group mean of the query
      float s = 0.f;
      for (int gg = 0; gg < g; ++gg)
        s += ld(qi + ((int64_t)gg * nc + (pos - tp)) * d);
      return s / (float)g;
    };
    float sb = 0.f;
    for (int pos = max(li * w, tp); pos < min(wend, new_end); ++pos)
      sb += pooled(pos);
    if (li == tp / w && tp % w != 0) sb += qs_in[ph * d + i];
    float sa = 0.f;
    for (int pos = max(li * w_a, tp); pos < min(ends_a, tr_end); ++pos)
      sa += pooled(pos);
    if (li == tp / w_a && tp % w_a != 0 && tp < ntp) sa += pqs_in[ph * d + i];

    // B: landmark query, open-window sum
    float qb = ld(lmq + lm_off + i);
    if (wend > tp && wend <= new_end) {
      qb = round_to(sb / (float)w, lmq);
      st(lmq + lm_off + i, qb);
    }
    sm[L.q + i] = qb;
    const int m_new = new_end / w;
    if (li == m_new)
      qs[ph * d + i] = sb;
    else if (li == 0 && m_new >= m_slot)
      qs[ph * d + i] = 0.f;

    // A: prompt landmark query, open-window sum
    qa = ld(plmq + lm_off + i);
    if (ends_a > tp && ends_a <= new_end && li < m_a) {
      qa = round_to(sa / (float)w_a, plmq);
      st(plmq + lm_off + i, qa);
    }
    const int open_a = new_end / w_a;
    if (li == open_a)
      pqs[ph * d + i] = sa;
    else if (li == 0 && open_a >= m_slot)
      pqs[ph * d + i] = 0.f;
  }
  __syncthreads();

  // 2. B system: commit once the landmark's key context is complete
  const int ends_b = li < m_train ? (li + 1) * w_a : wend;
  if (ends_b > tp && ends_b <= new_end)
    build_landmark<T>(sm, L, ends_b, k_pool, v_pool, pt, h, hkv, d, k_w, w,
                      true, ei + e_off, ev + e_off, lmv + lm_off, nullptr,
                      nullptr);

  // 3. A system products for the landmarks this chunk's prompt positions
  // can see (recomputed every chunk; pages are append-only)
  if (li < m_a && ends_a <= tr_end) {
    for (int i = threadIdx.x; i < d; i += kThreads) sm[L.q + i] = qa;
    __syncthreads();
    build_landmark<T>(sm, L, ends_a, k_pool, v_pool, pt, h, hkv, d, k_w, w,
                      false, nullptr, nullptr, nullptr, ws_tl + e_off,
                      ws_v + lm_off);
  }
}

// ---------------------------------------------------------------- attend --

template <typename T>
__global__ void __launch_bounds__(kThreads) attend_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const T* __restrict__ lmq,
    const T* __restrict__ lmv, const int32_t* __restrict__ ei,
    const int32_t* __restrict__ ev, const T* __restrict__ plmq,
    const float* __restrict__ ws_v, const int32_t* __restrict__ ws_tl,
    T* out, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ t0, const int32_t* __restrict__ nv,
    const int32_t* __restrict__ ntr, const uint8_t* __restrict__ active,
    int hkv, int g, int nc, int d, int m_slot, int k_w, int w, int n_route,
    int external) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + warp, h = blockIdx.y, p = blockIdx.z;
  if (n >= nc) return;             // no block barrier below
  extern __shared__ float sm[];
  float* rr = sm + warp * g * m_slot;  // routing logits [g][m_slot]
  const int epl = d / 32;
  const int64_t ph = (int64_t)p * hkv + h;
  const int64_t rs = (int64_t)hkv * d;
  const int32_t* pt = page_table + (int64_t)p * m_slot;

  if (!active[p] || n >= nv[p]) {  // padding / inactive rows: zeros
    for (int gg = 0; gg < g; ++gg)
      for (int e = 0; e < epl; ++e)
        st(out + ((ph * g + gg) * nc + n) * d + lane + 32 * e, 0.f);
    return;
  }
  const int pos = t0[p] + n, ntp = ntr[p];
  const bool is_tr = pos < ntp;
  const int m_a = max(ntp / w, 1);
  const int w_a = max(ntp / m_a, 1);
  const float scale = sqrtf((float)d);

  float qv[kMaxG][kMaxEpl], o[kMaxG][kMaxEpl], mrun[kMaxG], lrun[kMaxG];
  for (int gg = 0; gg < kMaxG; ++gg) {
    mrun[gg] = -INFINITY;
    lrun[gg] = 0.f;
    for (int e = 0; e < kMaxEpl; ++e) {
      o[gg][e] = 0.f;
      qv[gg][e] = (gg < g && e < epl)
          ? ld(q + ((ph * g + gg) * nc + n) * d + lane + 32 * e) : 0.f;
    }
  }
  // one online-softmax step of head gg with score s and value row vv
  auto update = [&](int gg, float s, const float* vv) {
    if (s > mrun[gg]) {
      const float c = expf(mrun[gg] - s);
      lrun[gg] = lrun[gg] * c + 1.f;
      for (int e = 0; e < kMaxEpl; ++e) o[gg][e] = o[gg][e] * c + vv[e];
      mrun[gg] = s;
    } else {
      const float pe = expf(s - mrun[gg]);
      lrun[gg] += pe;
      for (int e = 0; e < kMaxEpl; ++e) o[gg][e] += pe * vv[e];
    }
  };
  auto dot = [&](int gg, const float* kv) {
    float a = 0.f;
    for (int e = 0; e < kMaxEpl; ++e) a += qv[gg][e] * kv[e];
    return warp_sum(a) / scale;
  };
  float kv[kMaxEpl], vv[kMaxEpl];
  auto load_row = [&](int64_t row) {
    const T* kr = k_pool + row * rs + (int64_t)h * d + lane;
    const T* vr = v_pool + row * rs + (int64_t)h * d + lane;
    for (int e = 0; e < kMaxEpl; ++e) {
      kv[e] = e < epl ? ld(kr + 32 * e) : 0.f;
      vv[e] = e < epl ? ld(vr + 32 * e) : 0.f;
    }
  };

  // shared branch (and the routing logits)
  for (int li = 0; li < m_slot; ++li) {
    const bool av = is_tr
        ? ((li + 1) * w_a <= pos + 1 && li < m_a)
        : ((li + 1) * w <= pos + (external ? 0 : 1));
    if (!av) {
      if (lane == 0)
        for (int gg = 0; gg < g; ++gg) rr[gg * m_slot + li] = kNegInf;
      continue;
    }
    const int64_t off = (ph * m_slot + li) * d + lane;
    for (int e = 0; e < kMaxEpl; ++e) {
      kv[e] = e < epl ? ld((is_tr ? plmq : lmq) + off + 32 * e) : 0.f;
      vv[e] = e >= epl ? 0.f
          : is_tr ? ws_v[off + 32 * e] : ld(lmv + off + 32 * e);
    }
    for (int gg = 0; gg < g; ++gg) {
      const float s = dot(gg, kv);
      if (lane == 0) rr[gg * m_slot + li] = s;
      update(gg, s, vv);
    }
  }
  __syncwarp();

  // routed branch: n_route first-index argmax picks per head
  for (int gg = 0; gg < g; ++gg) {
    float* r = rr + gg * m_slot;
    for (int j = 0; j < n_route; ++j) {
      float best = -INFINITY;
      int bi = 0;
      for (int li = 0; li < m_slot; ++li)
        if (r[li] > best) {
          best = r[li];
          bi = li;
        }
      if (!(best > kNegInf / 2)) break;   // only masked lanes remain
      __syncwarp();
      if (lane == 0) r[bi] = -INFINITY;   // retired
      __syncwarp();
      const int64_t e_off = (ph * m_slot + bi) * k_w;
      for (int kk = 0; kk < k_w; ++kk) {
        int64_t row;
        if (is_tr) {
          const int c = ws_tl[e_off + kk];
          if (c < 0) continue;
          row = pool_row(pt, c, w);
        } else {
          if (!ev[e_off + kk]) continue;
          row = ei[e_off + kk];
        }
        load_row(row);
        update(gg, dot(gg, kv), vv);
      }
    }
  }

  // local branch: the position's own window [start, pos]
  const int start = is_tr ? (pos / w_a) * w_a : (pos / w) * w;
  for (int c = start; c <= pos; ++c) {
    load_row(pool_row(pt, c, w));
    for (int gg = 0; gg < g; ++gg) update(gg, dot(gg, kv), vv);
  }

  for (int gg = 0; gg < g; ++gg)
    for (int e = 0; e < epl; ++e)
      st(out + ((ph * g + gg) * nc + n) * d + lane + 32 * e,
         lrun[gg] > 0.f ? o[gg][e] / lrun[gg] : 0.f);
}

size_t attend_smem(int g, int m_slot) {
  return (size_t)kWarps * g * m_slot * 4;
}

template <typename T>
cudaError_t launch(void* const* ptr, int P, int hkv, int g, int nc, int d,
                   int m_slot, int k_w, int w, int n_route, int external,
                   cudaStream_t stream) {
  const T* q = (const T*)ptr[0];
  const T* k = (const T*)ptr[1];
  const T* v = (const T*)ptr[2];
  const float* qs_in = (const float*)ptr[3];
  const float* pqs_in = (const float*)ptr[4];
  T* k_pool = (T*)ptr[5];
  T* v_pool = (T*)ptr[6];
  const int32_t* pt = (const int32_t*)ptr[7];
  const int32_t* t0 = (const int32_t*)ptr[8];
  const int32_t* nv = (const int32_t*)ptr[9];
  const int32_t* ntr = (const int32_t*)ptr[10];
  const uint8_t* act = (const uint8_t*)ptr[11];
  T* out = (T*)ptr[12];
  T* lmq = (T*)ptr[13];
  T* lmv = (T*)ptr[14];
  int32_t* ei = (int32_t*)ptr[15];
  int32_t* ev = (int32_t*)ptr[16];
  float* qs = (float*)ptr[17];
  T* plmq = (T*)ptr[18];
  float* pqs = (float*)ptr[19];
  float* ws_v = (float*)ptr[20];
  int32_t* ws_tl = (int32_t*)ptr[21];

  append_kernel<T><<<dim3(nc, hkv, P), 128, 0, stream>>>(
      k, v, k_pool, v_pool, pt, t0, nv, act, hkv, nc, d, m_slot, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t lm_smem = (size_t)LmLayout(d, k_w, m_slot * w).total * 4;
  if (lm_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(landmark_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)lm_smem);
    if (e != cudaSuccess) return e;
  }
  landmark_kernel<T><<<dim3(m_slot, hkv, P), kThreads, lm_smem, stream>>>(
      q, k_pool, v_pool, qs_in, pqs_in, lmq, lmv, ei, ev, qs, plmq, pqs,
      ws_v, ws_tl, pt, t0, nv, ntr, act, hkv, g, nc, d, m_slot, k_w, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  attend_kernel<T><<<dim3((nc + kWarps - 1) / kWarps, hkv, P), kThreads,
                     attend_smem(g, m_slot), stream>>>(
      q, k_pool, v_pool, lmq, lmv, ei, ev, plmq, ws_v, ws_tl, out, pt, t0,
      nv, ntr, act, hkv, g, nc, d, m_slot, k_w, w, n_route, external);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 pools, 1 = bfloat16 pools.  Pointer order: q, k, v,
// q_sum in, pre_q_sum in, k_pool, v_pool, page_table, t0, n_valid,
// n_train, active, out, lm_q, lm_v, expert_idx, expert_valid (int32),
// q_sum, pre_lm_q, pre_q_sum, ws_v, ws_tl.  The state outputs must hold
// copies of the inputs on entry (the kernel writes only what it commits).
int mita_chunk_prefill(int dtype, void* p0, void* p1, void* p2, void* p3,
                       void* p4, void* p5, void* p6, void* p7, void* p8,
                       void* p9, void* p10, void* p11, void* p12, void* p13,
                       void* p14, void* p15, void* p16, void* p17, void* p18,
                       void* p19, void* p20, void* p21, int P, int hkv, int g,
                       int nc, int d, int m_slot, int k_w, int w, int n_route,
                       int external, void* stream) {
  void* const ptr[22] = {p0,  p1,  p2,  p3,  p4,  p5,  p6,  p7,
                         p8,  p9,  p10, p11, p12, p13, p14, p15,
                         p16, p17, p18, p19, p20, p21};
  if (g > kMaxG || d % 32 != 0 || d / 32 > kMaxEpl || d > kThreads)
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
long long mita_chunk_prefill_smem_bytes(int g, int d, int m_slot, int k_w,
                                        int w) {
  const long long lm = (long long)LmLayout(d, k_w, m_slot * w).total * 4;
  const long long at = (long long)attend_smem(g, m_slot);
  return lm > at ? lm : at;
}

}  // extern "C"
