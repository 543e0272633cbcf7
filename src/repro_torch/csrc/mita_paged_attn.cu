// Fused paged-decode MiTA attention for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `mita_paged_attention`
//   (src/repro/kernels/mita_paged_attn.py:217, body `_paged_kernel` at :67).
//
// One decode step of the serving engine's paged cache, one block per
// (slot, KV head), all G query heads of the group together:
//   1. optional in-place append of (k_new, v_new) at
//      page_table[s, t/w]*w + t%w (scratch row R for inactive slots);
//   2. shared branch: routing logits against lm_q (masked to m < m_cnt),
//      values lm_v;
//   3. local branch: the slot's current page, positions <= t%w, with the
//      appended position patched from k_new/v_new;
//   4. n_route rounds of first-index argmax over the routing logits per
//      query head; each round gathers that expert's K pool rows by their
//      stored GLOBAL row ids and attends them (validity-masked);
//   5. the guarded online-softmax merge of `_merge`/`_partial`
//      (:49-64); the output is 0 where l == 0 or the slot is inactive.
//
// What bounds it on the H100: bytes.  Per (slot, head) it reads the
// landmark tiles (2*M*d), the local page (2*w*d) and G*n_route expert tiles
// (2*K*d each): about 0.2 MB in bf16 at qwen3-0.6b's shapes, against
// 4*G*(M + w + K)*d multiply-adds -- roughly 1 FLOP per byte, far below
// the card's ~295 FLOP/byte ridge.  The design therefore moves each byte
// once: a warp computes one key's dot product with lanes on neighbouring
// elements (coalesced 2-4 byte loads across the warp), scores live in
// shared memory, the value pass reads only rows whose softmax weight is
// non-zero (masked local positions and masked expert rows are never
// loaded), and nothing but the output and the appended row is written.
// Known limit of this first version: the grid is S*Hkv blocks (32 at the
// main serving shapes), which leaves most of the 132 SMs idle.
//
// All statistics accumulate in float32; the pools are float32 or bf16.
// Row offsets are 64-bit.  No atomics: the result does not depend on
// scheduling.  The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the mask value
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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
struct Layout {
  int q, o, sc, rr, m_acc, l_acc, m_b, l_b, rows, ok, vflag, eid, total;
  __host__ __device__ Layout(int g, int d, int m, int w, int k) {
    int n = m > w ? m : w;
    n = n > k ? n : k;
    q = 0;
    o = q + g * d;
    sc = o + g * d;
    rr = sc + g * n;
    m_acc = rr + g * m;
    l_acc = m_acc + g;
    m_b = l_acc + g;
    l_b = m_b + g;
    rows = l_b + g;
    ok = rows + g * k;
    vflag = ok + g;
    eid = vflag + g * k;
    total = eid + g;
  }
};

// `_partial`: per head, max over the n scores, p = exp(s - safe_max) with
// exact zeros on NEG_INF lanes, l = sum p.  Scores are replaced by p.
__device__ void branch_partial(float* sc, int g_n, int n, float* m_b,
                               float* l_b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < g_n; g += kWarps) {
    float* s = sc + g * n;
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    const float safe = (mx == kNegInf) ? 0.f : mx;
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = (s[j] == kNegInf) ? 0.f : expf(s[j] - safe);
      s[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_b[g] = mx;
      l_b[g] = l;
    }
  }
}

// `_merge` of the branch partial (m_b, l_b, o_b) into the accumulators.
// o_b[g, i] = sum_j p[g, j] * V_j[i] is formed here, reading only rows
// with a non-zero weight; value_row(g, j) returns the row pointer.
template <typename T, typename RowFn>
__device__ void accumulate_merge(float* sm, const Layout& L, int g_n, int n,
                                 int d, RowFn value_row) {
  const float* p = sm + L.sc;
  for (int idx = threadIdx.x; idx < g_n * d; idx += blockDim.x) {
    const int g = idx / d, i = idx % d;
    float ob = 0.f;
    for (int j = 0; j < n; ++j) {
      const float pj = p[g * n + j];
      if (pj != 0.f) ob += pj * ld(value_row(g, j) + i);
    }
    const float ma = sm[L.m_acc + g], mb = sm[L.m_b + g];
    const float mn = fmaxf(ma, mb);
    const float safe = (mn == kNegInf) ? 0.f : mn;
    const float sa = (ma == kNegInf) ? 0.f : expf(ma - safe);
    const float sb = (mb == kNegInf) ? 0.f : expf(mb - safe);
    sm[L.o + idx] = sm[L.o + idx] * sa + ob * sb;
  }
  __syncthreads();
  if (threadIdx.x < g_n) {
    const int g = threadIdx.x;
    const float ma = sm[L.m_acc + g], mb = sm[L.m_b + g];
    const float mn = fmaxf(ma, mb);
    const float safe = (mn == kNegInf) ? 0.f : mn;
    const float sa = (ma == kNegInf) ? 0.f : expf(ma - safe);
    const float sb = (mb == kNegInf) ? 0.f : expf(mb - safe);
    sm[L.m_acc + g] = mn;
    sm[L.l_acc + g] = sm[L.l_acc + g] * sa + sm[L.l_b + g] * sb;
  }
  __syncthreads();
}

// Scores of G*n (head, key) items: one warp per item, lanes across d.
// key_row(g, j) returns the key row or nullptr for a masked item.
template <typename T, typename KeyFn>
__device__ void score_items(float* sm, const Layout& L, int g_n, int n,
                            int d, float scale_div, KeyFn key_row) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int item = warp; item < g_n * n; item += kWarps) {
    const int g = item / n, j = item % n;
    const T* kr = key_row(g, j);
    float acc = 0.f;
    if (kr != nullptr) {
      const float* qg = sm + L.q + g * d;
      for (int i = lane; i < d; i += 32) acc += qg[i] * ld(kr + i);
      acc = warp_sum(acc);
    }
    if (lane == 0)
      sm[L.sc + item] = (kr != nullptr) ? acc / scale_div : kNegInf;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const T* __restrict__ lm_q,
    const T* __restrict__ lm_v, const int32_t* __restrict__ expert_idx,
    const uint8_t* __restrict__ expert_valid, T* k_pool, T* v_pool,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ m_cnt,
    T* __restrict__ out, int hkv, int g_n, int d, int m_slot, int k_w,
    int w, int64_t n_rows, int n_route, int fuse_append) {
  extern __shared__ float sm[];
  const Layout L(g_n, d, m_slot, w, k_w);
  const int s = blockIdx.x, h = blockIdx.y;
  const int sh = s * hkv + h;
  const int ts = t[s];
  const bool act = active[s] != 0;
  const int mc = m_cnt[s];
  int page_ord = ts / w;
  page_ord = page_ord < 0 ? 0 : (page_ord >= m_slot ? m_slot - 1 : page_ord);
  const int64_t page0 = (int64_t)page_table[s * m_slot + page_ord] * w;
  const int tpos = ts % w;
  const int64_t row_stride = (int64_t)hkv * d;
  const T* kn = k_new + (int64_t)sh * d;
  const T* vn = v_new + (int64_t)sh * d;
  const float scale_div = sqrtf((float)d);

  // 1. fused in-place append (scratch row for inactive slots)
  if (fuse_append) {
    const int64_t row_new = act ? page0 + tpos : n_rows - 1;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      k_pool[row_new * row_stride + (int64_t)h * d + i] = kn[i];
      v_pool[row_new * row_stride + (int64_t)h * d + i] = vn[i];
    }
  }
  for (int i = threadIdx.x; i < g_n * d; i += blockDim.x) {
    sm[L.q + i] = ld(q + (int64_t)sh * g_n * d + i);
    sm[L.o + i] = 0.f;
  }
  if (threadIdx.x < g_n) {
    sm[L.m_acc + threadIdx.x] = kNegInf;
    sm[L.l_acc + threadIdx.x] = 0.f;
  }
  __syncthreads();

  // 2. shared-landmark branch; the masked logits double as routing logits
  const T* lmq = lm_q + (int64_t)sh * m_slot * d;
  const T* lmv = lm_v + (int64_t)sh * m_slot * d;
  score_items<T>(sm, L, g_n, m_slot, d, scale_div,
                 [&](int, int j) -> const T* {
                   return j < mc ? lmq + (int64_t)j * d : nullptr;
                 });
  for (int i = threadIdx.x; i < g_n * m_slot; i += blockDim.x)
    sm[L.rr + i] = sm[L.sc + i];
  __syncthreads();
  branch_partial(sm + L.sc, g_n, m_slot, sm + L.m_b, sm + L.l_b);
  __syncthreads();
  accumulate_merge<T>(sm, L, g_n, m_slot, d, [&](int, int j) -> const T* {
    return lmv + (int64_t)j * d;
  });

  // 3. local branch: the current page, positions <= t % w, with the
  // appended position read from k_new/v_new
  const T* kpage = k_pool + page0 * row_stride + (int64_t)h * d;
  const T* vpage = v_pool + page0 * row_stride + (int64_t)h * d;
  score_items<T>(sm, L, g_n, w, d, scale_div, [&](int, int j) -> const T* {
    if (j > tpos) return nullptr;
    return j == tpos ? kn : kpage + (int64_t)j * row_stride;
  });
  branch_partial(sm + L.sc, g_n, w, sm + L.m_b, sm + L.l_b);
  __syncthreads();
  accumulate_merge<T>(sm, L, g_n, w, d, [&](int, int j) -> const T* {
    return j == tpos ? vn : vpage + (int64_t)j * row_stride;
  });

  // 4. routed experts: n_route rounds of first-index argmax per head
  int* rows = reinterpret_cast<int*>(sm + L.rows);
  int* okf = reinterpret_cast<int*>(sm + L.ok);
  int* vflag = reinterpret_cast<int*>(sm + L.vflag);
  int* eid = reinterpret_cast<int*>(sm + L.eid);
  for (int round = 0; round < n_route; ++round) {
    if (threadIdx.x < g_n) {
      float* rg = sm + L.rr + threadIdx.x * m_slot;
      float best = rg[0];
      int bi = 0;
      for (int j = 1; j < m_slot; ++j)
        if (rg[j] > best) {
          best = rg[j];
          bi = j;
        }
      okf[threadIdx.x] = best > kNegInf / 2;
      eid[threadIdx.x] = bi;
      rg[bi] = kNegInf;  // retire the picked expert
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < g_n * k_w; idx += blockDim.x) {
      const int g = idx / k_w, j = idx % k_w;
      const int64_t e = ((int64_t)sh * m_slot + eid[g]) * k_w + j;
      rows[idx] = expert_idx[e];
      vflag[idx] = expert_valid[e];
    }
    __syncthreads();
    score_items<T>(sm, L, g_n, k_w, d, scale_div,
                   [&](int g, int j) -> const T* {
                     const int r = rows[g * k_w + j];
                     if (!okf[g] || !vflag[g * k_w + j] || r < 0 ||
                         r >= n_rows)
                       return nullptr;
                     return k_pool + (int64_t)r * row_stride +
                            (int64_t)h * d;
                   });
    branch_partial(sm + L.sc, g_n, k_w, sm + L.m_b, sm + L.l_b);
    __syncthreads();
    accumulate_merge<T>(sm, L, g_n, k_w, d, [&](int g, int j) -> const T* {
      return v_pool + (int64_t)rows[g * k_w + j] * row_stride +
             (int64_t)h * d;
    });
  }

  // 5. normalise; empty rows and inactive slots give 0
  for (int idx = threadIdx.x; idx < g_n * d; idx += blockDim.x) {
    const float l = sm[L.l_acc + idx / d];
    const float denom = (l == 0.f) ? 1.f : l;
    const float o = sm[L.o + idx] / denom;
    st(out + (int64_t)sh * g_n * d + idx, (l != 0.f && act) ? o : 0.f);
  }
}

template <typename T>
cudaError_t launch(void* q, void* k_new, void* v_new, void* lm_q, void* lm_v,
                   void* expert_idx, void* expert_valid, void* k_pool,
                   void* v_pool, void* page_table, void* t, void* active,
                   void* m_cnt, void* out, int n_slots, int hkv, int g_n,
                   int d, int m_slot, int k_w, int w, long long n_rows,
                   int n_route, int fuse_append, cudaStream_t stream) {
  const Layout L(g_n, d, m_slot, w, k_w);
  const size_t smem = (size_t)L.total * 4;
  auto kern = paged_attn_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_slots, hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (const T*)lm_q,
      (const T*)lm_v, (const int32_t*)expert_idx,
      (const uint8_t*)expert_valid, (T*)k_pool, (T*)v_pool,
      (const int32_t*)page_table, (const int32_t*)t,
      (const uint8_t*)active, (const int32_t*)m_cnt, (T*)out, hkv, g_n, d,
      m_slot, k_w, w, (int64_t)n_rows, n_route, fuse_append);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 pools, 1 = bfloat16 pools.
int mita_paged_attention(int dtype, void* q, void* k_new, void* v_new,
                         void* lm_q, void* lm_v, void* expert_idx,
                         void* expert_valid, void* k_pool, void* v_pool,
                         void* page_table, void* t, void* active,
                         void* m_cnt, void* out, int n_slots, int hkv,
                         int g_n, int d, int m_slot, int k_w, int w,
                         long long n_rows, int n_route, int fuse_append,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k_new, v_new, lm_q, lm_v, expert_idx,
                              expert_valid, k_pool, v_pool, page_table, t,
                              active, m_cnt, out, n_slots, hkv, g_n, d,
                              m_slot, k_w, w, n_rows, n_route, fuse_append,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        q, k_new, v_new, lm_q, lm_v, expert_idx, expert_valid, k_pool,
        v_pool, page_table, t, active, m_cnt, out, n_slots, hkv, g_n, d,
        m_slot, k_w, w, n_rows, n_route, fuse_append, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs, in bytes.
long long mita_paged_attention_smem_bytes(int g_n, int d, int m_slot,
                                          int k_w, int w) {
  return (long long)Layout(g_n, d, m_slot, w, k_w).total * 4;
}

}  // extern "C"
