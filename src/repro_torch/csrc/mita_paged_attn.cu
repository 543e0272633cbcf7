// Fused paged-decode MiTA attention for Hopper (sm_90a), split over keys.
//
// Replaces: the Pallas kernel `mita_paged_attention`
//   (src/repro/kernels/mita_paged_attn.py:217, body `_paged_kernel` at :67).
//
// One decode step of the serving engine's paged cache, for each
// (slot, KV head) and all G query heads of its group: the shared branch
// (routing logits against lm_q, masked to m < m_cnt; values lm_v), the
// local branch (the slot's current page, positions <= t % w) and the
// routed branch (n_route rounds of first-index argmax over the routing
// logits per query head, each round attending that expert's stored
// GLOBAL pool rows, validity-masked), merged by one guarded online
// softmax; the output is 0 where l == 0 or the slot is inactive.
//
// Design: the keys of each (slot, KV head) are spread over n_split blocks
// of `paged_split_kernel`, by a plan that depends on the shapes only
// (`split_plan` in kernels/mita_paged_attn.py, never on S, t or which
// slots are active):
//   split 0                 the shared landmarks, and the fused in-place
//                           append of (k_new, v_new) at
//                           page_table[s, t/w]*w + t%w (scratch row R for
//                           an inactive slot): exactly one block per
//                           (slot, KV head) writes the pools;
//   splits 1 .. n_local     the current page in slices of `rows`
//                           positions; the appended position is read from
//                           k_new / v_new, never from the pool;
//   the remaining splits    routed (round, slice): rows [slice*rows, ...)
//                           of the expert that round `round` picks for
//                           each query head.  Every routed block recomputes
//                           the G x M routing logits in float32 with the
//                           same code and takes the same rounds of
//                           first-index argmax (validity: > NEG_INF / 2),
//                           so all blocks pick the same expert.
// Each block writes a float32 partial (o, m, l) per query head into a
// workspace the wrapper allocates; `paged_merge_kernel` then merges the
// n_split partials of each (slot, KV head) in split order with the guarded
// `_merge` of the Pallas body (:49-64) and normalises.  Two launches per
// call; no atomics, so the result does not depend on scheduling, and a
// slot's output does not depend on its batch neighbours.
//
// What bounds it on the H100: bytes.  Per (slot, head) it reads the
// landmark tiles (2*M*d), the local page (2*w*d) and G*n_route expert
// tiles (2*K*d each): about 0.2 MB in bf16 at qwen3-0.6b's shapes, roughly
// 1 FLOP per byte, far below the card's ~295 FLOP/byte ridge.  At S = 4
// one block per (slot, head) would put 32 blocks on 132 SMs, each bound by
// the latency of its dependent phases; the split puts
// S * Hkv * n_split blocks in flight (288 at the serving shapes), each
// with at most G*rows keys, read as 16-byte vectors (a few lanes per key,
// several keys per warp), and a value pass parallel over keys whose
// partial sums are added in shared memory in a fixed order.  Rows with a
// zero softmax weight (masked local positions, invalid expert rows) are
// never read.
//
// All statistics accumulate in float32; the pools are float32 or bf16.
// Row offsets are 64-bit.  The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

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

// V consecutive elements as floats, one 16-byte load: V = 4 (float32) or
// V = 8 (bf16).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    static_assert(V == 4, "float32 vectors hold 4 elements");
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  } else {
    static_assert(V == 8, "bf16 vectors hold 8 elements");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
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

// Shared-memory layout, in 4-byte words.  `red` holds the value pass's
// per-key-group sums: kThreads / (d / V) groups of G x d.
struct Layout {
  int q, sc, rr, m_b, l_b, rows, eid, ok, red, total;
  __host__ __device__ Layout(int g, int d, int m, int rows_per, int v) {
    const int n = m > rows_per ? m : rows_per;
    const int groups = kThreads / (d / v);
    q = 0;
    sc = q + g * d;
    rr = sc + g * n;
    m_b = rr + g * m;
    l_b = m_b + g;
    rows = l_b + g;
    eid = rows + g * rows_per;
    ok = eid + g;
    red = ok + g;
    total = red + groups * g * d;
  }
};

// Scores of G*n (head, key) items into sc: `sub` lanes per item (a power
// of two, enough that a lane reads at most 8 of the row's V-element
// vectors, all issued before the first product), so a warp scores
// 32 / sub keys at once.  key_row(g, j) returns the row or nullptr for a
// masked item (NEG_INF, never read).
template <typename T, int V, typename KeyFn>
__device__ void score_items(const float* qs, float* sc, int g_n, int n, int d,
                            float scale_div, KeyFn key_row) {
  constexpr int kU = 8;  // vectors in flight per lane
  const int chunks = d / V;
  int sub = 1;
  while (sub < 32 && sub * kU < chunks) sub *= 2;
  const int per_warp = 32 / sub;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / sub, sl = lane % sub;
  const int total = g_n * n;
  for (int base = warp * per_warp; base < total;
       base += kWarps * per_warp) {  // uniform across the warp
    const int item = base + slot;
    const T* kr = nullptr;
    int g = 0;
    if (item < total) {
      g = item / n;
      kr = key_row(g, item - g * n);
    }
    float acc = 0.f;
    if (kr != nullptr) {
      const float* qg = qs + g * d;
      for (int c0 = sl; c0 < chunks; c0 += kU * sub) {
        float x[kU][V];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = c0 + u * sub;
          if (c < chunks) {
            load_vec<T, V>(kr + c * V, x[u]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = c0 + u * sub;
          if (c < chunks) {
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc = fmaf(qg[c * V + e], x[u][e], acc);
          }
        }
      }
    }
    for (int o = sub / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (sl == 0 && item < total)
      sc[item] = (kr != nullptr) ? acc / scale_div : kNegInf;
  }
  __syncthreads();
}

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
  __syncthreads();
}

// o[g, :] = sum_j p[g, j] * V_j into o_out (the block's partial): thread
// (group kg, chunk c) sums keys j = kg, kg + groups, ... of vector chunk c,
// four rows in flight, reading only rows of non-zero weight; the groups'
// sums are then added in group order.  value_row(g, j) returns the row.
template <typename T, int V, typename RowFn>
__device__ void value_pass(float* sm, const Layout& L, int g_n, int n, int d,
                           RowFn value_row, float* o_out) {
  constexpr int kU = 4;
  const int chunks = d / V;
  const int groups = kThreads / chunks;
  const int kg = threadIdx.x / chunks, c = threadIdx.x % chunks;
  const float* p = sm + L.sc;
  float* red = sm + L.red;
  if (kg < groups) {
    for (int g = 0; g < g_n; ++g) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int j0 = kg; j0 < n; j0 += kU * groups) {
        float pj[kU], x[kU][V];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = j0 + u * groups;
          pj[u] = j < n ? p[g * n + j] : 0.f;
          if (pj[u] != 0.f) {
            load_vec<T, V>(value_row(g, j) + c * V, x[u]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(pj[u], x[u][e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e)
        red[(kg * g_n + g) * d + c * V + e] = acc[e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g_n * d; idx += kThreads) {
    float o = 0.f;
    for (int k = 0; k < groups; ++k) o += red[k * g_n * d + idx];
    o_out[idx] = o;
  }
}

// One block per (split, KV head, slot); writes the split's partial
// ws[slot, head, split] = (o [G, d], m [G], l [G]).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const T* __restrict__ lm_q,
    const T* __restrict__ lm_v, const int32_t* __restrict__ expert_idx,
    const uint8_t* __restrict__ expert_valid, T* k_pool, T* v_pool,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ m_cnt,
    float* __restrict__ ws, int hkv, int g_n, int d, int m_slot, int k_w,
    int w, int64_t n_rows, int fuse_append, int rows_per, int n_local) {
  extern __shared__ float sm[];
  const Layout L(g_n, d, m_slot, rows_per, V);
  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int sh = s * hkv + h;
  const int ts = t[s];
  const bool act = active[s] != 0;
  const int mc = m_cnt[s];
  int page_ord = ts / w;
  page_ord = page_ord < 0 ? 0 : (page_ord >= m_slot ? m_slot - 1 : page_ord);
  const int64_t page0 = (int64_t)page_table[s * m_slot + page_ord] * w;
  const int tpos = ts % w;
  const int64_t row_stride = (int64_t)hkv * d;
  const int64_t row_new = act ? page0 + tpos : n_rows - 1;
  const T* kn = k_new + (int64_t)sh * d;
  const T* vn = v_new + (int64_t)sh * d;
  const float scale_div = sqrtf((float)d);
  float* part = ws + ((int64_t)sh * gridDim.x + split) * g_n * (d + 2);

  // the fused in-place append: split 0 only
  if (split == 0 && fuse_append) {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      k_pool[row_new * row_stride + (int64_t)h * d + i] = kn[i];
      v_pool[row_new * row_stride + (int64_t)h * d + i] = vn[i];
    }
  }

  // the split's keys: 0 for an inactive slot or a slice past t % w
  const int spe = (k_w + rows_per - 1) / rows_per;  // slices per expert
  int n = 0, j0 = 0, round = 0;
  if (act) {
    if (split == 0) {
      n = m_slot;
    } else if (split <= n_local) {
      j0 = (split - 1) * rows_per;
      n = j0 <= tpos ? min(rows_per, w - j0) : 0;
    } else {
      const int i = split - 1 - n_local;
      round = i / spe;
      j0 = (i - round * spe) * rows_per;
      n = min(rows_per, k_w - j0);
    }
  }
  if (n <= 0) {  // an empty partial (uniform across the block)
    for (int i = threadIdx.x; i < g_n * d; i += kThreads) part[i] = 0.f;
    if (threadIdx.x < g_n) {
      part[g_n * d + threadIdx.x] = kNegInf;
      part[g_n * d + g_n + threadIdx.x] = 0.f;
    }
    return;
  }

  for (int i = threadIdx.x; i < g_n * d; i += kThreads)
    sm[L.q + i] = ld(q + (int64_t)sh * g_n * d + i);
  __syncthreads();

  const T* lmq = lm_q + (int64_t)sh * m_slot * d;
  const T* lmv = lm_v + (int64_t)sh * m_slot * d;
  auto landmark_key = [&](int, int j) -> const T* {
    return j < mc ? lmq + (int64_t)j * d : nullptr;
  };
  if (split == 0) {
    // shared branch: the masked routing logits are its scores
    score_items<T, V>(sm + L.q, sm + L.sc, g_n, n, d, scale_div,
                      landmark_key);
    branch_partial(sm + L.sc, g_n, n, sm + L.m_b, sm + L.l_b);
    value_pass<T, V>(sm, L, g_n, n, d,
                     [&](int, int j) -> const T* {
                       return lmv + (int64_t)j * d;
                     },
                     part);
  } else if (split <= n_local) {
    // local branch: positions j0 .. j0 + n - 1 of the current page
    const T* kpage = k_pool + page0 * row_stride + (int64_t)h * d;
    const T* vpage = v_pool + page0 * row_stride + (int64_t)h * d;
    score_items<T, V>(sm + L.q, sm + L.sc, g_n, n, d, scale_div,
                      [&](int, int jj) -> const T* {
                        const int j = j0 + jj;
                        if (j > tpos) return nullptr;
                        return j == tpos ? kn : kpage + (int64_t)j * row_stride;
                      });
    branch_partial(sm + L.sc, g_n, n, sm + L.m_b, sm + L.l_b);
    value_pass<T, V>(sm, L, g_n, n, d,
                     [&](int, int jj) -> const T* {
                       const int j = j0 + jj;
                       return j == tpos ? vn
                                        : vpage + (int64_t)j * row_stride;
                     },
                     part);
  } else {
    // routed branch: recompute the routing logits, take `round + 1`
    // rounds of first-index argmax per head
    score_items<T, V>(sm + L.q, sm + L.rr, g_n, m_slot, d, scale_div,
                      landmark_key);
    int* rows = reinterpret_cast<int*>(sm + L.rows);
    int* eid = reinterpret_cast<int*>(sm + L.eid);
    int* okf = reinterpret_cast<int*>(sm + L.ok);
    if (threadIdx.x < g_n) {
      float* rg = sm + L.rr + threadIdx.x * m_slot;
      float best = kNegInf;
      int bi = 0;
      for (int r = 0; r <= round; ++r) {
        best = rg[0];
        bi = 0;
        for (int j = 1; j < m_slot; ++j)
          if (rg[j] > best) {
            best = rg[j];
            bi = j;
          }
        rg[bi] = kNegInf;  // retire the picked expert
      }
      eid[threadIdx.x] = bi;
      okf[threadIdx.x] = best > kNegInf / 2;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < g_n * n; idx += kThreads) {
      const int g = idx / n, jj = idx - g * n;
      const int64_t e = ((int64_t)sh * m_slot + eid[g]) * k_w + j0 + jj;
      const int r = expert_idx[e];
      rows[g * rows_per + jj] =
          (okf[g] && expert_valid[e] && r >= 0 && r < n_rows) ? r : -1;
    }
    __syncthreads();
    // a routed row equal to the row appended in this call reads k_new /
    // v_new, as the plain version (append first, then gather) does
    const bool patch = fuse_append && act;
    score_items<T, V>(sm + L.q, sm + L.sc, g_n, n, d, scale_div,
                      [&](int g, int jj) -> const T* {
                        const int r = rows[g * rows_per + jj];
                        if (r < 0) return nullptr;
                        if (patch && r == row_new) return kn;
                        return k_pool + (int64_t)r * row_stride +
                               (int64_t)h * d;
                      });
    branch_partial(sm + L.sc, g_n, n, sm + L.m_b, sm + L.l_b);
    value_pass<T, V>(sm, L, g_n, n, d,
                     [&](int g, int jj) -> const T* {
                       const int r = rows[g * rows_per + jj];
                       if (patch && r == row_new) return vn;
                       return v_pool + (int64_t)r * row_stride +
                              (int64_t)h * d;
                     },
                     part);
  }
  if (threadIdx.x < g_n) {
    part[g_n * d + threadIdx.x] = sm[L.m_b + threadIdx.x];
    part[g_n * d + g_n + threadIdx.x] = sm[L.l_b + threadIdx.x];
  }
}

// One block per (slot, KV head): the n_split partials merged in split
// order with the guarded `_merge`, normalised; 0 where l == 0 or the slot
// is inactive.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ ws, const uint8_t* __restrict__ active,
    T* __restrict__ out, int hkv, int g_n, int d, int n_split) {
  extern __shared__ float pm[];  // this (slot, head)'s partials
  const int sh = blockIdx.x;
  const bool act = active[sh / hkv] != 0;
  const int stride = g_n * (d + 2);
  const float* base = ws + (int64_t)sh * n_split * stride;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_split * stride; i += kThreads)
    pm[i] = base[i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < g_n * d; idx += kThreads) {
    const int g = idx / d;
    float m_a = kNegInf, l_a = 0.f, o_a = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* pp = pm + sp * stride;
      const float m_b = pp[g_n * d + g], l_b = pp[g_n * d + g_n + g];
      const float mn = fmaxf(m_a, m_b);
      const float safe = (mn == kNegInf) ? 0.f : mn;
      const float sa = (m_a == kNegInf) ? 0.f : expf(m_a - safe);
      const float sb = (m_b == kNegInf) ? 0.f : expf(m_b - safe);
      m_a = mn;
      l_a = l_a * sa + l_b * sb;
      o_a = o_a * sa + pp[idx] * sb;
    }
    const float denom = (l_a == 0.f) ? 1.f : l_a;
    st(out + (int64_t)sh * g_n * d + idx,
       (act && l_a != 0.f) ? o_a / denom : 0.f);
  }
}

template <typename T, int V>
cudaError_t launch(void* q, void* k_new, void* v_new, void* lm_q, void* lm_v,
                   void* expert_idx, void* expert_valid, void* k_pool,
                   void* v_pool, void* page_table, void* t, void* active,
                   void* m_cnt, void* ws, void* out, int n_slots, int hkv,
                   int g_n, int d, int m_slot, int k_w, int w,
                   long long n_rows, int fuse_append, int rows_per,
                   int n_local, int n_split, cudaStream_t stream) {
  const Layout L(g_n, d, m_slot, rows_per, V);
  const size_t smem = (size_t)L.total * 4;
  const size_t merge_smem = (size_t)n_split * g_n * (d + 2) * 4;
  auto split_kern = paged_split_kernel<T, V>;
  auto merge_kern = paged_merge_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (merge_smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        merge_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)merge_smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_split, hkv, n_slots);
  split_kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (const T*)lm_q,
      (const T*)lm_v, (const int32_t*)expert_idx,
      (const uint8_t*)expert_valid, (T*)k_pool, (T*)v_pool,
      (const int32_t*)page_table, (const int32_t*)t,
      (const uint8_t*)active, (const int32_t*)m_cnt, (float*)ws, hkv, g_n,
      d, m_slot, k_w, w, (int64_t)n_rows, fuse_append, rows_per, n_local);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_kern<<<n_slots * hkv, kThreads, merge_smem, stream>>>(
      (const float*)ws, (const uint8_t*)active, (T*)out, hkv, g_n, d,
      n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 pools, 1 = bfloat16 pools.  Every row the kernel
// reads must be 16-byte aligned (d a multiple of 16 bytes / element).
// ws: float32 workspace of n_slots * hkv * n_split * g_n * (d + 2) words.
int mita_paged_attention(int dtype, void* q, void* k_new,
                         void* v_new, void* lm_q, void* lm_v,
                         void* expert_idx, void* expert_valid, void* k_pool,
                         void* v_pool, void* page_table, void* t,
                         void* active, void* m_cnt, void* ws, void* out,
                         int n_slots, int hkv, int g_n, int d, int m_slot,
                         int k_w, int w, long long n_rows, int fuse_append,
                         int rows_per, int n_local, int n_split,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define PAGED_LAUNCH(T, V)                                                   \
  return (int)launch<T, V>(q, k_new, v_new, lm_q, lm_v, expert_idx,          \
                           expert_valid, k_pool, v_pool, page_table, t,      \
                           active, m_cnt, ws, out, n_slots, hkv, g_n, d,     \
                           m_slot, k_w, w, n_rows, fuse_append, rows_per,    \
                           n_local, n_split, st)
  if (dtype == 0) PAGED_LAUNCH(float, 4);
  if (dtype == 1) PAGED_LAUNCH(__nv_bfloat16, 8);
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of either launch needs, in bytes (v:
// elements per vector load, 4 for float32 and 8 for bf16).
long long mita_paged_attention_smem_bytes(int g_n, int d, int m_slot,
                                          int rows_per, int v, int n_split) {
  const long long split = (long long)Layout(g_n, d, m_slot, rows_per, v)
                              .total * 4;
  const long long merge = (long long)n_split * g_n * (d + 2) * 4;
  return split > merge ? split : merge;
}

}  // extern "C"
