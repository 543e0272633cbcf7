// Paged landmark finalize for Hopper (sm_90a), as a split-context kernel.
//
// Replaces: the Pallas kernel `mita_paged_finalize_fused`
//   (src/repro/kernels/mita_paged_finalize.py:119, body `_finalize_kernel`
//   at :48).
//
// For every due slot s, per KV head h, with t_new its position after the
// step and nvis = clamp(t_new, 0, ctx) its visible context:
//   1. q_lm = q_sum / w, rounded to the landmark dtype;
//   2. scores q_lm . K_c / sqrt(d) (dot first, then the division, so equal
//      products stay tied) for every context position c < nvis, read
//      through the page table (row page_table[s, c/w]*w + c%w);
//   3. top-K with first-index ties; picks past the visible context are the
//      masked lanes in index order, as `lax.top_k` orders NEG_INF lanes;
//      valid = score > NEG_INF/2;
//   4. v_lm = softmax(scores) . V over the visible positions;
//   5. commit q_lm, v_lm, the picks as global pool rows and their validity
//      at window ordinal t_new/w - 1 when 0 <= ordinal < M, and zero q_sum
//      of every due slot.  A slot that is not due is never written, so its
//      rows stay bit-identical (the update is in place).  nvis == 0 only
//      when t_new <= 0, whose ordinal is < 0: such a slot commits nothing,
//      so the reference's uniform weights over masked lanes never reach the
//      state.
//
// Two launches, in stream order:
//   * finalize_split_kernel, grid (S, Hkv, M): one block per page of the
//     context (a split).  It scores the split's visible positions (one
//     page-table read per block; 16-byte loads, two threads per position
//     with half a key row each), writes the scores to the slot's float32
//     workspace row, and writes the split's softmax partials: m_j = max
//     score, l_j = sum exp(x - m_j), o_j = sum exp(x - m_j) V (thread = 8
//     features x a slice of positions, slices added in fixed order).
//     Blocks of non-due slots and splits past the visible context exit at
//     once.  The plan depends on w, M and d only, never on S, t_new or
//     which slots are due, so a slot's bits do not depend on its batch.
//   * finalize_merge_kernel, grid (S, Hkv): the exact top-K of the
//     workspace row (topk_sort.cuh), the picks mapped to pool rows, the
//     partials merged in ascending split order,
//     v = sum_j e^(m_j - m) o_j / sum_j e^(m_j - m) l_j, and the commit.
//     It is a programmatic dependent launch: its blocks are resident while
//     the split runs and wait (griddepcontrol.wait) for it to end.
//
// What bounds it on the H100: bytes.  A due (slot, head) reads its K and
// V rows once each (2 * nvis * d elements) against ~4 * nvis * d flops:
// ~1 FLOP per byte in bf16.  At the serving shape (S = 4, Hkv = 8,
// d = 128, w = K = 128, M = 6) the call must move ~6.9 MB in bf16:
// ~2 us at 3.35 TB/s.  What costs time is latency.  The first version ran
// one block per (slot, head) -- 32 blocks on 132 SMs -- with K rounds of a
// block argmax (three barriers each) and a value pass in which each of d
// threads walked the whole context with one scalar load per position:
// 0.60 ms.  Here (per-block timestamps on the card, bf16 serving shape):
//   * the context spreads over S * Hkv * M blocks, each with its scalars,
//     its first key rows and its value rows in flight together before its
//     first dependent use: the split ends after ~8 us, ~5.5 us of it the
//     load wave (splits of half a page, twice the blocks, were no faster);
//   * the top-K (K <= 128, at most 4096 visible positions) is an exact
//     radix select over the packed keys, 16 a thread in registers: 8 bits
//     a pass with a 256-bin shared histogram, stopping at the first digit
//     whose bucket completes K (2-3 passes on random scores, 8 on exact
//     ties), then each selected key placed by counting the selected keys
//     above it: ~4.9 us, against ~7 us for a bitonic sort of 1024 keys in
//     registers and 13.6 us for one in shared memory;
//   * the merge's launch overlaps the split (~0.8 us from the split's end
//     to the merge's first instruction after the wait, against 2-8 us for
//     a plain launch), and it fetches the splits' partials before its
//     top-K.
// Card times: PERF.md section 6 (scripts/ab_kernel.py --kernel finalize).
//
// Shapes: any d (d = 64 and 128 with 16-byte-aligned pools take the
// vectorised instance; every other d the scalar one), any K <= ctx (K >
// 128 or a longer context: `topk_sort::topk_desc` through a
// max(1024, 2K)-key buffer, in shared memory up to 48 KB, else in global
// memory), any w (a split's scores stay in shared memory up to
// kScoreSmem positions, else the block reads them back from its workspace
// row).
//
// Float32 statistics, 64-bit row offsets, no float atomics (the radix
// select's integer counts do not depend on their order): the result does
// not depend on scheduling.  Each stage's entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "topk_sort.cuh"

namespace {

constexpr float kNegInf = -FLT_MAX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScoreSmem = 2048;  // split scores kept in shared memory
constexpr int kPrefetch = 8;      // value rows a split thread fetches early
constexpr int kRadixK = 128;      // the merge's radix select: K <= 128
constexpr int kRadixN = 4096;     // and a visible context of <= 4096
constexpr int kParts = 8;         // split partials the merge fetches early
static_assert(2 * kRadixK <= kThreads, "topk_radix: kk <= n_threads / 2");

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

// 8 consecutive values (16-byte aligned): fetched raw, then as float.
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};
__device__ __forceinline__ void fetch8(const float* p, Raw8<float>& r) {
  r.a = reinterpret_cast<const float4*>(p)[0];
  r.b = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void fetch8(const __nv_bfloat16* p,
                                       Raw8<__nv_bfloat16>& r) {
  r.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float* x) {
  x[0] = r.a.x, x[1] = r.a.y, x[2] = r.a.z, x[3] = r.a.w;
  x[4] = r.b.x, x[5] = r.b.y, x[6] = r.b.z, x[7] = r.b.w;
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r,
                                        float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* x) {
  Raw8<T> r;
  fetch8(p, r);
  unpack8(r, x);
}

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();
  return r;
}

// The landmark query q_sum / w, rounded to the landmark dtype T, into q
// [d] in shared memory (q0: this thread's element, loaded earlier); ends
// with a barrier.
template <typename T>
__device__ __forceinline__ void store_query(float* q, float q0,
                                            const float* qs, int d, int w) {
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    q[i] = round_to((i == (int)threadIdx.x ? q0 : qs[i]) / (float)w,
                    static_cast<T*>(nullptr));
  __syncthreads();
}

// Operands of both stages.  The workspace (float32, laid out by the
// wrapper): ws_sc [S*Hkv, ctx] scores; ws_m, ws_l [S*Hkv, M] and ws_o
// [S*Hkv, M, d] the splits' partials.  sort_ws: the merge's sort buffers
// [S*Hkv, sort_n] in global memory, or null (shared memory).
struct FinArgs {
  float* q_sum;
  void *lm_q, *lm_v;
  int32_t* expert_idx;
  uint8_t* expert_valid;
  const void *k_pool, *v_pool;
  const int32_t *page_table, *t_new;
  const uint8_t* due;
  float *ws_sc, *ws_m, *ws_l, *ws_o;
  uint64_t* sort_ws;
  int hkv, m_slot, d, k_w, w, sort_n;
};

// Split-kernel shared memory in 4-byte words: the landmark query, the
// reduction slots, the value slices and (w <= kScoreSmem) the scores.
struct SplitLayout {
  int n_groups, n_slices, q, red, vsum, sc, total;
  __host__ __device__ SplitLayout(int vec, int d, int w) {
    n_groups = d / vec;  // feature groups of vec features
    n_slices = n_groups < kThreads ? kThreads / n_groups : 1;
    q = 0;
    red = q + d;
    vsum = red + kWarps;
    sc = vsum + n_slices * d;
    total = sc + (w <= kScoreSmem ? w : 0);
  }
};

// Block (s, h, j): split j (page j) of slot s, KV head h.  D > 0: the
// vectorised instance for head dim D; D == 0: any head dim, scalar loads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    finalize_split_kernel(const FinArgs a) {
  // the merge's blocks may start (and wait for this grid) at once
  asm volatile("griddepcontrol.launch_dependents;");
  const int s = blockIdx.x, h = blockIdx.y, j = blockIdx.z;
  const int w = a.w, m_slot = a.m_slot, ctx = m_slot * w;
  const int d = D > 0 ? D : a.d;
  const int64_t sh = (int64_t)s * a.hkv + h;
  // the block's first loads, all in flight together
  const bool due = a.due[s] != 0;
  const int tn = a.t_new[s];
  const int64_t row0 = (int64_t)a.page_table[s * m_slot + j] * w;
  const float q0 = threadIdx.x < d ? a.q_sum[sh * d + threadIdx.x] : 0.f;
  const int ord = tn / w - 1;
  const int nvis = min(max(tn, 0), ctx);
  const int c0 = j * w;
  // only a committed landmark needs scores and partials
  if (!due || ord < 0 || ord >= m_slot || c0 >= nvis) return;
  constexpr int VEC = D > 0 ? 8 : 1;
  const int n = min(w, nvis - c0);
  const SplitLayout L(VEC, d, w);
  extern __shared__ float sm[];
  float* q = sm + L.q;
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);
  const int64_t rs = (int64_t)a.hkv * d;
  float* ws_sc = a.ws_sc + sh * ctx + c0;
  const bool sc_smem = w <= kScoreSmem;
  float* sc = sc_smem ? sm + L.sc : ws_sc;
  // thread (slice, VEC features from f) of the value pass: it sums
  // positions slice, slice + n_slices, ...
  const int lanes = min(L.n_groups, kThreads);
  const int slice = threadIdx.x / lanes;
  const int f0 = VEC * (threadIdx.x % lanes);

  // scores
  const float scale = sqrtf((float)d);
  float mx = -INFINITY;
  Raw8<T> vraw[D > 0 ? kPrefetch : 1];
  if constexpr (D > 0) {
    // two threads per position, each with half its key row in flight;
    // the halves are added by one shuffle.  The first keys and the value
    // rows of the first kPrefetch positions of this thread's slice are
    // fetched before the landmark query is stored, so all these loads
    // overlap
    constexpr int HALF = D / 2;
    const int half = threadIdx.x & 1;
    for (int i0 = 0; i0 < n; i0 += kThreads / 2) {
      const int i = i0 + threadIdx.x / 2;
      float x[HALF];
      if (i < n) {
        const T* kr = kp + (row0 + i) * rs + (int64_t)h * D + half * HALF;
#pragma unroll
        for (int e = 0; e < HALF; e += 8) load8(kr + e, x + e);
      }
      if (i0 == 0) {
#pragma unroll
        for (int p = 0; p < kPrefetch; ++p) {
          const int ip = slice + p * L.n_slices;
          if (ip < n)
            fetch8(vp + (row0 + ip) * rs + (int64_t)h * D + f0, vraw[p]);
        }
        store_query<T>(q, q0, a.q_sum + sh * d, d, w);
      }
      float acc = 0.f;
      if (i < n) {
#pragma unroll
        for (int e = 0; e < HALF; ++e)
          acc = fmaf(q[half * HALF + e], x[e], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (i < n) {
        const float v = acc / scale;
        if (half == 0) {
          sc[i] = v;
          if (sc_smem) ws_sc[i] = v;
        }
        mx = fmaxf(mx, v);
      }
    }
  } else {
    store_query<T>(q, q0, a.q_sum + sh * d, d, w);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const T* kr = kp + (row0 + i) * rs + (int64_t)h * d;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc = fmaf(q[e], ld(kr + e), acc);
      const float v = acc / scale;
      sc[i] = v;
      if (sc_smem) ws_sc[i] = v;
      mx = fmaxf(mx, v);
    }
  }
  mx = block_reduce(mx, sm + L.red, true);

  // softmax weights (in place of the scores where they are on chip; the
  // workspace row keeps the scores for the merge's top-K)
  float l = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float p = expf(sc[i] - mx);
    if (sc_smem) sc[i] = p;
    l += p;
  }
  l = block_reduce(l, sm + L.red, false);
  auto weight = [&](int i) { return sc_smem ? sc[i] : expf(sc[i] - mx); };

  // o_j; the slices' sums are added in slice order
  if (slice < L.n_slices)
    for (int f = f0; f < d; f += VEC * kThreads) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      int i = slice;
      if constexpr (D > 0) {
#pragma unroll
        for (int p = 0; p < kPrefetch; ++p, i += L.n_slices)
          if (i < n) {
            float x[8];
            unpack8(vraw[p], x);
            const float pw = weight(i);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] = fmaf(pw, x[e], acc[e]);
          }
      }
#pragma unroll 8
      for (; i < n; i += L.n_slices) {
        const T* vr = vp + (row0 + i) * rs + (int64_t)h * d + f;
        float x[VEC];
        if constexpr (D > 0)
          load8(vr, x);
        else
          x[0] = ld(vr);
        const float pw = weight(i);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pw, x[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm[L.vsum + slice * d + f + e] = acc[e];
    }
  __syncthreads();
  const int64_t part = sh * m_slot + j;
  for (int f = threadIdx.x; f < d; f += kThreads) {
    float o = 0.f;
    for (int sl = 0; sl < L.n_slices; ++sl) o += sm[L.vsum + sl * d + f];
    a.ws_o[part * d + f] = o;
  }
  if (threadIdx.x == 0) {
    a.ws_m[part] = mx;
    a.ws_l[part] = l;
  }
}

// Block (s, h): the top-K, the merge of the splits' partials and the
// commit of slot s, KV head h.  Launched as a programmatic dependent of
// the split stage: it reads the workspace and writes the state only after
// the split grid has ended.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finalize_merge_kernel(const FinArgs a) {
  const int s = blockIdx.x, h = blockIdx.y;
  const int w = a.w, m_slot = a.m_slot, ctx = m_slot * w, d = a.d;
  const int k_w = a.k_w;
  const int64_t sh = (int64_t)s * a.hkv + h;
  float* qs = a.q_sum + sh * d;
  const bool due = a.due[s] != 0;
  const int tn = a.t_new[s];
  const float q0 = threadIdx.x < d ? qs[threadIdx.x] : 0.f;
  const int ord = tn / w - 1;
  const int nvis = min(max(tn, 0), ctx);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!due) return;
  if (ord < 0 || ord >= m_slot) {  // due, nothing to commit
    for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = 0.f;
    return;
  }
  extern __shared__ uint64_t sbuf[];
  const float* row = a.ws_sc + sh * ctx;
  const int32_t* pt = a.page_table + (int64_t)s * m_slot;
  const int64_t lm_off = (sh * m_slot + ord) * d;
  const int64_t e_off = (sh * m_slot + ord) * k_w;

  // the first kParts splits' partials, fetched before the sort so their
  // loads overlap it (thread i < d: its feature of each o_j)
  const int n_sp = (nvis + w - 1) / w;
  const float* pm = a.ws_m + sh * m_slot;
  const float* pl = a.ws_l + sh * m_slot;
  const float* po = a.ws_o + sh * m_slot * d;
  float pm_r[kParts], pl_r[kParts], po_r[kParts];
#pragma unroll
  for (int j = 0; j < kParts; ++j) {
    const bool in = j < n_sp;
    pm_r[j] = in ? pm[j] : -INFINITY;
    pl_r[j] = in ? pl[j] : 0.f;
    po_r[j] = in && (int)threadIdx.x < d ? po[(int64_t)j * d + threadIdx.x]
                                         : 0.f;
  }

  auto score = [&](int c) { return row[c]; };
  uint64_t* buf = sbuf;
  if (k_w <= kRadixK && nvis <= kRadixN) {
    // the row's keys in registers, 16 a thread; radix select
    uint64_t key[kRadixN / kThreads];
#pragma unroll
    for (int e = 0; e < kRadixN / kThreads; ++e) {
      const int c = e * kThreads + threadIdx.x;
      key[e] = c < nvis ? topk_sort::pack_key(row[c], c) : topk_sort::kEmpty;
    }
    topk_sort::topk_radix(key, min(k_w, nvis), sbuf,
                          reinterpret_cast<int*>(sbuf + kRadixK), threadIdx.x,
                          kThreads);
  } else {
    if (a.sort_ws != nullptr) buf = a.sort_ws + sh * a.sort_n;
    topk_sort::topk_desc(buf, a.sort_n, nvis, k_w, score, threadIdx.x,
                         kThreads);
  }
  const int kvis = min(k_w, nvis);
  for (int r = threadIdx.x; r < k_w; r += kThreads) {
    // masked lanes follow in index order, as lax.top_k returns them
    const int c =
        r < kvis ? topk_sort::key_index(buf[r]) : nvis + (r - kvis);
    a.expert_idx[e_off + r] = (int32_t)((int64_t)pt[c / w] * w + c % w);
    a.expert_valid[e_off + r] = r < kvis && row[c] > kNegInf / 2 ? 1 : 0;
  }

  // the splits' partials, merged in ascending split order
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kParts; ++j) m = fmaxf(m, pm_r[j]);
  for (int j = kParts; j < n_sp; ++j) m = fmaxf(m, pm[j]);
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < kParts; ++j) {
    if (j < n_sp) den += expf(pm_r[j] - m) * pl_r[j];
  }
  for (int j = kParts; j < n_sp; ++j) den += expf(pm[j] - m) * pl[j];
  T* lmq = static_cast<T*>(a.lm_q);
  T* lmv = static_cast<T*>(a.lm_v);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const bool own = i == (int)threadIdx.x;  // po_r holds this feature
    float num = 0.f;
#pragma unroll
    for (int j = 0; j < kParts; ++j) {
      if (j < n_sp)
        num += expf(pm_r[j] - m) * (own ? po_r[j] : po[(int64_t)j * d + i]);
    }
    for (int j = kParts; j < n_sp; ++j)
      num += expf(pm[j] - m) * po[(int64_t)j * d + i];
    st(lmv + lm_off + i, num / den);
    st(lmq + lm_off + i, round_to((own ? q0 : qs[i]) / (float)w, lmq));
    qs[i] = 0.f;
  }
}

template <typename Kern>
cudaError_t launch_kernel(Kern kern, dim3 grid, size_t smem, const FinArgs& a,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const FinArgs& a, int n_slots, cudaStream_t st) {
  const SplitLayout L(D > 0 ? 8 : 1, a.d, a.w);
  return launch_kernel(finalize_split_kernel<T, D>,
                       dim3(n_slots, a.hkv, a.m_slot), (size_t)L.total * 4, a,
                       st);
}

template <typename T>
cudaError_t launch(int stage, const FinArgs& a, int n_slots,
                   cudaStream_t st) {
  if (stage == 1) {
    // a programmatic dependent launch: the merge's blocks are resident
    // when the split grid ends (griddepcontrol.wait orders them)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_slots, a.hkv);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes =
        max(a.sort_ws != nullptr ? 0 : a.sort_n * 8, kRadixK * 8 + 519 * 4);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, finalize_merge_kernel<T>, a);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  const bool aligned =
      ((uintptr_t)a.k_pool | (uintptr_t)a.v_pool) % 16 == 0;
  if (aligned && a.d == 128) return launch_split<T, 128>(a, n_slots, st);
  if (aligned && a.d == 64) return launch_split<T, 64>(a, n_slots, st);
  return launch_split<T, 0>(a, n_slots, st);
}

}  // namespace

extern "C" {

// stage: 0 = split, 1 = merge (launch both, in this order, on one stream).
// dtype: 0 = float32 pools, 1 = bfloat16 pools.  The workspace pointers
// are laid out as FinArgs says; sort_ws == NULL keeps the merge's sort
// buffer of sort_n keys in shared memory.
int mita_paged_finalize(int stage, int dtype, void* q_sum, void* lm_q,
                        void* lm_v, void* expert_idx, void* expert_valid,
                        void* k_pool, void* v_pool, void* page_table,
                        void* t_new, void* due, void* ws_sc, void* ws_m,
                        void* ws_l, void* ws_o, void* sort_ws, int n_slots,
                        int hkv, int m_slot, int d, int k_w, int w,
                        int sort_n, void* stream) {
  const FinArgs a{(float*)q_sum,          lm_q,
                  lm_v,                   (int32_t*)expert_idx,
                  (uint8_t*)expert_valid, k_pool,
                  v_pool,                 (const int32_t*)page_table,
                  (const int32_t*)t_new,  (const uint8_t*)due,
                  (float*)ws_sc,          (float*)ws_m,
                  (float*)ws_l,           (float*)ws_o,
                  (uint64_t*)sort_ws,     hkv,
                  m_slot,                 d,
                  k_w,                    w,
                  sort_n};
  cudaStream_t st = (cudaStream_t)stream;
  if (stage != 0 && stage != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(stage, a, n_slots, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(stage, a, n_slots, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
