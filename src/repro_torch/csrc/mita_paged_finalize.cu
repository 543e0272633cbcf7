// Fused paged landmark finalize for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `mita_paged_finalize_fused`
//   (src/repro/kernels/mita_paged_finalize.py:119, body `_finalize_kernel`
//   at :48).
//
// One block per (slot, KV head).  A slot that is not due returns at once,
// so its landmark, expert and q_sum rows stay bit-identical (the update is
// in place).  For a due slot, with t_new its position after the step:
//   1. q_lm = q_sum / w, cast to the landmark dtype;
//   2. scores of q_lm against every context position c < t_new, read
//      through the page table (row page_table[s, c/w]*w + c%w); the other
//      lanes hold NEG_INF;
//   3. top-K with first-index ties: K rounds of block argmax, each picked
//      lane retired with -inf (strictly below NEG_INF, as `_topk` does);
//   4. each pick maps to its global pool row, valid = value > NEG_INF/2;
//   5. softmax over the masked scores, v_lm = sum_c p_c V_c;
//   6. commit at window ordinal t_new/w - 1 and zero q_sum.
//
// What bounds it on the H100: bytes.  It reads the slot's K and V rows
// once each (2*t_new*d elements) against 4*t_new*d flops -- about 1 FLOP
// per byte in bf16.  Unlike the TPU kernel, which stages the whole slot
// context in VMEM, this kernel streams K/V rows straight from the pools:
// pages_per_slot*w*d*2*2 bytes exceeds the 227 KB a block can hold for
// long contexts.  Only the float32 score row is kept on chip, in dynamic
// shared memory while ctx*4 bytes fit (the attribute is raised above
// 48 KB), else in a workspace the wrapper allocates.  The K rounds of
// argmax scan only the visible lanes; picks past the visible context are
// the NEG_INF lanes in index order, exactly as `lax.top_k` orders them.
//
// Float32 statistics, 64-bit row offsets, no atomics.  The entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -FLT_MAX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Shared-memory layout in 4-byte words; the score row comes last and is
// present only on the shared-memory path.
struct Layout {
  int q, red_v, red_i, top_v, top_i, sc, total;
  __host__ __device__ Layout(int d, int k, int ctx, bool with_scores) {
    q = 0;
    red_v = q + d;
    red_i = red_v + kWarps;
    top_v = red_i + kWarps;
    top_i = top_v + k;
    sc = top_i + k;
    total = sc + (with_scores ? ctx : 0);
  }
};

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

// (max, first index of max) over sc[0, n); ties go to the lower index.
__device__ void block_argmax(const float* sc, int n, float* red_v,
                             int* red_i, float* out_v, int* out_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    if (sc[c] > best) {
      best = sc[c];
      bi = c;
    }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > best || (ov == best && oi < bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = red_v[0];
    int i0 = red_i[0];
    for (int w = 1; w < kWarps; ++w)
      if (red_v[w] > b || (red_v[w] == b && red_i[w] < i0)) {
        b = red_v[w];
        i0 = red_i[w];
      }
    *out_v = b;
    *out_i = i0;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_finalize_kernel(
    float* q_sum, T* lm_q, T* lm_v, int32_t* expert_idx,
    uint8_t* expert_valid, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ t_new, const uint8_t* __restrict__ due,
    float* ws, int hkv, int m_slot, int d, int k_w, int w) {
  const int s = blockIdx.x, h = blockIdx.y;
  if (!due[s]) return;
  extern __shared__ float sm[];
  const int ctx = m_slot * w;
  const Layout L(d, k_w, ctx, ws == nullptr);
  const int sh = s * hkv + h;
  float* sc = (ws == nullptr) ? sm + L.sc : ws + (int64_t)sh * ctx;
  int* red_i = reinterpret_cast<int*>(sm + L.red_i);
  int* top_i = reinterpret_cast<int*>(sm + L.top_i);
  float* top_v = sm + L.top_v;
  const int tn = t_new[s];
  const int nvis = tn < ctx ? (tn > 0 ? tn : 0) : ctx;
  const int64_t row_stride = (int64_t)hkv * d;
  const int32_t* pt = page_table + (int64_t)s * m_slot;
  const float scale_div = sqrtf((float)d);

  // 1. landmark query, rounded to the landmark dtype
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    sm[L.q + i] = round_to(q_sum[(int64_t)sh * d + i] / (float)w, lm_q);
  __syncthreads();

  // 2. scores over the visible context (one warp per position)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < nvis; c += kWarps) {
    const int64_t row = (int64_t)pt[c / w] * w + c % w;
    const T* kr = k_pool + row * row_stride + (int64_t)h * d;
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += sm[L.q + i] * ld(kr + i);
    acc = warp_sum(acc);
    if (lane == 0) sc[c] = acc / scale_div;
  }
  __syncthreads();

  // 3. top-K, first-index ties; picked lanes retired with -inf
  const int kvis = k_w < nvis ? k_w : nvis;
  for (int r = 0; r < kvis; ++r) {
    block_argmax(sc, nvis, sm + L.red_v, red_i, top_v + r, top_i + r);
    if (threadIdx.x == 0) sc[top_i[r]] = -INFINITY;
    __syncthreads();
  }
  for (int r = kvis + threadIdx.x; r < k_w; r += blockDim.x) {
    top_v[r] = kNegInf;       // masked lanes, in index order
    top_i[r] = nvis + (r - kvis);
  }
  for (int r = threadIdx.x; r < kvis; r += blockDim.x)
    sc[top_i[r]] = top_v[r];  // restore the scores for the softmax
  __syncthreads();

  // 5. softmax over all ctx lanes (masked lanes are NEG_INF: they weigh
  // exactly 0 unless nothing is visible, when every lane weighs 1/ctx)
  const int ncon = nvis > 0 ? nvis : ctx;
  if (nvis == 0) {
    for (int c = threadIdx.x; c < ctx; c += blockDim.x) sc[c] = kNegInf;
    __syncthreads();
  }
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < ncon; c += blockDim.x) mx = fmaxf(mx, sc[c]);
  mx = block_max(mx, sm + L.red_v);
  float sum = 0.f;
  for (int c = threadIdx.x; c < ncon; c += blockDim.x)
    sum += expf(sc[c] - mx);
  sum = block_sum(sum, sm + L.red_v);
  for (int c = threadIdx.x; c < ncon; c += blockDim.x)
    sc[c] = expf(sc[c] - mx) / sum;
  __syncthreads();

  // 4 + 6. commit at ordinal t_new/w - 1
  const int ord = tn / w - 1;
  if (ord < 0 || ord >= m_slot) return;
  const int64_t lm_off = ((int64_t)sh * m_slot + ord) * d;
  const int64_t e_off = ((int64_t)sh * m_slot + ord) * k_w;
  for (int r = threadIdx.x; r < k_w; r += blockDim.x) {
    const int c = top_i[r];
    expert_idx[e_off + r] = pt[c / w] * w + c % w;
    expert_valid[e_off + r] = top_v[r] > kNegInf / 2 ? 1 : 0;
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < ncon; ++c) {
      const float p = sc[c];
      if (p != 0.f) {
        const int64_t row = (int64_t)pt[c / w] * w + c % w;
        acc += p * ld(v_pool + row * row_stride + (int64_t)h * d + i);
      }
    }
    st(lm_q + lm_off + i, sm[L.q + i]);
    st(lm_v + lm_off + i, acc);
    q_sum[(int64_t)sh * d + i] = 0.f;
  }
}

template <typename T>
cudaError_t launch(void* q_sum, void* lm_q, void* lm_v, void* expert_idx,
                   void* expert_valid, void* k_pool, void* v_pool,
                   void* page_table, void* t_new, void* due, void* ws,
                   int n_slots, int hkv, int m_slot, int d, int k_w, int w,
                   cudaStream_t stream) {
  const Layout L(d, k_w, m_slot * w, ws == nullptr);
  const size_t smem = (size_t)L.total * 4;
  auto kern = paged_finalize_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_slots, hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      (float*)q_sum, (T*)lm_q, (T*)lm_v, (int32_t*)expert_idx,
      (uint8_t*)expert_valid, (const T*)k_pool, (const T*)v_pool,
      (const int32_t*)page_table, (const int32_t*)t_new,
      (const uint8_t*)due, (float*)ws, hkv, m_slot, d, k_w, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 pools, 1 = bfloat16 pools.  ws == NULL keeps the
// score row in shared memory; otherwise ws holds n_slots*hkv*ctx floats.
int mita_paged_finalize(int dtype, void* q_sum, void* lm_q, void* lm_v,
                        void* expert_idx, void* expert_valid, void* k_pool,
                        void* v_pool, void* page_table, void* t_new,
                        void* due, void* ws, int n_slots, int hkv,
                        int m_slot, int d, int k_w, int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q_sum, lm_q, lm_v, expert_idx, expert_valid,
                              k_pool, v_pool, page_table, t_new, due, ws,
                              n_slots, hkv, m_slot, d, k_w, w, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        q_sum, lm_q, lm_v, expert_idx, expert_valid, k_pool, v_pool,
        page_table, t_new, due, ws, n_slots, hkv, m_slot, d, k_w, w, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block, in bytes, with the score row on
// chip (with_scores = 1) or in the workspace (with_scores = 0).
long long mita_paged_finalize_smem_bytes(int d, int k_w, int ctx,
                                         int with_scores) {
  return (long long)Layout(d, k_w, ctx, with_scores != 0).total * 4;
}

}  // extern "C"
