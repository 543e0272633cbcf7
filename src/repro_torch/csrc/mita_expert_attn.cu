// MiTA routed-expert attention partials for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `mita_expert_attention`
//   (src/repro/kernels/mita_expert_attn.py:80, body `_expert_kernel` at :38).
//
// The routed branch of the full-sequence forward (paper Alg. 1 line 14):
// every sub-query row attends only the K key/value rows of its own expert
// a (validity-masked) and returns the un-normalised online-softmax partial
// (o, m, l); a row whose expert is inactive (a >= m, or a < 0) gives
// exactly o = 0, m = NEG_INF, l = 0.
//
// Layout: q [L, NS, d] (L = the flattened query lead, e.g. B*Hkv*G),
// assign [L, NS] int32, k_e / v_e [Lkv, M, K, d], valid [Lkv, M, K] uint8,
// kv_map [L] int32 = the key/value lead row of each query lead row.  The
// map lets the G query heads of a KV head read one copy of its expert
// tiles (the Pallas wrapper broadcasts k_e to G copies first).
//
// One block per (lead row, tile of 64 rows).  The block walks the DISTINCT
// experts present in its rows, smallest first (rows arrive sorted by
// expert, so a tile holds one or two experts and each expert's rows are
// contiguous); for each expert it stages the expert's key tiles of 64 rows
// in shared memory and runs the shared tile step of attn_tile.cuh with the
// mask (a[row] == e) & valid[key].  Walking distinct experts instead of
// the range [a[0], a[-1]] makes the result independent of the tiling and
// of the sort order: `block_q` is accepted by the wrapper and not needed.
// Ragged NS: rows past NS are zero and never written.
//
// What bounds it on the H100: at qwen3-0.6b's forward shape (L = 16,
// NS = 4096, M = 32, K = d = 128, bf16) the function must move ~51 MB
// (q and o, each expert tile read once per KV head), ~15 us at 3.35 TB/s,
// and do 4.3 GFLOP, ~4 us on bf16 tensor cores: bytes.  This first version
// computes on the CUDA cores in float32 (the float32 path must agree with
// its plain version to 1e-5, which bf16 tensor-core products would not),
// and re-reads each expert tile once per query tile from L2; it is bound
// by shared-memory bandwidth of the score and value products.  Tensor
// cores (wgmma on 64-row tiles) are the next step.
//
// No atomics.  The entry point returns cudaGetLastError().

#include "attn_tile.cuh"

namespace {

using namespace attn_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    expert_attn_kernel(const T* __restrict__ q,
                       const int32_t* __restrict__ assign,
                       const T* __restrict__ k_e, const T* __restrict__ v_e,
                       const uint8_t* __restrict__ valid,
                       const int32_t* __restrict__ kv_map, T* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int ns, int d, int n_exp, int kw, int n_tiles,
                       float scale) {
  extern __shared__ float smem[];
  __shared__ int e_next;
  const Smem S(smem, d);
  const int lead = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - lead * n_tiles) * TQ;
  const int rows = min(TQ, ns - q0);
  const int64_t row0 = (int64_t)lead * ns + q0;

  load_tile(S.q, q + row0 * d, rows, d, scale);
  for (int r = threadIdx.x; r < TQ; r += kThreads) {
    const int a = r < rows ? assign[row0 + r] : n_exp;
    S.qi[r] = (a >= 0 && a < n_exp) ? a : n_exp;  // n_exp = inactive
  }
  init_stats(S);
  const int64_t kv_row0 = (int64_t)kv_map[lead] * n_exp * kw;

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  int e_prev = -1;
  for (;;) {
    __syncthreads();  // qi in place; the last tile's value product is done
    if (threadIdx.x == 0) {
      int e = n_exp;  // the smallest expert above e_prev in this tile
      for (int r = 0; r < TQ; ++r) {
        const int a = S.qi[r];
        if (a > e_prev && a < e) e = a;
      }
      e_next = e;
    }
    __syncthreads();
    const int e = e_next;
    if (e >= n_exp) break;
    for (int k0 = 0; k0 < kw; k0 += TK) {
      const int n_keys = min(TK, kw - k0);
      const int64_t kr = kv_row0 + (int64_t)e * kw + k0;
      const int t = threadIdx.x;
      if (t < TK) S.ki[t] = t < n_keys ? valid[kr + t] : 0;
      attend_tile(
          S, k_e + kr * d, v_e + kr * d, n_keys, d,
          [&](int r, int kk) { return S.qi[r] == e && S.ki[kk] != 0; }, acc);
    }
    e_prev = e;
  }

  // the loop ended on a barrier after the last statistics update
  const int tq = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int nc = d / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < nc) st(o + (row0 + r) * d + tc + 16 * j, acc[i][j]);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    m_out[row0 + r] = S.m[r];
    l_out[row0 + r] = S.l[r];
  }
}

template <typename T>
cudaError_t launch(void* q, void* assign, void* k_e, void* v_e, void* valid,
                   void* kv_map, void* o, void* m_out, void* l_out,
                   int n_lead, int ns, int d, int n_exp, int kw, float scale,
                   cudaStream_t stream) {
  const long long smem = smem_bytes(d);
  auto kern = expert_attn_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (ns + TQ - 1) / TQ;
  kern<<<(unsigned)n_lead * n_tiles, kThreads, smem, stream>>>(
      (const T*)q, (const int32_t*)assign, (const T*)k_e, (const T*)v_e,
      (const uint8_t*)valid, (const int32_t*)kv_map, (T*)o, (float*)m_out,
      (float*)l_out, ns, d, n_exp, kw, n_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_e, v_e and o).
int mita_expert_attention(int dtype, void* q, void* assign, void* k_e,
                          void* v_e, void* valid, void* kv_map, void* o,
                          void* m_out, void* l_out, int n_lead, int ns, int d,
                          int n_exp, int kw, float scale, void* stream) {
  if (d % 16 != 0 || d < 16 || d > attn_tile::kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, assign, k_e, v_e, valid, kv_map, o, m_out,
                              l_out, n_lead, ns, d, n_exp, kw, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, assign, k_e, v_e, valid, kv_map, o,
                                      m_out, l_out, n_lead, ns, d, n_exp, kw,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs, in bytes.
long long mita_expert_attention_smem_bytes(int d) {
  return attn_tile::smem_bytes(d);
}

}  // extern "C"
