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
// assign [L, NS] int32 or int64, k_e / v_e [Lkv, M, K, d], valid
// [Lkv, M, K] bool bytes.  The key/value lead row of query lead row `lead`
// is computed here from the lead's shape and the KV lead's broadcast
// strides (`LeadMap`), so the G query heads of a KV head read one copy of
// its expert tiles and the wrapper builds no index map: one call is one
// CUDA launch.
//
// One block per (lead row, tile of 64 rows).  The block walks the DISTINCT
// experts present in its rows, smallest first (rows arrive sorted by
// expert, so each expert's rows are contiguous); for each expert it stages
// the expert's key and value tiles in shared memory and runs one masked
// attention tile with the mask (a[row] == e) & valid[key].  A row's bits
// depend only on its own query, expert and keys, never on the tiling, the
// sort order or its neighbours: a step in which a row has no key leaves
// its (o, m, l) unchanged bit for bit (the running max does not move, so
// its rescale factor is exactly 1, and its softmax weights are exactly 0),
// and a row that has seen no key stays exactly empty.  `block_q` is
// accepted by the wrapper and not needed.  Ragged NS: rows past NS are
// zero and never written.
//
// What bounds it on the H100: at qwen3-0.6b's forward shape (L = 16,
// NS = 4096, M = 32, K = d = 128, bf16) the function must move ~51 MB
// (q and o, each expert tile read once per KV head), ~15 us at 3.35 TB/s,
// and do 4.3 GFLOP, ~4 us on bf16 tensor cores: bytes.  What the kernel
// loses is latency: a tile takes 1.44 expert steps on average at that
// shape (at most 6, in the tiles just before the inactive tail), and each
// step is a dependent chain of copies, products and a softmax.  Per-block
// timestamps on the card showed a step's time going mostly to the
// validity mask read from shared memory inside the softmax and to two
// dependent global loads before a block's first copy.  Two paths:
//
//  * `expert_mma_kernel` (bf16, d = 64 or 128): tensor cores.  One
//    warpgroup owns the 64 rows; Q and each expert's 128-key K and V tiles
//    arrive by cp.async in the 128-byte-swizzled layout of attn_mma.cuh:
//    Q's copy starts with the block, K's and V's before the validity
//    bytes are read, and V's overlaps the score product.  S = Q K^T is a
//    wgmma with float32 accumulators; each thread's mask of its 32 key
//    columns is built while it runs; the mask, the online-softmax
//    statistics (float32, exp2 on the special-function unit) and the
//    weights stay in registers; P is rounded to bf16 and is the register A
//    operand of O += P V.  Two blocks per SM (255 registers a thread)
//    hide one block's copies behind the other's products, and blocks
//    take the heaviest tiles first (`tile_of_block`).  0.0444 ms of card
//    time at that shape against 0.5778 / 0.5809 for the previous
//    CUDA-core kernel in the same call (NVIDIA H100 80GB HBM3, 700 W,
//    scripts/ab_kernel.py), 2.9x the bound.
//  * `expert_attn_kernel` (float32, and bf16 at other head dims): the
//    CUDA-core tile of attn_tile.cuh in full float32, so float32 agrees
//    with its plain version to 1e-5 (0.3982 ms against 0.5622 / 0.5540
//    in that call, from the block order and the warp-wide expert search).
//    Head dims above 128 (recurrentgemma-9b's 256: lead [1, 1, 16], one
//    KV head, m = 32 at N = 4096) take its wide instance in both dtypes:
//    16 accumulator columns a thread and 149.5 KB of shared memory, one
//    block per SM.  Tensor cores at d = 256 (a 256-wide value product
//    split over two warpgroups) are later work.
//
// No atomics.  The entry point returns cudaGetLastError().

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using namespace attn_tile;

// The query lead as up to 4 dims (leading ones padded with 1) and the KV
// lead's element strides over them (0 on a broadcast dim).
struct LeadMap {
  int dims[4];
  int kv_stride[4];
};

__device__ __forceinline__ int64_t kv_lead_row(int lead, const LeadMap& lm) {
  int64_t kv = 0;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    kv += (int64_t)(lead % lm.dims[i]) * lm.kv_stride[i];
    lead /= lm.dims[i];
  }
  return kv;
}

// assign[i] as an expert id, n_exp for inactive rows.
__device__ __forceinline__ int load_assign(const void* assign, int64_t i,
                                           int i64, int n_exp) {
  const int64_t a = i64 ? static_cast<const int64_t*>(assign)[i]
                        : static_cast<const int32_t*>(assign)[i];
  return (a >= 0 && a < n_exp) ? (int)a : n_exp;
}

// The (lead row, first row) of this block's tile.  Blocks take the last
// tiles of every lead row first: rows arrive sorted by expert, so the
// tiles before the inactive tail hold the most (and smallest) experts and
// take longest; started first, they no longer set the kernel's tail.
__device__ __forceinline__ void tile_of_block(int n_lead, int n_tiles,
                                              int rows, int& lead, int& q0) {
  lead = blockIdx.x % n_lead;
  q0 = (n_tiles - 1 - blockIdx.x / n_lead) * rows;
}

// Warp 0: the smallest expert id above e_prev among qi[0..n), n_exp if
// none (written to every lane).
__device__ __forceinline__ int next_expert(const int* qi, int n, int e_prev,
                                           int n_exp) {
  int e = n_exp;
  for (int r = threadIdx.x % 32; r < n; r += 32)
    if (qi[r] > e_prev && qi[r] < e) e = qi[r];
  return __reduce_min_sync(0xffffffffu, e);
}

// ------------------------------------------------------------ float32 --

// NC accumulator columns a thread: kCols up to d = 128 (two blocks per
// SM), kColsWide up to d = 256 (one block: 149.5 KB of shared memory).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC == kCols ? 2 : 1)
    expert_attn_kernel(const T* __restrict__ q,
                       const void* __restrict__ assign, int assign_i64,
                       const T* __restrict__ k_e, const T* __restrict__ v_e,
                       const uint8_t* __restrict__ valid, LeadMap lm,
                       T* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out, int ns, int d, int n_exp,
                       int kw, int n_tiles, int n_lead, float scale) {
  extern __shared__ float smem[];
  __shared__ int e_next;
  const Smem S(smem, d);
  int lead, q0;
  tile_of_block(n_lead, n_tiles, TQ, lead, q0);
  const int rows = min(TQ, ns - q0);
  const int64_t row0 = (int64_t)lead * ns + q0;

  for (int r = threadIdx.x; r < TQ; r += kThreads)
    S.qi[r] = r < rows ? load_assign(assign, row0 + r, assign_i64, n_exp)
                       : n_exp;
  init_stats(S);
  const int64_t kv_row0 = kv_lead_row(lead, lm) * n_exp * kw;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  int e_prev = -1;
  for (;;) {
    __syncthreads();  // qi in place; the last tile's value product is done
    if (threadIdx.x < 32)
      e_next = next_expert(S.qi, TQ, e_prev, n_exp);
    __syncthreads();
    const int e = e_next;
    if (e >= n_exp) break;
    if (e_prev < 0) load_tile(S.q, q + row0 * d, rows, d, scale);
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
    for (int j = 0; j < NC; ++j)
      if (j < nc) st(o + (row0 + r) * d + tc + 16 * j, acc[i][j]);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    m_out[row0 + r] = S.m[r];
    l_out[row0 + r] = S.l[r];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* assign, int assign_i64,
                   const void* k_e, const void* v_e, const void* valid,
                   const LeadMap& lm, void* o, void* m_out, void* l_out,
                   int n_lead, int ns, int d, int n_exp, int kw, float scale,
                   cudaStream_t stream) {
  const long long smem = smem_bytes(d);
  auto kern = d <= kMaxD ? expert_attn_kernel<T, kCols>
                         : expert_attn_kernel<T, kColsWide>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (ns + TQ - 1) / TQ;
  kern<<<(unsigned)n_lead * n_tiles, kThreads, smem, stream>>>(
      (const T*)q, assign, assign_i64, (const T*)k_e, (const T*)v_e,
      (const uint8_t*)valid, lm, (T*)o, (float*)m_out, (float*)l_out, ns, d,
      n_exp, kw, n_tiles, n_lead, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 --

constexpr int kRows = 64;     // query rows per block: one warpgroup
constexpr int kKeys = 128;    // keys per tile
constexpr int kMmaThreads = 128;

template <int D>
constexpr int mma_smem_bytes() {
  // Q tile, one K and one V tile, 1 KB to align
  return kRows * D * 2 + 2 * kKeys * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
    expert_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const void* __restrict__ assign, int assign_i64,
                      const __nv_bfloat16* __restrict__ k_e,
                      const __nv_bfloat16* __restrict__ v_e,
                      const uint8_t* __restrict__ valid, LeadMap lm,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int ns, int n_exp, int kw,
                      int n_tiles, int n_lead, float scale,
                      float scale_log2) {
  using namespace attn_mma;
  constexpr int Q_BYTES = kRows * D * 2, KV_BYTES = kKeys * D * 2;
  constexpr int NS = kKeys / 2, NO = D / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int qi[kRows];
  __shared__ uint8_t ki[kKeys];
  __shared__ int e_next;
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + Q_BYTES, sv = sk + KV_BYTES;

  const int tid = threadIdx.x, lane = tid % 32;
  int lead, q0;
  tile_of_block(n_lead, n_tiles, kRows, lead, q0);
  const int rows = min(kRows, ns - q0);
  const int64_t row0 = (int64_t)lead * ns + q0;
  const int64_t kv_row0 = kv_lead_row(lead, lm) * n_exp * kw;
  // Q's copy overlaps the search for the tile's first expert
  load_tile_async<D, kRows, kMmaThreads>(sq, q + row0 * D, 0, rows, tid);
  cp_async_commit();
  if (tid < kRows)
    qi[tid] = tid < rows ? load_assign(assign, row0 + tid, assign_i64, n_exp)
                         : n_exp;

  // this thread's accumulator rows (the wgmma fragment map)
  const int r0 = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  float acc[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) acc[x] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  int e_prev = -1;
  for (;;) {
    __syncthreads();  // qi in place; the last tile's products are done
    if (tid < 32) e_next = next_expert(qi, kRows, e_prev, n_exp);
    __syncthreads();
    const int e = e_next;
    if (e >= n_exp) break;
    const bool rok0 = qi[r0] == e, rok1 = qi[r0 + 8] == e;
    for (int k0 = 0; k0 < kw; k0 += kKeys) {
      const int n_keys = min(kKeys, kw - k0);
      const int64_t kr = kv_row0 + (int64_t)e * kw + k0;
      if (k0 > 0) __syncthreads();  // the last key tile's products are done
      load_tile_async<D, kKeys, kMmaThreads>(sk, k_e + kr * D, 0, n_keys,
                                             tid);
      cp_async_commit();
      load_tile_async<D, kKeys, kMmaThreads>(sv, v_e + kr * D, 0, n_keys,
                                             tid);
      cp_async_commit();
      // the validity bytes' load overlaps the tiles' copies
      if (tid < kKeys) ki[tid] = tid < n_keys ? valid[kr + tid] : 0;
      cp_async_wait<1>();  // Q and K are in (V may still be on its way)
      fence_proxy_async();
      __syncthreads();

      float s[NS];
#pragma unroll
      for (int x = 0; x < NS; ++x) s[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da =
            make_desc(sq + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            make_desc(sk + (kk / 4) * kKeys * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
      wgmma_commit();
      // while the product runs: the validity of this thread's 32 key
      // columns (8 j + c0 + c, bit 2 j + c) as a register mask
      uint32_t colm = 0;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          colm |= (uint32_t)(ki[8 * j + c0 + c] != 0) << (2 * j + c);
      wgmma_wait<0>();
      fence_regs(s);

      // mask, then the online-softmax step in registers (statistics in
      // raw-score units, exponentials in the log2 domain)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int i = (x >> 1) & 1;
        const bool ok = (i ? rok1 : rok0) &&
                        ((colm >> (2 * (x >> 2) + (x & 1))) & 1u);
        if (!ok) s[x] = kNegInf;
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
                                         : ex2((m_run[i] - m_new) *
                                               scale_log2);
        mc[i] = (m_new == kNegInf) ? 0.f : m_new * scale_log2;
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int x = 0; x < NS; x += 2) {
        const int i = (x >> 1) & 1, jb = x >> 2;
        const float p0 = ex2(fmaf(s[x], scale_log2, -mc[i]));
        const float p1 = ex2(fmaf(s[x + 1], scale_log2, -mc[i]));
        l_run[i] += p0 + p1;
        // S register 4 jb + 2 i -> A fragment [jb / 2][2 (jb % 2) + i]
        pa[jb >> 1][2 * (jb & 1) + i] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int x = 0; x < NO; ++x) acc[x] *= alpha[(x >> 1) & 1];

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
    e_prev = e;
  }

  cp_async_wait<0>();  // an all-inactive tile's Q copy
  // o (un-normalised), m in scaled-score units, l; rows >= NS not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int x = 0; x < NO; x += 2) {
    const int row = r0 + 8 * ((x >> 1) & 1);
    if (row >= rows) continue;
    *reinterpret_cast<__nv_bfloat162*>(o + (row0 + row) * D + 8 * (x >> 2) +
                                       c0) =
        __floats2bfloat162_rn(acc[x], acc[x + 1]);
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= rows) continue;
      m_out[row0 + row] = m_run[i] == kNegInf ? kNegInf : m_run[i] * scale;
      l_out[row0 + row] = l_run[i];
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* assign, int assign_i64,
                       const void* k_e, const void* v_e, const void* valid,
                       const LeadMap& lm, void* o, void* m_out, void* l_out,
                       int n_lead, int ns, int n_exp, int kw, float scale,
                       cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  auto kern = expert_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (ns + kRows - 1) / kRows;
  kern<<<(unsigned)n_lead * n_tiles, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, assign, assign_i64,
      (const __nv_bfloat16*)k_e, (const __nv_bfloat16*)v_e,
      (const uint8_t*)valid, lm, (__nv_bfloat16*)o, (float*)m_out,
      (float*)l_out, ns, n_exp, kw, n_tiles, n_lead, scale,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k_e, v_e and o).  assign is int64
// when assign_i64, else int32.  lead_dims / kv_strides: the query lead as
// 4 dims (leading ones 1) and the KV lead row's stride over each (0 where
// the KV lead broadcasts).  bf16 at d = 64 or 128 runs on the tensor cores
// (`expert_mma_kernel`), everything else (d a multiple of 16, at most 256)
// on the CUDA cores.
int mita_expert_attention(int dtype, void* q, void* assign, int assign_i64,
                          void* k_e, void* v_e, void* valid,
                          const int* lead_dims, const int* kv_strides,
                          void* o, void* m_out, void* l_out, int n_lead,
                          int ns, int d, int n_exp, int kw, float scale,
                          void* stream) {
  if (d % 16 != 0 || d < 16 || d > attn_tile::kMaxDWide)
    return (int)cudaErrorInvalidValue;
  LeadMap lm;
  for (int i = 0; i < 4; ++i) {
    if (lead_dims[i] < 1) return (int)cudaErrorInvalidValue;
    lm.dims[i] = lead_dims[i];
    lm.kv_stride[i] = kv_strides[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && d == 128)
    return (int)launch_mma<128>(q, assign, assign_i64, k_e, v_e, valid, lm,
                                o, m_out, l_out, n_lead, ns, n_exp, kw,
                                scale, st);
  if (dtype == 1 && d == 64)
    return (int)launch_mma<64>(q, assign, assign_i64, k_e, v_e, valid, lm, o,
                               m_out, l_out, n_lead, ns, n_exp, kw, scale,
                               st);
  if (dtype == 0)
    return (int)launch<float>(q, assign, assign_i64, k_e, v_e, valid, lm, o,
                              m_out, l_out, n_lead, ns, d, n_exp, kw, scale,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, assign, assign_i64, k_e, v_e, valid,
                                      lm, o, m_out, l_out, n_lead, ns, d,
                                      n_exp, kw, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the CUDA-core kernel, in bytes (the tensor-core
// kernel's is fixed and smaller).
long long mita_expert_attention_smem_bytes(int d) {
  return attn_tile::smem_bytes(d);
}

}  // extern "C"
