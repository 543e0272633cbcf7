// Blocked flash attention for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `flash_attention`
//   (src/repro/kernels/flash_attn.py:79, body `_flash_kernel` at :27).
//
// q [BH, N, d], k / v [BH, Nk, d] -> o [BH, N, d] in q's dtype, online
// softmax over key tiles with the guarded statistics of the Pallas body
// (masked lanes at NEG_INF, alpha = 0 while the running max is NEG_INF,
// a row with l = 0 gives 0).  Causal mode: row i sees keys 0..i (absolute
// indices, so cross lengths Nk != N follow the same rule), and key tiles
// that lie wholly above the diagonal of a block's rows are never loaded.
// Ragged N and Nk are masked here; the divisibility contract of the JAX
// kernel is checked by the wrapper.  No atomics: every output element is
// written by one thread.
//
// What bounds it on the H100: at [1, 16, 4096, 128] bf16 causal the
// function does ~69 GFLOP (about 70 us on bf16 tensor cores) and must move
// 67 MB (20 us): operations.  Two paths:
//
//  * `flash_tma_kernel` (bf16, d = 64 or 128): tensor cores.  A block
//    owns 128 query rows of one (batch, head): two consumer warpgroups of
//    64 rows and one producer warp.  Q is staged once (cp.async); the
//    producer fills a two-stage shared-memory ring of 128-key K and V
//    tiles by TMA (tensor maps with the 128-byte swizzle; each tile
//    completes on its own mbarrier), and the consumers release a stage
//    through an `empty` mbarrier, so the warpgroups never wait for each
//    other and one's softmax overlaps the other's products.  S = Q K^T is
//    a wgmma (bf16 in, float32 accumulators in registers); the online
//    softmax runs on the accumulator fragment in registers (a row lives
//    in the four lanes of a quad, exp2 on the special-function unit); P
//    is rounded to bf16 in registers and is the A operand of the second
//    wgmma against V, read MN-major through the transposed-B form.  Only
//    the diagonal tiles (and the ragged last one) are masked; rows and
//    keys past N / Nk arrive as zeros.  Blocks start with the heaviest
//    (last) query tiles.
//  * `flash_kernel` (float32, and bf16 at other head dims): the CUDA-core
//    tile of attn_tile.cuh in full float32 (no TF32), so float32 meets
//    the 1e-5 tolerance.
//
// The tensor-core path rounds P to bf16 before P V, as the reference
// oracle `flash_attention_ref` does; the plain version keeps P in float32
// (both within the bf16 tolerance).  The entry points return
// cudaGetLastError().

#include <cuda.h>

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using namespace attn_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n, int nk,
                 int d, int n_tiles, int causal, float scale) {
  extern __shared__ float smem[];
  const Smem S(smem, d);
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - bh * n_tiles) * TQ;
  const int rows = min(TQ, n - q0);
  const int64_t qrow0 = (int64_t)bh * n + q0;
  const int64_t krow0 = (int64_t)bh * nk;

  load_tile(S.q, q + qrow0 * d, rows, d, scale);
  init_stats(S);
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // causal: a key tile starting past the block's last row is all masked
  const int k_end = causal ? min(nk, q0 + TQ) : nk;
  for (int k0 = 0; k0 < k_end; k0 += TK) {
    const int n_keys = min(TK, nk - k0);
    attend_tile(
        S, k + (krow0 + k0) * d, v + (krow0 + k0) * d, n_keys, d,
        [&](int r, int kk) {
          return kk < n_keys && (!causal || k0 + kk <= q0 + r);
        },
        acc);
  }
  __syncthreads();  // statistics of the last tile are in place

  const int tq = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int nc = d / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq * 4 + i;
    if (r >= rows) continue;
    const float l = S.l[r];
    const float denom = (l == 0.f) ? 1.f : l;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < nc) st(o + (qrow0 + r) * d + tc + 16 * j, acc[i][j] / denom);
  }
}

template <typename T>
cudaError_t launch(void* q, void* k, void* v, void* o, int bh, int n, int nk,
                   int d, int causal, float scale, cudaStream_t stream) {
  const long long smem = smem_bytes(d);
  auto kern = flash_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (n + TQ - 1) / TQ;
  kern<<<(unsigned)bh * n_tiles, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n, nk, d, n_tiles, causal,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 --

// One key tile for one warpgroup: S = Q K^T (wgmma), the online-softmax
// step on the accumulator fragment in registers, O = O * alpha + P V
// (wgmma, P rounded to bf16).  Statistics stay in raw-score units; the
// exponentials run in the log2 domain.  Masked lanes are NEG_INF (only the
// diagonal and the ragged last tile are masked); alpha = 0 while the
// running max is NEG_INF, and exp2 of a masked lane is 0 whatever the max.
// wait_k() / wait_v() return once the tile's keys / values are in shared
// memory.
template <int D, int BN, int BM, typename WaitK, typename WaitV>
__device__ __forceinline__ void attend_tile_mma(
    uint32_t sq, uint32_t kt, uint32_t vt, int wq0, int k0, int r0, int c0,
    int nk, bool causal, float scale_log2, float (&acc)[D / 2],
    float (&m_run)[2], float (&l_run)[2], WaitK wait_k, WaitV wait_v) {
  using namespace attn_mma;
  constexpr int NS = BN / 2, NO = D / 2;
  float s[NS];
#pragma unroll
  for (int x = 0; x < NS; ++x) s[x] = 0.f;
  wait_k();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = make_desc(
        sq + (kk / 4) * BM * 128 + (wq0 % BM) * 128 + (kk % 4) * 32, 16,
        1024);
    const uint64_t db =
        make_desc(kt + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  if ((causal && k0 + BN - 1 > wq0) || k0 + BN > nk) {
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      const int col = k0 + 8 * (x >> 2) + c0 + (x & 1);
      if (col >= nk || (causal && col > r0 + 8 * ((x >> 1) & 1)))
        s[x] = attn_tile::kNegInf;
    }
  }
  float mx[2] = {attn_tile::kNegInf, attn_tile::kNegInf};
#pragma unroll
  for (int x = 0; x < NS; ++x)
    mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
  float alpha[2], mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = (m_run[i] == attn_tile::kNegInf)
                   ? 0.f
                   : ex2((m_run[i] - m_new) * scale_log2);
    mc[i] = (m_new == attn_tile::kNegInf) ? 0.f : m_new * scale_log2;
    m_run[i] = m_new;
    l_run[i] *= alpha[i];
  }
  uint32_t pa[BN / 16][4];
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

  wait_v();
  wgmma_fence();
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = make_desc(vt + kk * 16 * 128, BN * 128, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(acc, pa[kk], db, 1);
    else
      wgmma_rs_n64(acc, pa[kk], db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// o = acc / l for this thread's rows r0 and r0 + 8 (a row with l = 0 gives
// 0); rows >= n are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float (&l_run)[2],
                                           __nv_bfloat16* ob, int r0, int c0,
                                           int n) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int x = 0; x < D / 2; x += 2) {
    const int i = (x >> 1) & 1;
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    const float inv = (l_run[i] == 0.f) ? 0.f : 1.f / l_run[i];
    *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * D + 8 * (x >> 2) +
                                       c0) =
        __floats2bfloat162_rn(acc[x] * inv, acc[x + 1] * inv);
  }
}

// The tensor-core path's tiling: 128 keys per tile, two consumer
// warpgroups (128 query rows a block), a two-stage ring (160 KB of shared
// memory at d = 128, 168 registers a thread, one block per SM).  With
// tiles of as many keys as a block has rows, no causal key tile lies wholly
// above a warpgroup's rows, so every warpgroup works on every tile.
constexpr int kBM = 128, kBN = 128, kStages = 2;
constexpr int kConsumers = 2 * 128;

template <int D>
constexpr int mma_smem_bytes() {
  // Q tile, the ring of K and V tiles, 3 mbarriers per stage, 1 KB to align
  return kBM * D * 2 + 2 * kStages * kBN * D * 2 + 3 * kStages * 8 + 1024;
}

// Warp-specialised ring: two consumer warpgroups and one producer warp.
// One producer thread fills the ring by TMA (K and V tiles each complete
// on their own mbarrier); consumers wait on those and release a stage
// through an `empty` mbarrier, so the warpgroups never wait for each
// other.  Q is staged once by the consumers (cp.async).
template <int D>
__global__ void __launch_bounds__(kConsumers + 32, 1)
    flash_tma_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __nv_bfloat16* __restrict__ q,
                     __nv_bfloat16* __restrict__ o, int n, int nk,
                     int n_tiles, int causal, float scale_log2) {
  using namespace attn_mma;
  constexpr int ST = kStages, Q_BYTES = kBM * D * 2, KV_BYTES = kBN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + Q_BYTES, sv = sk + ST * KV_BYTES;
  const uint32_t full_k = sv + ST * KV_BYTES, full_v = full_k + 8 * ST;
  const uint32_t empty = full_v + 8 * ST;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (n_tiles - 1 - (blockIdx.x - bh * n_tiles)) * kBM;
  const int k_end = causal ? min(nk, q0 + kBM) : nk;
  const int n_kt = (k_end + kBN - 1) / kBN;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(full_v + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    mbar_fence_init();
  }
  if (tid < kConsumers) {
    load_tile_async<D, kBM, kConsumers>(sq, q + (int64_t)bh * n * D, q0, n,
                                        tid);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(empty + 8 * st, ((j / ST) - 1) & 1);
        mbar_expect_tx(full_k + 8 * st, KV_BYTES);
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_3d(sk + st * KV_BYTES + cb * kBN * 128, &tm_k,
                      full_k + 8 * st, 64 * cb, j * kBN, bh);
        mbar_expect_tx(full_v + 8 * st, KV_BYTES);
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_3d(sv + st * KV_BYTES + cb * kBN * 128, &tm_v,
                      full_v + 8 * st, 64 * cb, j * kBN, bh);
      }
    }
    return;
  }

  const int t = tid % 128, lane = t % 32;
  const int wq0 = q0 + 64 * (tid / 128);
  const int r0 = wq0 + 16 * (t / 32) + lane / 4, c0 = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {attn_tile::kNegInf, attn_tile::kNegInf};
  float l_run[2] = {0.f, 0.f};
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % ST;
    const uint32_t parity = (j / ST) & 1;
    attend_tile_mma<D, kBN, kBM>(
        sq, sk + st * KV_BYTES, sv + st * KV_BYTES, wq0, j * kBN, r0, c0, nk,
        causal, scale_log2, acc, m_run, l_run,
        [&] { mbar_wait(full_k + 8 * st, parity); },
        [&] { mbar_wait(full_v + 8 * st, parity); });
    mbar_arrive(empty + 8 * st);
  }
  store_rows<D>(acc, l_run, o + (int64_t)bh * n * D, r0, c0, n);
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no
// link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// [bh, rows, D] bf16, boxes of 64 columns x kBN rows x 1, 128-byte
// swizzle; rows past `rows` read as zeros.
template <int D>
bool make_kv_map(CUtensorMap* map, void* base, int bh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kBN, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tma(void* q, void* k, void* v, void* o, int bh, int n,
                       int nk, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  CUtensorMap tm_k, tm_v;
  if (!make_kv_map<D>(&tm_k, k, bh, nk) || !make_kv_map<D>(&tm_v, v, bh, nk))
    return cudaErrorInvalidValue;
  auto kern = flash_tma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (n + kBM - 1) / kBM;
  kern<<<(unsigned)bh * n_tiles, kConsumers + 32, smem, stream>>>(
      tm_k, tm_v, (const __nv_bfloat16*)q, (__nv_bfloat16*)o, n, nk, n_tiles,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).
int flash_attention(int dtype, void* q, void* k, void* v, void* o, int bh,
                    int n, int nk, int d, int causal, float scale,
                    void* stream) {
  if (d % 16 != 0 || d < 16 || d > attn_tile::kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, bh, n, nk, d, causal, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, bh, n, nk, d, causal, scale,
                                      st);
  return (int)cudaErrorInvalidValue;
}

// bf16 q, k, v and o on the tensor cores; head dim 64 or 128.
int flash_attention_mma(void* q, void* k, void* v, void* o, int bh, int n,
                        int nk, int d, int causal, float scale,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 128)
    return (int)launch_tma<128>(q, k, v, o, bh, n, nk, causal, scale, st);
  if (d == 64)
    return (int)launch_tma<64>(q, k, v, o, bh, n, nk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
