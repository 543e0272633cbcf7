// Blocked flash attention for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `flash_attention`
//   (src/repro/kernels/flash_attn.py:79, body `_flash_kernel` at :27).
//
// q [BH, N, d], k / v [BH, Nk, d] -> o [BH, N, d] in q's dtype, with the
// online softmax of attn_tile.cuh over key tiles of 64 rows; o = acc / l
// rounded once (a row with l = 0 gives 0).  Causal mode: row i sees keys
// 0..i (absolute indices, so cross lengths Nk != N follow the same rule),
// and key tiles that lie wholly above the diagonal of the block's rows are
// never loaded.  One block per (batch-head, tile of 64 query rows); ragged
// N and Nk are masked here, the divisibility contract of the JAX kernel
// is checked by the wrapper.
//
// What bounds it on the H100: at [1, 16, 4096, 128] bf16 causal the
// function does ~69 GFLOP (about 70 us on bf16 tensor cores) and must move
// 67 MB (20 us): operations.  This first version computes on the CUDA
// cores in float32, so it stays far from that bound; no model path of the
// port calls it (the JAX package's only caller is `ops.flash_attention`).
//
// No atomics.  The entry point returns cudaGetLastError().

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

}  // extern "C"
