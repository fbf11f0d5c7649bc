// The tiled float32 GEMM shared by the convolution-backward GEMM (conv_gemm.cu, K3) and the
// fused linear layer (linear.cu, K1): tile sizes, the double-buffered mainloop, the split-K
// rule and the in-order split-K sum. Each kernel supplies its own operand feed (how a K step
// of A and B is read from global memory and laid out k-major in shared memory) and its own
// epilogue; the kernels keep their own names, so a profile still tells them apart.
//
//  * A block computes a BM x BN tile of the output (128 x 128, or 128 x 64 when N <= 64, so
//    half a tile is not wasted on masked columns). Each thread holds a TM x TN = 8 x 8
//    register tile and, per step of BK = 8 along K, reads 8 values of A and 8 of B from
//    shared memory for 64 fused multiply-adds. Its 8 rows are two runs of 4, BM / 2 apart,
//    and so are its 8 columns (BN / 2 apart): the 16-byte shared loads of a quarter warp
//    then fall on distinct banks.
//  * Two shared-memory buffers: the next K step is loaded from global memory into registers
//    while the current one is multiplied, then stored into the other buffer; one
//    __syncthreads a step.
//  * Split K for products with few output tiles and a long K: blockIdx.z takes one K range
//    and writes its partial tile to a (splits, M, N) float32 scratch that the caller
//    allocates; a second launch sums the splits in a fixed order. No atomics, so a rerun is
//    bit-identical.

#pragma once

#include <cuda_runtime.h>

namespace gemm_tile {

constexpr int BM = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int A_PAD = 4;  // floats a k-row of A's shared tile is padded by (bank conflicts)
constexpr int kMaxSplits = 256;
constexpr int kReduceThreads = 256;

// Threads of a block with a BN-wide tile.
template <int BN>
__host__ __device__ constexpr int threads() {
  return (BM / TM) * (BN / TN);
}

inline int num_sms() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    cached[dev] = n;
  }
  return cached[dev];
}

inline int tile_n(long long n) { return n <= 64 ? 64 : 128; }

// The K range each split of an (m, n, k) product takes on the current device, a multiple
// of BK: k rounded up when the product has enough output tiles to fill the card (two blocks
// an SM), else split into chunks of at least min_split (at most kMaxSplits of them).
inline long long k_chunk(long long m, long long n, long long k, long long min_split) {
  if (m <= 0 || n <= 0 || k <= 0) return BK;
  const long long tiles = ((m + BM - 1) / BM) * ((n + tile_n(n) - 1) / tile_n(n));
  const long long target = 2LL * num_sms();
  long long splits = 1;
  if (tiles < target) {
    splits = (target + tiles - 1) / tiles;
    if (splits > k / min_split) splits = k / min_split;
    if (splits > kMaxSplits) splits = kMaxSplits;
    if (splits < 1) splits = 1;
  }
  const long long per = (k + splits - 1) / splits;
  return (per + BK - 1) / BK * BK;
}

// Row of the block's tile that a thread's register row i (0..TM) holds, and column of its
// register column j (0..TN).
__device__ __forceinline__ int tile_row(int i, int ty) {
  return i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4;
}
template <int BN>
__device__ __forceinline__ int tile_col(int j, int tx) {
  return j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4;
}

// acc = A[:, kbeg:kend] @ B[kbeg:kend, :] for the block's tile, from shared tiles As
// ([2][BK][BM + A_PAD], k-major) and Bs ([2][BK][BN + B_PAD], k-major). load(k0) reads the
// K step at k0 from global memory into the caller's registers, masked to zero outside the
// operands and [kbeg, kend); store(buf) writes those registers into shared buffer buf.
template <int BN, int B_PAD, typename Load, typename Store>
__device__ __forceinline__ void mainloop(float (&As)[2][BK][BM + A_PAD],
                                         float (&Bs)[2][BK][BN + B_PAD], Load&& load,
                                         Store&& store, int kbeg, int kend, int tx, int ty,
                                         float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  if (ntiles > 0) {
    load(kbeg);
    store(0);
    __syncthreads();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < ntiles;
    if (more) load(kbeg + (t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4 + BM / 2]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4 + BN / 2]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }
}

// out[i] = epi(sum over z of ws[z][i], z in order, i) for i < mn: the body of a split-K
// reduce kernel (grid-stride over kReduceThreads-thread blocks).
template <typename Epi>
__device__ __forceinline__ void splitk_reduce(const float* __restrict__ ws,
                                              float* __restrict__ out, long long mn, int splits,
                                              Epi epi) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn; i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[(long long)z * mn + i]);
    out[i] = epi(s, i);
  }
}

// Blocks of a split-K reduce over mn outputs: one thread an output, at most four blocks an
// SM (grid-stride beyond).
inline unsigned int reduce_blocks(long long mn) {
  long long blocks = (mn + kReduceThreads - 1) / kReduceThreads;
  const long long cap = 4LL * num_sms();
  return (unsigned int)(blocks > cap ? cap : blocks);
}

}  // namespace gemm_tile
