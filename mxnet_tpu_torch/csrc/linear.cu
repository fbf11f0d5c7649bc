// Fused linear layer at float32 accuracy: out = act(x @ w^T + b), act none, relu, tanh or
// sigmoid (K1).
//
// Replaces the TPU kernel `_linear_call` in mxnet_tpu/ops/pallas_kernels.py (:56), which the
// public `fused_linear` runs (FullyConnected stays on a plain matrix product in both
// packages). x is (M, K) and w is (N, K) row-major, the framework's weight layout, so the
// product reads both operands along K.
//
// What bounds it on an H100: operations for a layer with many rows (8192 x 4096 x 4096 is
// 275 GFLOP against 0.3 GB), bytes for a classifier head at a small batch (32 x 2048 -> 1000
// reads an 8 MB weight for 131 MFLOP), and for a small layer (128 x 256 -> 128: 8.4 MFLOP
// over 0.3 MB) neither: latency, of the launch, of the first loads and of the sum across
// blocks. The float32 contract (within 1e-6 of sum|x||w| + |b|) takes three TF32 products a
// fragment on the tensor cores (tf32x3.cuh), so its ceilings are 495 / 3 = 165 TFLOP/s and
// 3.35 TB/s.
//
// What the design does: the tiled tensor-core GEMM of the convolution-backward GEMM (K3),
// whose tile and cp.async mainloop live in gemm_tile.cuh, with this layer's operand feed and
// epilogue, in one launch at every shape.
//  * A layer with at least two thirds of a wave of wide tiles (one block an SM) takes K3's
//    tile: 8 warps, 128 x 128 (128 x 64 when N <= 64), 32 along K a step, three stages in
//    flight, K not split.
//  * A smaller layer takes a narrow tile, 32 x 64 by 4 warps of 16 x 32: a small layer is
//    latency-bound, and a warp's serial chain of products is a quarter of the wide tile's.
//    A narrow tile splits more fragments for each product, so an SM full of narrow blocks
//    does about three quarters of the wide tile's work a second: it pays only while the wide
//    tiles would leave a third of the SMs or more idle. More blocks share the output before K
//    is split; K is then split so that the blocks fill about one wave, each split at least 64
//    long, at most 8 splits. The splits of a
//    tile are one thread block cluster (Hopper): each keeps its raw partial tile in its own
//    shared memory, and after the cluster's barrier each split sums a slice of the tile's
//    rows over the cluster's shared memories in the order z = 0, 1, ..., applies the
//    epilogue once and writes out. No scratch in device memory, no atomics, no second
//    launch; the order does not depend on the blocks' timing, so a rerun is bit-identical,
//    and equal to a two-launch sum of the same splits.
//  * Both tiles are copied along K (rows of x, rows of w) and lie [row][k] in shared memory,
//    where ldmatrix reads their fragments: w^T is never materialised.
//  * Ragged M, N and K edges are zero-filled (no stores out): any shape, where the TPU
//    kernel takes only multiples of 128. A K that is not a multiple of 4 floats is copied
//    4 bytes at a time.
//  * The epilogue adds the bias and applies the activation (tanhf, and 1 / (1 + expf(-v))
//    for the sigmoid, compiled without fast math) once, on the finished sum.
//
// Interface: plain C functions, launched on the caller's stream, allocating nothing and
// never synchronising. linear_fwd returns cudaGetLastError() after its launch, 0 when it was
// accepted.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr long long kMinSplitK = 64;  // least K a split takes
// the narrow tile of a layer with less than a wave of wide tiles
constexpr int kNarrowM = 32, kNarrowN = 64, kNarrowWarps = 4;
constexpr int kMaxClusterSplits = 8;  // splits of a tile: a cluster of at most 8 (portable)

enum Act { kNone = 0, kRelu = 1, kTanh = 2, kSigmoid = 3 };

__device__ __forceinline__ float epilogue(float acc, const float* __restrict__ bias, int n,
                                          int act) {
  const float v = bias != nullptr ? acc + bias[n] : acc;
  switch (act) {
    case kRelu:
      return v < 0.f ? 0.f : v;  // NaN passes through, as jnp.maximum(v, 0) has it
    case kTanh:
      return tanhf(v);
    case kSigmoid:
      return 1.f / (1.f + expf(-v));
    default:
      return v;
  }
}

// out = act(x @ w^T + b) for the TM x BN tile of block (x, y), NW warps. Split z = blockIdx.z
// of gridDim.z takes K range [z * k_chunk, (z + 1) * k_chunk). With more than one split
// (SPLIT), the splits of a tile are one thread block cluster (1, 1, splits), so z is also the
// block's rank in its cluster: each split puts its raw partial tile in its shared memory, and
// after the cluster's barrier each split sums a slice of the tile's rows over the cluster's
// shared memories, in the order z = 0, 1, ..., and writes them out.
template <int TM, int BN, int NW, bool SPLIT>
__global__ void __launch_bounds__(NW * 32, MIN_BLOCKS)
linear_kernel(const float* __restrict__ X, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
              int k_chunk, int act) {
  using S = Smem<BN, false, false, TM>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.z, splits = gridDim.z;
  const int kbeg = z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const bool vx = rows_aligned16(X, K);
  const bool vw = rows_aligned16(W, K);

  auto load = [&](float* Xs, float* Ws, int k0) {
    copy_tile<TM, BK, S::A::stride, NW * 32>(Xs, X, K, m0, M, k0, kend, vx);
    copy_tile<BN, BK, S::B::stride, NW * 32>(Ws, W, K, n0, N, k0, kend, vw);
  };

  float acc[Warps<BN, TM, NW>::MI][Warps<BN, TM, NW>::NI][4];
  mainloop<BN, false, false, false, TM, NW>(smem, load, kbeg, kend, acc);

  if constexpr (SPLIT) {
    if (splits > 1) {
      constexpr int PS = BN + 4;  // row stride of the partial tile in shared memory
      static_assert(TM * PS <= STAGES * S::stage, "the partial does not fit in the stages");
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      float* part = smem;
      __syncthreads();  // every warp is done with the stages, which now hold the partial
      for_each_pair<BN, TM, NW>(acc, 0, 0, [&](int m, int n, float v0, float v1) {
        part[m * PS + n] = v0;
        part[m * PS + n + 1] = v1;
      });
      cluster.sync();  // every split's partial is in its shared memory
      const float* parts[kMaxClusterSplits];
#pragma unroll
      for (int j = 0; j < kMaxClusterSplits; ++j)
        parts[j] = cluster.map_shared_rank(part, j < splits ? j : 0);
      const int rows = (TM + splits - 1) / splits;
      const int r0 = z * rows, r1 = min(TM, r0 + rows);
#pragma unroll 4
      for (int e = threadIdx.x; e < (r1 - r0) * BN; e += NW * 32) {
        const int m = r0 + e / BN, n = e % BN;
        float v[kMaxClusterSplits];
#pragma unroll
        for (int j = 0; j < kMaxClusterSplits; ++j)
          v[j] = j < splits ? parts[j][m * PS + n] : 0.f;
        float sum = v[0];
#pragma unroll
        for (int j = 1; j < kMaxClusterSplits; ++j)
          if (j < splits) sum = __fadd_rn(sum, v[j]);
        if (m0 + m < M && n0 + n < N)
          out[(long long)(m0 + m) * N + n0 + n] = epilogue(sum, bias, n0 + n, act);
      }
      cluster.sync();  // no split leaves while another still reads its shared memory
      return;
    }
  }

  for_each_pair<BN, TM, NW>(acc, m0, n0, [&](int m, int n, float v0, float v1) {
    if (m >= M) return;
    float* orow = out + (long long)m * N;
    if (n < N) orow[n] = epilogue(v0, bias, n, act);
    if (n + 1 < N) orow[n + 1] = epilogue(v1, bias, n + 1, act);
  });
}

// One launch of linear_kernel over (n / BN, m / TM, splits) blocks, the splits of a tile one
// cluster.
template <int TM, int BN, int NW, bool SPLIT>
cudaError_t launch(const float* x, const float* w, const float* b, float* out, int m, int n,
                   int k, int k_chunk, int splits, int act, cudaStream_t stream) {
  constexpr size_t smem = Smem<BN, false, false, TM>::bytes;
  auto kernel = linear_kernel<TM, BN, NW, SPLIT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)((n + BN - 1) / BN), (unsigned int)((m + TM - 1) / TM),
                     (unsigned int)splits);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = (unsigned int)splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, b, out, m, n, k, k_chunk, act);
}

// Whether an (m, n) layer has at least two thirds of a wave of wide tiles on the current
// device, and so takes them.
bool wide(long long m, long long n) {
  const long long tiles = ((m + BM - 1) / BM) * ((n + tile_n(n) - 1) / tile_n(n));
  return 3 * tiles >= 2LL * MIN_BLOCKS * num_sms();
}

long long narrow_tiles(long long m, long long n) {
  return ((m + kNarrowM - 1) / kNarrowM) * ((n + kNarrowN - 1) / kNarrowN);
}

}  // namespace

// The K range each split of an (m, n, k) layer takes on the current device, a multiple of
// 32: k rounded up (one split) for a layer that takes wide tiles; otherwise narrow tiles
// with K split into as many ranges as fill about one wave of one block an SM, between one
// and k / 64 (at most 8, a portable cluster) of them. The caller runs ceil(k / k_chunk)
// splits.
extern "C" long long linear_k_chunk(long long m, long long n, long long k) {
  if (m <= 0 || n <= 0 || k <= 0) return BK;
  long long splits = 1;
  if (!wide(m, n)) {
    const long long most = k / kMinSplitK < kMaxClusterSplits ? k / kMinSplitK
                                                              : kMaxClusterSplits;
    splits = num_sms() / narrow_tiles(m, n);
    if (splits > most) splits = most;
    if (splits < 1) splits = 1;
  }
  const long long per = (k + splits - 1) / splits;
  return (per + BK - 1) / BK * BK;
}

// x: (m, k), w: (n, k), b: (n,) or null, out: (m, n), all float32, contiguous. act: 0 none,
// 1 relu, 2 tanh, 3 sigmoid. k_chunk as linear_k_chunk gives it and splits =
// ceil(k / k_chunk).
extern "C" int linear_fwd(const void* x, const void* w, const void* b, void* out, long long m,
                          long long n, long long k, int act, long long k_chunk, int splits,
                          void* stream) {
  const long long lim = 0x7fffffffLL;
  if (m <= 0 || n <= 0 || k <= 0 || m > lim || n > lim || k > lim || act < kNone ||
      act > kSigmoid || k_chunk <= 0 || k_chunk % BK != 0 || splits < 1 ||
      splits > kMaxClusterSplits || (k + k_chunk - 1) / k_chunk != splits ||
      (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const bool is_wide = wide(m, n);
  if (splits > 1 && is_wide) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* X = static_cast<const float*>(x);
  const float* W = static_cast<const float*>(w);
  const float* B = static_cast<const float*>(b);
  float* O = static_cast<float*>(out);
  const int M = (int)m, N = (int)n, K = (int)k, C = (int)k_chunk;
  cudaError_t err;
  if (!is_wide)
    err = launch<kNarrowM, kNarrowN, kNarrowWarps, true>(X, W, B, O, M, N, K, C, splits, act, s);
  else if (tile_n(n) == 64)
    err = launch<BM, 64, 8, false>(X, W, B, O, M, N, K, C, 1, act, s);
  else
    err = launch<BM, 128, 8, false>(X, W, B, O, M, N, K, C, 1, act, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
