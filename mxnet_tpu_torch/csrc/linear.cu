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
// reads an 8 MB weight for 131 MFLOP). The float32 contract (within 1e-6 of sum|x||w| + |b|)
// takes three TF32 products a fragment on the tensor cores (tf32x3.cuh), so its ceilings are
// 495 / 3 = 165 TFLOP/s and 3.35 TB/s.
//
// What the design does: the tiled tensor-core GEMM of the convolution-backward GEMM (K3),
// whose tile, cp.async mainloop and split-K rule and sum live in gemm_tile.cuh, with this
// layer's operand feed and epilogue.
//  * A block of 8 warps computes a BM x BN tile of the output (128 x 128, or 128 x 64 when
//    N <= 64), 32 along K a step, three stages in flight.
//  * Both tiles are copied along K (rows of x, rows of w) and lie [row][k] in shared memory,
//    where ldmatrix reads their fragments: w^T is never materialised.
//  * Ragged M, N and K edges are zero-filled (no stores out): any shape, where the TPU
//    kernel takes only multiples of 128. A K that is not a multiple of 4 floats is copied
//    4 bytes at a time.
//  * The epilogue adds the bias and applies the activation (tanhf, and 1 / (1 + expf(-v))
//    for the sigmoid, compiled without fast math) once, on the finished sum.
//  * Split K when the layer has fewer output tiles than twice the SMs (a classifier head at
//    a small batch): one block walking all of K alone is latency-bound, so K goes in chunks
//    of at least 64; each split writes its raw partial tile to a (splits, M, N) scratch and
//    the reduce kernel sums the splits in a fixed order and only then applies the epilogue.
//    No atomics: a rerun is bit-identical.
//
// Interface: plain C functions, launched on the caller's stream, allocating nothing and
// never synchronising. linear_fwd returns cudaGetLastError() after its launches, 0 when
// they were accepted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr long long kMinSplitK = 64;   // least K a split takes

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

// Out[z] = x[:, kz] @ w[:, kz]^T over K range kz = [z * k_chunk, (z + 1) * k_chunk) of
// blockIdx.z = z. With EPI the tile is final (one split): bias and act are applied and
// it goes to `out`; without, the raw partial goes to slice z of the scratch `out`.
template <int BN, bool EPI>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
linear_kernel(const float* __restrict__ X, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
              int k_chunk, int act) {
  using S = Smem<BN, false, false>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  float* Oz = out + (EPI ? 0LL : (long long)blockIdx.z * M * N);
  const bool vx = rows_aligned16(X, K);
  const bool vw = rows_aligned16(W, K);

  auto load = [&](float* Xs, float* Ws, int k0) {
    copy_tile<BM, BK, S::A::stride>(Xs, X, K, m0, M, k0, kend, vx);
    copy_tile<BN, BK, S::B::stride>(Ws, W, K, n0, N, k0, kend, vw);
  };

  float acc[Warps<BN>::MI][Warps<BN>::NI][4];
  mainloop<BN, false, false, false>(smem, load, kbeg, kend, acc);

  for_each_pair<BN>(acc, m0, n0, [&](int m, int n, float v0, float v1) {
    if (m >= M) return;
    float* orow = Oz + (long long)m * N;
    if (n < N) orow[n] = EPI ? epilogue(v0, bias, n, act) : v0;
    if (n + 1 < N) orow[n + 1] = EPI ? epilogue(v1, bias, n + 1, act) : v1;
  });
}

struct BiasAct {
  const float* bias;
  int n;
  int act;
  __device__ __forceinline__ float operator()(float s, long long i) const {
    return epilogue(s, bias, (int)(i % n), act);
  }
};

// out[i] = act(sum over z of ws[z][i], z in order, + bias[i % n])
__global__ void __launch_bounds__(kReduceThreads)
linear_splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                            float* __restrict__ out, long long mn, int n, int splits, int act) {
  splitk_reduce(ws, out, mn, splits, BiasAct{bias, n, act});
}

template <int BN>
cudaError_t launch_tiles(const float* x, const float* w, const float* b, float* out, float* ws,
                         int m, int n, int k, int k_chunk, int splits, int act,
                         cudaStream_t stream) {
  constexpr size_t smem = Smem<BN, false, false>::bytes;
  const dim3 grid((unsigned int)((n + BN - 1) / BN), (unsigned int)((m + BM - 1) / BM),
                  (unsigned int)splits);
  cudaError_t err;
  if (splits == 1) {
    err = cudaFuncSetAttribute(linear_kernel<BN, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      linear_kernel<BN, true><<<grid, NT, smem, stream>>>(x, w, b, out, m, n, k, k_chunk, act);
  } else {
    err = cudaFuncSetAttribute(linear_kernel<BN, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      linear_kernel<BN, false><<<grid, NT, smem, stream>>>(x, w, b, ws, m, n, k, k_chunk, act);
  }
  return err;
}

}  // namespace

// The K range each split of an (m, n, k) layer takes on the current device, a multiple of
// 32: k rounded up when the layer has enough output tiles to fill the card. The caller runs
// ceil(k / k_chunk) splits and, for more than one, allocates a (splits, m, n) float32
// scratch.
extern "C" long long linear_k_chunk(long long m, long long n, long long k) {
  return k_chunk(m, n, k, kMinSplitK);
}

// x: (m, k), w: (n, k), b: (n,) or null, out: (m, n), all float32, contiguous. act: 0 none,
// 1 relu, 2 tanh, 3 sigmoid. k_chunk as linear_k_chunk gives it and splits =
// ceil(k / k_chunk); ws: (splits, m, n) float32 scratch when splits > 1, else unused.
extern "C" int linear_fwd(const void* x, const void* w, const void* b, void* out, void* ws,
                          long long m, long long n, long long k, int act, long long k_chunk,
                          int splits, void* stream) {
  const long long lim = 0x7fffffffLL;
  if (m <= 0 || n <= 0 || k <= 0 || m > lim || n > lim || k > lim || act < kNone ||
      act > kSigmoid || k_chunk <= 0 || k_chunk % BK != 0 || splits < 1 ||
      splits > kMaxSplits || (k + k_chunk - 1) / k_chunk != splits ||
      (splits > 1 && ws == nullptr) || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* X = static_cast<const float*>(x);
  const float* W = static_cast<const float*>(w);
  const float* B = static_cast<const float*>(b);
  float* O = static_cast<float*>(out);
  float* WS = static_cast<float*>(ws);
  const cudaError_t err =
      tile_n(n) == 64
          ? launch_tiles<64>(X, W, B, O, WS, (int)m, (int)n, (int)k, (int)k_chunk, splits, act, s)
          : launch_tiles<128>(X, W, B, O, WS, (int)m, (int)n, (int)k, (int)k_chunk, splits, act,
                              s);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long mn = m * n;
    linear_splitk_reduce_kernel<<<reduce_blocks(mn), kReduceThreads, 0, s>>>(
        WS, B, O, mn, (int)n, splits, act);
  }
  return (int)cudaGetLastError();
}
