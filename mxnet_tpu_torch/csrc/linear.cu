// Fused linear layer in float32: out = act(x @ w^T + b), act none, relu, tanh or sigmoid (K1).
//
// Replaces the TPU kernel `_linear_call` in mxnet_tpu/ops/pallas_kernels.py (:56), which the
// public `fused_linear` runs (FullyConnected stays on a plain matrix product in both
// packages). x is (M, K) and w is (N, K) row-major, the framework's weight layout, so the
// product reads both operands along K.
//
// What bounds it on an H100: operations for a layer with many rows (8192 x 4096 x 4096 is
// 275 GFLOP against 0.3 GB), bytes for a classifier head at a small batch (32 x 2048 -> 1000
// reads an 8 MB weight for 131 MFLOP). It runs on the CUDA cores in float32, as the TPU
// kernel accumulates in float32, so its ceilings are 67 TFLOP/s and 3.35 TB/s.
//
// What the design does: the tiled float32 GEMM of the convolution-backward GEMM (K3), whose
// tile, double-buffered mainloop and split-K rule and sum live in gemm_tile.cuh, with this
// layer's operand feed and epilogue.
//  * A block computes a BM x BN tile of the output (128 x 128, or 128 x 64 when N <= 64).
//  * Both tiles are read from global memory along K (rows of x, rows of w) and stored
//    k-major in shared memory, padded by 4 floats a row: w^T is folded into the tile load
//    and never materialised.
//  * Ragged M, N and K edges are masked (zeros in, no stores out): any shape, where the TPU
//    kernel takes only multiples of 128.
//  * The epilogue adds the bias and applies the activation (tanhf, and 1 / (1 + expf(-v))
//    for the sigmoid, compiled without fast math) once, on the finished sum.
//  * Split K when the layer has fewer output tiles than twice the SMs (a classifier head at
//    a small batch): one block walking all of K alone is latency-bound (~1.6 us a step of
//    8 on an H100), so K goes in chunks of at least 64; each split writes its raw partial
//    tile to a (splits, M, N) scratch and the reduce kernel sums the splits in a fixed order
//    and only then applies the epilogue. No atomics: a rerun is bit-identical.
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

constexpr int W_PAD = 4;               // floats a k-row of w's shared tile is padded by
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
__global__ void __launch_bounds__(threads<BN>(), 2)
linear_kernel(const float* __restrict__ X, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
              int k_chunk, int act) {
  constexpr int NT = threads<BN>();
  constexpr int X_PER = BM * BK / NT;
  constexpr int W_PER = BN * BK / NT;
  __shared__ __align__(16) float Xs[2][BK][BM + A_PAD];
  __shared__ __align__(16) float Ws[2][BK][BN + W_PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  float* Oz = out + (EPI ? 0LL : (long long)blockIdx.z * M * N);

  float rx[X_PER];
  float rw[W_PER];

  // global -> registers along K, masked to zero outside the operands
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int e = tid + i * NT;
      const int m = m0 + e / BK;
      const int k = k0 + e % BK;
      rx[i] = (m < M && k < kend) ? X[(long long)m * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int e = tid + i * NT;
      const int n = n0 + e / BK;
      const int k = k0 + e % BK;
      rw[i] = (n < N && k < kend) ? W[(long long)n * K + k] : 0.f;
    }
  };
  // registers -> shared buffer `buf`, both k-major
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int e = tid + i * NT;
      Xs[buf][e % BK][e / BK] = rx[i];
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int e = tid + i * NT;
      Ws[buf][e % BK][e / BK] = rw[i];
    }
  };

  float acc[TM][TN];
  mainloop<BN, W_PAD>(Xs, Ws, load, store, kbeg, kend, tx, ty, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tile_row(i, ty);
    if (m >= M) continue;
    float* orow = Oz + (long long)m * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tile_col<BN>(j, tx);
      if (n < N) orow[n] = EPI ? epilogue(acc[i][j], bias, n, act) : acc[i][j];
    }
  }
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
void launch_tiles(const float* x, const float* w, const float* b, float* out, float* ws, int m,
                  int n, int k, int k_chunk, int splits, int act, cudaStream_t stream) {
  constexpr int NT = threads<BN>();
  const dim3 grid((unsigned int)((n + BN - 1) / BN), (unsigned int)((m + BM - 1) / BM),
                  (unsigned int)splits);
  if (splits == 1)
    linear_kernel<BN, true><<<grid, NT, 0, stream>>>(x, w, b, out, m, n, k, k_chunk, act);
  else
    linear_kernel<BN, false><<<grid, NT, 0, stream>>>(x, w, b, ws, m, n, k, k_chunk, act);
}

}  // namespace

// The K range each split of an (m, n, k) layer takes on the current device, a multiple of
// 8: k rounded up when the layer has enough output tiles to fill the card. The caller runs
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
  if (tile_n(n) == 64)
    launch_tiles<64>(X, W, B, O, WS, (int)m, (int)n, (int)k, (int)k_chunk, splits, act, s);
  else
    launch_tiles<128>(X, W, B, O, WS, (int)m, (int)n, (int)k, (int)k_chunk, splits, act, s);
  if (splits > 1) {
    const long long mn = m * n;
    linear_splitk_reduce_kernel<<<reduce_blocks(mn), kReduceThreads, 0, s>>>(
        WS, B, O, mn, (int)n, splits, act);
  }
  return (int)cudaGetLastError();
}
