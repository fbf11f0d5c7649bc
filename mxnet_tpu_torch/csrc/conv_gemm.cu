// Tiled matrix product with float32 accumulation, C = A @ B or C = A^T @ B: the GEMM
// under the backward of every 2-D convolution (K3).
//
// Replaces the TPU kernel `_matmul` in mxnet_tpu/ops/pallas_kernels.py (:319), which
// `conv_dgrad` (dx = patches(g~) @ w~) and `conv_wgrad` (gw = patches(x)^T @ g) run
// inside `conv2d`'s VJP. On the port's training path it runs 105 times a ResNet-50
// step: 53 weight gradients and 52 input gradients (the stem's data input needs none).
//
// What bounds it on an H100: operations. The products of a ResNet-50 step are
// large (K of 64 to 401,408, M*N of 10^4 to 2.6*10^7) and reuse every loaded value
// BM or BN times, far above the float32 ridge point; this kernel runs on the CUDA
// cores, so its ceiling is the 67 TFLOP/s float32 rate, not the tensor cores'
// (wgmma with TMA is later work).
//
// What the design does (the tile, the double-buffered mainloop and split K are
// gemm_tile.cuh's, shared with the fused linear layer, K1):
//  * A block computes a BM x BN tile of C (128 x 128, or 128 x 64 when N <= 64, as
//    ResNet's 64-channel layers have it); each thread an 8 x 8 register tile, 64 fused
//    multiply-adds a step of BK = 8 along K.
//  * The transpose of A is folded into the tile load: for A^T @ B the tile is read
//    along A's rows, which are C's M axis, so the loads stay coalesced and A^T is
//    never materialised, as `_matmul` never materialises it. Shared memory holds A
//    k-major in both cases, padded by 4 floats a row against bank conflicts; B is
//    read along its rows (N) and stored as it lies.
//  * __launch_bounds__ asks for two blocks a SM, which holds a 256-thread block to
//    128 registers a thread (no spills): 16 resident warps instead of 8 hide more
//    of the load latency.
//  * Ragged M, N and K edges are masked in the loads (zeros) and in the stores:
//    there is no 128-multiple condition as in the TPU kernel.
//  * Split K for products with few output tiles and a long K (the weight
//    gradients: M*N small, K = N*HO*WO large), in chunks of at least 256.
//  * Operands float32 or bfloat16 (widened to float32 on the way into shared
//    memory; a bfloat16 product is exact in float32), accumulator and output
//    float32, as `preferred_element_type=jnp.float32` has it.
//
// Interface: plain C functions, launched on the caller's stream, allocating nothing
// and never synchronising. conv_gemm returns cudaGetLastError() after its launches;
// 0 means they were accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr long long kMinSplitK = 256;   // least K a split takes

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// C[z] = op(A)[:, kz] @ B[kz, :] over K range kz = [z * k_chunk, (z + 1) * k_chunk) of
// blockIdx.z = z; C[z] is C itself when there is one split, else slice z of the
// scratch. A is (M, K) row-major, or (K, M) row-major when TRANS_A; B is (K, N).
template <typename T, int BN, bool TRANS_A>
__global__ void __launch_bounds__(threads<BN>(), 2)
conv_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ C,
                 int M, int N, int K, int k_chunk) {
  constexpr int NT = threads<BN>();
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BK * BN / NT;
  __shared__ __align__(16) float As[2][BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  float* Cz = C + (long long)blockIdx.z * M * N;

  float ra[A_PER];
  float rb[B_PER];

  // global -> registers, masked to zero outside [0, M) x [kbeg, kend) x [0, N)
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      int m, k;
      if (TRANS_A) {
        k = k0 + e / BM;
        m = m0 + e % BM;
      } else {
        m = m0 + e / BK;
        k = k0 + e % BK;
      }
      float v = 0.f;
      if (m < M && k < kend)
        v = TRANS_A ? widen(A[(long long)k * M + m]) : widen(A[(long long)m * K + k]);
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      const int k = k0 + e / BN;
      const int n = n0 + e % BN;
      rb[i] = (n < N && k < kend) ? widen(B[(long long)k * N + n]) : 0.f;
    }
  };
  // registers -> shared buffer `buf`, A k-major
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      if (TRANS_A)
        As[buf][e / BM][e % BM] = ra[i];
      else
        As[buf][e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      Bs[buf][e / BN][e % BN] = rb[i];
    }
  };

  float acc[TM][TN];
  mainloop<BN, 0>(As, Bs, load, store, kbeg, kend, tx, ty, acc);

  const bool vec4 = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tile_row(i, ty);
    if (m >= M) continue;
    float* crow = Cz + (long long)m * N;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int n = n0 + tile_col<BN>(j, tx);
      if (vec4 && n + 3 < N) {
        *reinterpret_cast<float4*>(crow + n) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (n + jj < N) crow[n + jj] = acc[i][j + jj];
      }
    }
  }
}

struct RawSum {
  __device__ __forceinline__ float operator()(float s, long long) const { return s; }
};

// C[i] = sum over z of ws[z][i], z in order.
__global__ void __launch_bounds__(kReduceThreads)
conv_gemm_splitk_reduce_kernel(const float* __restrict__ ws, float* __restrict__ C, long long mn,
                               int splits) {
  splitk_reduce(ws, C, mn, splits, RawSum());
}

template <typename T, int BN>
void launch_gemm(const void* a, const void* b, float* out, int m, int n, int k, bool trans_a,
                 int k_chunk, int splits, cudaStream_t stream) {
  constexpr int NT = threads<BN>();
  const dim3 grid((unsigned int)((n + BN - 1) / BN), (unsigned int)((m + BM - 1) / BM),
                  (unsigned int)splits);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  if (trans_a)
    conv_gemm_kernel<T, BN, true><<<grid, NT, 0, stream>>>(A, B, out, m, n, k, k_chunk);
  else
    conv_gemm_kernel<T, BN, false><<<grid, NT, 0, stream>>>(A, B, out, m, n, k, k_chunk);
}

template <typename T>
void launch_typed(const void* a, const void* b, float* out, int m, int n, int k, bool trans_a,
                  int k_chunk, int splits, cudaStream_t stream) {
  if (tile_n(n) == 64)
    launch_gemm<T, 64>(a, b, out, m, n, k, trans_a, k_chunk, splits, stream);
  else
    launch_gemm<T, 128>(a, b, out, m, n, k, trans_a, k_chunk, splits, stream);
}

}  // namespace

// The K range each split of an (m, n, k) product takes on the current device, a
// multiple of 8: k rounded up when the product has enough output tiles to fill the
// card. The caller runs ceil(k / k_chunk) splits and, for more than one, allocates
// a (splits, m, n) float32 scratch.
extern "C" long long conv_gemm_k_chunk(long long m, long long n, long long k) {
  return k_chunk(m, n, k, kMinSplitK);
}

// a: (m, k) row-major, or (k, m) when trans_a; b: (k, n) row-major; both float32
// (dtype 0) or bfloat16 (dtype 1), contiguous. c: (m, n) float32 output. k_chunk as
// conv_gemm_k_chunk gives it and splits = ceil(k / k_chunk); ws: (splits, m, n)
// float32 scratch when splits > 1, else unused (may be null).
extern "C" int conv_gemm(const void* a, const void* b, void* c, void* ws, long long m,
                         long long n, long long k, int trans_a, int dtype, long long k_chunk,
                         int splits, void* stream) {
  const long long lim = 0x7fffffffLL;
  if (m <= 0 || n <= 0 || k <= 0 || m > lim || n > lim || k > lim || (dtype != 0 && dtype != 1) ||
      k_chunk <= 0 || k_chunk % BK != 0 || splits < 1 || splits > kMaxSplits ||
      (k + k_chunk - 1) / k_chunk != splits || (splits > 1 && ws == nullptr) ||
      (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(c);
  if (dtype == 0)
    launch_typed<float>(a, b, out, (int)m, (int)n, (int)k, trans_a != 0, (int)k_chunk, splits, s);
  else
    launch_typed<__nv_bfloat16>(a, b, out, (int)m, (int)n, (int)k, trans_a != 0, (int)k_chunk,
                                splits, s);
  if (splits > 1) {
    const long long mn = m * n;
    conv_gemm_splitk_reduce_kernel<<<reduce_blocks(mn), kReduceThreads, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(c), mn, splits);
  }
  return (int)cudaGetLastError();
}
