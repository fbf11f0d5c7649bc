// Tiled matrix product at float32 accuracy, C = A @ B or C = A^T @ B: the GEMM under the
// backward of every 2-D convolution (K3).
//
// Replaces the TPU kernel `_matmul` in mxnet_tpu/ops/pallas_kernels.py (:319), which
// `conv_dgrad` (dx = patches(g~) @ w~) and `conv_wgrad` (gw = patches(x)^T @ g) run
// inside `conv2d`'s VJP. On the port's training path it runs 105 times a ResNet-50
// step: 53 weight gradients and 52 input gradients (the stem's data input needs none).
//
// What bounds it on an H100: operations. The products of a ResNet-50 step are large (K of
// 64 to 401,408, M*N of 10^4 to 2.6*10^7) and reuse every loaded value BM or BN times, far
// above the ridge point. The float32 contract (within 1e-6 * sum|a||b| of a float64 product)
// rules out one TF32 pass; three TF32 passes on the tensor cores (tf32x3.cuh) keep it, so
// the ceiling is 495 / 3 = 165 TFLOP/s of float32-accurate work, against 67 on the CUDA
// cores.
//
// What the design does (the tile, the tensor-core mainloop with its cp.async ring, and split
// K are gemm_tile.cuh's, shared with the fused linear layer, K1):
//  * A block of 8 warps computes a BM x BN tile of C (128 x 128, or 128 x 64 when N <= 64,
//    as ResNet's 64-channel layers have it), 32 along K a step, three stages in flight.
//  * The transpose of A is folded into the tile copy: for A^T @ B the tile is copied along
//    A's rows, which are C's M axis, and lies [k][m] in shared memory; A^T is never
//    materialised, as `_matmul` never materialises it. A row-major A lies [m][k], B [k][n].
//  * Ragged M, N and K edges are zero-filled by the copies and masked in the stores: there
//    is no 128-multiple condition as in the TPU kernel. Rows whose stride is not a multiple
//    of 4 floats (the stem's M = 147) are copied 4 bytes at a time.
//  * Split K for products with few output tiles and a long K (the weight gradients: M*N
//    small, K = N*HO*WO large), in chunks of at least 256.
//  * Operands float32 (three TF32 products a fragment) or bfloat16 (widened to float32 on
//    the way into shared memory; exact in TF32, so one product), accumulator and output
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

// C[z] = op(A)[:, kz] @ B[kz, :] over K range kz = [z * k_chunk, (z + 1) * k_chunk) of
// blockIdx.z = z; C[z] is C itself when there is one split, else slice z of the
// scratch. A is (M, K) row-major, or (K, M) row-major when TRANS_A; B is (K, N).
template <typename T, int BN, bool TRANS_A>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
conv_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ C,
                 int M, int N, int K, int k_chunk) {
  using S = Smem<BN, TRANS_A, true>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  float* Cz = C + (long long)blockIdx.z * M * N;
  const bool va = rows_aligned16(A, TRANS_A ? M : K);
  const bool vb = rows_aligned16(B, N);

  auto load = [&](float* As, float* Bs, int k0) {
    if (TRANS_A)
      copy_tile<BK, BM, S::A::stride>(As, A, M, k0, kend, m0, M, va);
    else
      copy_tile<BM, BK, S::A::stride>(As, A, K, m0, M, k0, kend, va);
    copy_tile<BK, BN, S::B::stride>(Bs, B, N, k0, kend, n0, N, vb);
  };

  float acc[Warps<BN>::MI][Warps<BN>::NI][4];
  mainloop<BN, TRANS_A, true, sizeof(T) == 2>(smem, load, kbeg, kend, acc);

  const bool vec2 = (N % 2) == 0;
  for_each_pair<BN>(acc, m0, n0, [&](int m, int n, float v0, float v1) {
    if (m >= M) return;
    float* p = Cz + (long long)m * N + n;
    if (vec2 && n + 1 < N) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      if (n < N) p[0] = v0;
      if (n + 1 < N) p[1] = v1;
    }
  });
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

template <typename T, int BN, bool TRANS_A>
cudaError_t launch_gemm(const void* a, const void* b, float* out, int m, int n, int k,
                        int k_chunk, int splits, cudaStream_t stream) {
  constexpr size_t smem = Smem<BN, TRANS_A, true>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(conv_gemm_kernel<T, BN, TRANS_A>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned int)((n + BN - 1) / BN), (unsigned int)((m + BM - 1) / BM),
                  (unsigned int)splits);
  conv_gemm_kernel<T, BN, TRANS_A><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, m, n, k, k_chunk);
  return cudaSuccess;
}

template <typename T, int BN>
cudaError_t launch_tile(const void* a, const void* b, float* out, int m, int n, int k,
                        bool trans_a, int k_chunk, int splits, cudaStream_t stream) {
  return trans_a ? launch_gemm<T, BN, true>(a, b, out, m, n, k, k_chunk, splits, stream)
                 : launch_gemm<T, BN, false>(a, b, out, m, n, k, k_chunk, splits, stream);
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* b, float* out, int m, int n, int k,
                         bool trans_a, int k_chunk, int splits, cudaStream_t stream) {
  return tile_n(n) == 64
             ? launch_tile<T, 64>(a, b, out, m, n, k, trans_a, k_chunk, splits, stream)
             : launch_tile<T, 128>(a, b, out, m, n, k, trans_a, k_chunk, splits, stream);
}

}  // namespace

// The K range each split of an (m, n, k) product takes on the current device, a
// multiple of 32: k rounded up when the product has enough output tiles to fill the
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
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(a, b, out, (int)m, (int)n, (int)k, trans_a != 0,
                                       (int)k_chunk, splits, s)
                 : launch_typed<__nv_bfloat16>(a, b, out, (int)m, (int)n, (int)k, trans_a != 0,
                                               (int)k_chunk, splits, s);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long mn = m * n;
    conv_gemm_splitk_reduce_kernel<<<reduce_blocks(mn), kReduceThreads, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(c), mn, splits);
  }
  return (int)cudaGetLastError();
}
