// Tiled matrix product with float32 sums, C = A @ B or C = A^T @ B: the GEMM under the
// backward of every 2-D convolution (K3).
//
// Replaces the TPU kernel `_matmul` in mxnet_tpu/ops/pallas_kernels.py (:319), which
// `conv_dgrad` (dx = patches(g~) @ w~) and `conv_wgrad` (gw = patches(x)^T @ g) run
// inside `conv2d`'s VJP. On the port's training path it runs 105 times a ResNet-50
// step: 53 weight gradients and 52 input gradients (the stem's data input needs none).
//
// Two mainloops, by operand type; accumulator and output are float32 in both, as
// `preferred_element_type=jnp.float32` has it:
//  * float32 operands (conv_gemm_kernel, the tile, mainloop and split K of gemm_tile.cuh,
//    shared with the fused linear layer, K1). What bounds it on an H100: operations. The
//    float32 contract (within 1e-6 * sum|a||b| of a float64 product) rules out one TF32
//    pass; three TF32 passes on the tensor cores (tf32x3.cuh) keep it, so the ceiling is
//    495 / 3 = 165 TFLOP/s of float32-accurate work, against 67 on the CUDA cores. A block
//    of 8 warps computes a 128 x 128 tile (128 x 64 when N <= 64), 32 along K a step,
//    through a three-stage cp.async ring; the transpose of A is folded into the tile copy;
//    ragged edges are zero-filled and masked; rows whose stride is not a multiple of 4
//    floats (the stem's M = 147) are copied 4 bytes at a time.
//  * bfloat16 or float16 operands (conv_gemm16_kernel, the mainloop of gemm_wgmma16.cuh). What bounds it:
//    bytes (a step's products move 5.4 GB for 0.64 TFLOP at 989 TFLOP/s). TMA loads into a
//    six- or eight-stage ring of BK = 64, a producer warp and two consumer warpgroups on
//    wgmma, persistent blocks over (tile, split) units; exact products, one K block's
//    products chained, then added to the sum rounded to nearest. Operands come with a
//    leading dimension (a multiple of 8 elements, for TMA's 16-byte strides).
//  * Split K for products with few output tiles and a long K (the weight gradients: M*N
//    small, K = N*HO*WO large), in chunks of at least 256: slices go to a (splits, M, N)
//    float32 scratch that a second launch sums in a fixed order. A rerun is bit-identical.
//
// Interface: plain C functions, launched on the caller's stream, allocating nothing
// and never synchronising. conv_gemm returns cudaGetLastError() after its launches;
// 0 means they were accepted.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_tile.cuh"
#include "gemm_wgmma16.cuh"

namespace {

using namespace gemm_tile;

constexpr long long kMinSplitK = 256;   // least K a split takes

// C[z] = op(A)[:, kz] @ B[kz, :] over K range kz = [z * k_chunk, (z + 1) * k_chunk) of
// blockIdx.z = z; C[z] is C itself when there is one split, else slice z of the
// scratch. A is (M, K) row-major, or (K, M) row-major when TRANS_A; B is (K, N). T is
// float: the 3xTF32 mainloop (16-bit operands take conv_gemm16_kernel).
template <typename T, int BN, bool TRANS_A>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
conv_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ C,
                 int M, int N, int K, int k_chunk) {
  static_assert(sizeof(T) == 4, "float32 operands");
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  float* Cz = C + (long long)blockIdx.z * M * N;
  const bool va = rows_aligned16(A, TRANS_A ? M : K);
  const bool vb = rows_aligned16(B, N);

  float acc[Warps<BN>::MI][Warps<BN>::NI][4];
  using S = Smem<BN, TRANS_A, true>;
  auto load = [&](float* As, float* Bs, int k0) {
    if (TRANS_A)
      copy_tile<BK, BM, S::A::stride>(As, A, M, k0, kend, m0, M, va);
    else
      copy_tile<BM, BK, S::A::stride>(As, A, K, m0, M, k0, kend, va);
    copy_tile<BK, BN, S::B::stride>(Bs, B, N, k0, kend, n0, N, vb);
  };
  mainloop<BN, TRANS_A, true>(smem, load, kbeg, kend, acc);

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

// The same product with 16-bit operands T (__nv_bfloat16, __half): gemm_wgmma16.cuh's
// mainloop over all (tile, split) units of the product, one block an SM.
template <typename T, int BN, bool TRANS_A>
__global__ void __launch_bounds__(gemm16::NT, 1)
conv_gemm16_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, float* __restrict__ C, int M,
                   int N, int K, int k_chunk, long long units) {
  extern __shared__ uint8_t smem_raw[];
  gemm16::gemm<T, BN, TRANS_A>(map_a, map_b, C, M, N, K, k_chunk, units, smem_raw);
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

template <int BN, bool TRANS_A>
cudaError_t launch_gemm(const void* a, const void* b, float* out, int m, int n, int k,
                        int k_chunk, int splits, cudaStream_t stream) {
  constexpr size_t smem = Smem<BN, TRANS_A, true>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(conv_gemm_kernel<float, BN, TRANS_A>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned int)((n + BN - 1) / BN), (unsigned int)((m + BM - 1) / BM),
                  (unsigned int)splits);
  conv_gemm_kernel<float, BN, TRANS_A><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), out, m, n, k, k_chunk);
  return cudaSuccess;
}

template <int BN>
cudaError_t launch_f32(const void* a, const void* b, float* out, int m, int n, int k,
                       bool trans_a, int k_chunk, int splits, cudaStream_t stream) {
  return trans_a ? launch_gemm<BN, true>(a, b, out, m, n, k, k_chunk, splits, stream)
                 : launch_gemm<BN, false>(a, b, out, m, n, k, k_chunk, splits, stream);
}

// conv_gemm16_kernel over all (tile, split) units of an (m, n, k) product into out ((splits,
// m, n) when splits > 1). a is (m, k), or (k, m) when TRANS_A, with leading dimension lda;
// b is (k, n) with leading dimension ldb.
template <typename T, int BN, bool TRANS_A>
cudaError_t launch_gemm16(const void* a, const void* b, float* out, long long m, long long n,
                          long long k, long long lda, long long ldb, long long k_chunk,
                          int splits, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  CUtensorMap ma, mb;
  cudaError_t err = TRANS_A ? gemm16::make_map(&ma, f16, a, k, m, lda, gemm16::BK)
                            : gemm16::make_map(&ma, f16, a, m, k, lda, gemm16::BM);
  if (err != cudaSuccess) return err;
  err = gemm16::make_map(&mb, f16, b, k, n, ldb, gemm16::BK);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = gemm16::Ring<BN>::bytes;
  err = cudaFuncSetAttribute(conv_gemm16_kernel<T, BN, TRANS_A>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long units =
      ((m + gemm16::BM - 1) / gemm16::BM) * ((n + BN - 1) / BN) * splits;
  const long long sms = num_sms();
  const unsigned int grid = (unsigned int)(units < sms ? units : sms);
  conv_gemm16_kernel<T, BN, TRANS_A><<<grid, gemm16::NT, smem, stream>>>(
      ma, mb, out, (int)m, (int)n, (int)k, (int)k_chunk, units);
  return cudaSuccess;
}

template <typename T, int BN>
cudaError_t launch_16(const void* a, const void* b, float* out, long long m, long long n,
                      long long k, long long lda, long long ldb, bool trans_a,
                      long long k_chunk, int splits, cudaStream_t stream) {
  return trans_a ? launch_gemm16<T, BN, true>(a, b, out, m, n, k, lda, ldb, k_chunk, splits,
                                              stream)
                 : launch_gemm16<T, BN, false>(a, b, out, m, n, k, lda, ldb, k_chunk, splits,
                                               stream);
}

template <typename T>
cudaError_t launch_typed16(const void* a, const void* b, float* out, long long m, long long n,
                           long long k, long long lda, long long ldb, bool trans_a,
                           long long k_chunk, int splits, cudaStream_t stream) {
  return tile_n(n) == 64
             ? launch_16<T, 64>(a, b, out, m, n, k, lda, ldb, trans_a, k_chunk, splits, stream)
             : launch_16<T, 128>(a, b, out, m, n, k, lda, ldb, trans_a, k_chunk, splits,
                                 stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The K range each split of an (m, n, k) product with float32 operands takes on the
// current device, a multiple of 32: k rounded up when the product has enough output
// tiles to fill the card. The caller runs ceil(k / k_chunk) splits and, for more than
// one, allocates a (splits, m, n) float32 scratch.
extern "C" long long conv_gemm_k_chunk(long long m, long long n, long long k) {
  return k_chunk(m, n, k, kMinSplitK);
}

// The same for 16-bit operands, by the 16-bit mainloop's own rule: gemm_wgmma16.cuh's
// cost model of its persistent units (gemm16::k_chunk), a multiple of 64 (its K block).
extern "C" long long conv_gemm16_k_chunk(long long m, long long n, long long k) {
  return gemm16::k_chunk(m, n, k, kMinSplitK);
}

// a: (m, k) row-major, or (k, m) when trans_a, with leading dimension lda (elements);
// b: (k, n) row-major with leading dimension ldb; both float32 (dtype 0), bfloat16
// (dtype 1) or float16 (dtype 2). float32 operands are contiguous (lda the row's length,
// ldb = n); 16-bit ones 16-byte aligned with lda and ldb multiples of 8. c: (m, n) float32
// output. k_chunk as conv_gemm_k_chunk (float32) or conv_gemm16_k_chunk (16-bit) gives it
// and splits = ceil(k / k_chunk); ws: (splits, m, n) float32 scratch when splits > 1,
// else unused (may be null).
extern "C" int conv_gemm(const void* a, const void* b, void* c, void* ws, long long m,
                         long long n, long long k, long long lda, long long ldb, int trans_a,
                         int dtype, long long k_chunk, int splits, void* stream) {
  const long long lim = 0x7fffffffLL;
  const long long row_a = trans_a ? m : k;
  if (m <= 0 || n <= 0 || k <= 0 || m > lim || n > lim || k > lim || dtype < 0 || dtype > 2 ||
      k_chunk <= 0 || splits < 1 || splits > kMaxSplits ||
      (k + k_chunk - 1) / k_chunk != splits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 ? (k_chunk % BK != 0 || lda != row_a || ldb != n || (m + BM - 1) / BM > 65535)
                 : (k_chunk % gemm16::BK != 0 || lda < row_a || ldb < n || lda % 8 != 0 ||
                    ldb % 8 != 0 || !aligned16(a) || !aligned16(b)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(c);
  const bool ta = trans_a != 0;
  const cudaError_t err =
      dtype == 0
          ? (tile_n(n) == 64
                 ? launch_f32<64>(a, b, out, (int)m, (int)n, (int)k, ta, (int)k_chunk, splits, s)
                 : launch_f32<128>(a, b, out, (int)m, (int)n, (int)k, ta, (int)k_chunk, splits,
                                   s))
      : dtype == 1 ? launch_typed16<__nv_bfloat16>(a, b, out, m, n, k, lda, ldb, ta, k_chunk,
                                                   splits, s)
                   : launch_typed16<__half>(a, b, out, m, n, k, lda, ldb, ta, k_chunk, splits, s);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long mn = m * n;
    conv_gemm_splitk_reduce_kernel<<<reduce_blocks(mn), kReduceThreads, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(c), mn, splits);
  }
  return (int)cudaGetLastError();
}
