// Flash attention forward in float32: O = softmax(Q K^T * scale) V over (B*H, T, D), with an
// online softmax, so the (T, T) score matrix never reaches device memory (K2).
//
// Replaces the TPU kernel `_flash_call` in mxnet_tpu/ops/pallas_kernels.py (:154), which
// `flash_attention` runs and `ulysses_attention` (mxnet_tpu/parallel/ring_attention.py) calls
// on each rank's full-sequence, head-sharded slice.
//
// What bounds it on an H100: operations. The work is 4 * T^2 * D flops per (batch, head)
// (half of it under the causal mask) against 16 * T * D bytes of Q, K, V and O, so at the
// shapes the port runs (T of 10^3 to 10^4, D of 32 to 256) every loaded value is reused
// hundreds of times, far above the float32 ridge point. This kernel runs on the CUDA cores
// in float32, as the TPU kernel accumulates in float32, so its ceiling is the 67 TFLOP/s
// float32 rate. At D = 32 the softmax (an exp, a max and a sum per score) costs about as
// much as the two products, which do only 2 * D flops per score.
//
// What the design does:
//  * One block of 256 threads per (B*H row, 64-query tile); a loop inside the block walks
//    the key tiles in order, which takes the place of the TPU grid's sequential key axis.
//    The 64 x D query tile stays in shared memory for the whole walk.
//  * Key and value tiles of BK rows are staged in shared memory: 64 rows, or 32 at D > 128
//    so that Q, K, V and the probabilities stay near 140 KB at D = 256.
//  * Thread (ty, tx) of 16 x 16 owns query rows ty + 16 i (i < 4). For the scores it
//    computes the keys tx + 16 j of the tile, reading Q and K as 16-byte vectors along D
//    (rows padded by 4 floats, so a quarter warp's K reads fall on distinct banks); for the
//    output it owns D / 16 columns of those 4 rows, so a row is split over 16 threads and
//    its D accumulators never spill, even at D = 256.
//  * The running max m, normalizer l and the accumulators live in registers. Per tile:
//    m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new),
//    l = l * alpha + rowsum(p), acc = acc * alpha + p V, as the TPU kernel does
//    (pallas_kernels.py:193-202). Row max and row sum are reduced over the 16 threads of a
//    row with shuffles in a fixed order: one pass, no atomics, so a rerun is bit-identical.
//  * D is a template parameter (32, 64, 128, 256); any other D up to 256 runs the next
//    larger instantiation with the extra columns zero in shared memory and never stored.
//  * Causal: key tiles wholly above the diagonal are skipped; inside a tile, keys after the
//    query and keys at or beyond T get the finite mask value -1e30, as the TPU kernel's
//    where(row >= col, s, -1e30). T is any length: rows at or beyond T are computed on zeros
//    and not stored.
//
// Interface: a plain C function, launched on the caller's stream, allocating nothing and
// never synchronising; it returns cudaGetLastError() after its launch, 0 when accepted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int NT = 256;
constexpr float kMask = -1e30f;

template <int DP>
struct Cfg {
  static constexpr int BK = DP > 128 ? 32 : 64;   // key rows a tile
  static constexpr int QS = DP + 4;               // row stride of Q and K in shared memory
  static constexpr int PS = BK + 4;               // row stride of the probabilities
  static constexpr int KPT = BK / 16;             // keys a thread scores
  static constexpr int VEC = DP >= 64 ? 4 : 2;    // width of a thread's V reads
  static constexpr int CPT = DP / 16;             // output columns a thread
  static constexpr int NV = CPT / VEC;
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)(BQ * QS + BK * QS + BK * DP + BQ * PS);
};

// Output column of a thread's c-th accumulator.
template <int DP>
__device__ __forceinline__ int out_col(int tx, int c) {
  using C = Cfg<DP>;
  return C::VEC * tx + 16 * C::VEC * (c / C::VEC) + c % C::VEC;
}

template <int DP>
__global__ void __launch_bounds__(NT, DP > 64 ? 1 : 2)
flash_attn_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                  const float* __restrict__ V, float* __restrict__ O, int T, int D, float scale,
                  int causal) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * C::QS;
  float* Vs = Ks + C::BK * C::QS;
  float* Ps = Vs + C::BK * DP;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)blockIdx.y * T * D;
  const float* q = Q + base;
  const float* k = K + base;
  const float* v = V + base;

  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, c = e % DP;
    Qs[r * C::QS + c] = (q0 + r < T && c < D) ? q[(long long)(q0 + r) * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][C::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(T, q0 + BQ) : T;
  for (int k0 = 0; k0 < kend; k0 += C::BK) {
    __syncthreads();  // the previous tile's readers are done (and Q is in place)
    for (int e = tid; e < C::BK * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      const bool in = k0 + r < T && c < D;
      const long long g = (long long)(k0 + r) * D + c;
      Ks[r * C::QS + c] = in ? k[g] : 0.f;
      Vs[r * DP + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][C::KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[C::KPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * C::QS + d]);
#pragma unroll
      for (int j = 0; j < C::KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * C::QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C::KPT; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // online softmax: each row's 16 threads agree on m_new and the row sum
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool valid = kj < T && (!causal || kj <= qr);
        s[i][j] = valid ? s[i][j] * scale : kMask;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) {
        const float p = expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * C::PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = mn;
    }
    __syncthreads();

    // acc = acc * alpha + P V over the tile's keys
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[i][c] *= alpha[i];
#pragma unroll 2
    for (int j = 0; j < C::BK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * C::PS + j]);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * DP + C::VEC * tx;
        float vv[C::CPT];
#pragma unroll
        for (int n = 0; n < C::NV; ++n) {
          if constexpr (C::VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + 64 * n);
            vv[4 * n] = t.x;
            vv[4 * n + 1] = t.y;
            vv[4 * n + 2] = t.z;
            vv[4 * n + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + 32 * n);
            vv[2 * n] = t.x;
            vv[2 * n + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < C::CPT; ++c) acc[i][c] = fmaf(p[i][jj], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= T) continue;
    float* orow = O + base + (long long)r * D;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) {
      const int col = out_col<DP>(tx, c);
      if (col < D) orow[col] = acc[i][c] / l[i];
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, int bh, int t, int d,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = Cfg<DP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((t + BQ - 1) / BQ), (unsigned int)bh);
  flash_attn_kernel<DP><<<grid, NT, smem, stream>>>(q, k, v, o, t, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, t, d) float32, contiguous. o = softmax(q k^T * scale, causal) v, with the
// mask value -1e30. d <= 256; bh <= 65535 (the grid's y axis); row indices fit an int.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              long long bh, long long t, long long d, float scale, int causal,
                              void* stream) {
  if (bh <= 0 || t <= 0 || d <= 0 || d > 256 || bh > 65535 || t > 0x7fffffffLL - BQ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  float* Out = static_cast<float*>(o);
  if (d <= 32) return launch<32>(Q, K, V, Out, (int)bh, (int)t, (int)d, scale, causal, s);
  if (d <= 64) return launch<64>(Q, K, V, Out, (int)bh, (int)t, (int)d, scale, causal, s);
  if (d <= 128) return launch<128>(Q, K, V, Out, (int)bh, (int)t, (int)d, scale, causal, s);
  return launch<256>(Q, K, V, Out, (int)bh, (int)t, (int)d, scale, causal, s);
}
