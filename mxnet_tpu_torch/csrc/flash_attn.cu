// Flash attention forward at float32 accuracy: O = softmax(Q K^T * scale) V over (B, T, H, D)
// read and written by strides, with an online softmax, so the (T, T) score matrix never
// reaches device memory (K2).
//
// Replaces the TPU kernel `_flash_call` in mxnet_tpu/ops/pallas_kernels.py (:154), which
// `flash_attention` runs and `ulysses_attention` (mxnet_tpu/parallel/ring_attention.py) calls
// on each rank's full-sequence, head-sharded slice.
//
// What bounds it on an H100: operations. The work is 4 * T^2 * D flops per (batch, head)
// (half of it under the causal mask) against 16 * T * D bytes of Q, K, V and O, so at the
// shapes the port runs (T of 10^3 to 10^4, D of 32 to 256) every loaded value is reused
// hundreds of times. The float32 contract (rtol 2e-4 / atol 2e-5 of the plain version) takes
// three TF32 products a fragment on the tensor cores (tf32x3.cuh): the ceiling is 495 / 3 =
// 165 TFLOP/s of float32-accurate work. At D = 32 the softmax (an exp, a max and a sum per
// score) costs about as much as the two products, which do only 2 * D flops per score.
//
// What the design does (FlashAttention-2's form, on mma.sync):
//  * One block of 4 warps per (64-query tile, head, batch); each warp owns 16 query rows. A
//    loop inside the block walks the key tiles in order, which takes the place of the TPU
//    grid's sequential key axis. Causal blocks with the most key tiles start first.
//  * The 64 x D query tile stays in shared memory for the whole walk, as float32; its
//    fragments are read with ldmatrix and split into TF32 hi and lo parts at each use
//    (hi and lo tiles would double its shared memory, and kept in registers they would take
//    D of them a thread).
//  * Key and value tiles of BKV rows (64, or 32 at D >= 128) are double-buffered in shared
//    memory and fed by cp.async: the next tile is in flight while the current one is
//    multiplied. Two __syncthreads a tile. Shared memory: 64 KB at D = 32 (three blocks an
//    SM), 104-109 KB at D = 64 and 128 (two), 205 KB at D = 256 (one).
//  * S = Q K^T goes by 3xTF32 m16n8k8 products chained into accumulator fragments (a chain
//    of 3 * D / 8 from zero a tile); the online softmax runs on them in registers, in base 2
//    (scores times scale * log2(e), exp2f): m_new = max(m, rowmax(s)), p = exp2(s - m_new),
//    alpha = exp2(m - m_new), l = l * alpha + rowsum(p), o = o * alpha + p V, as the TPU
//    kernel does (pallas_kernels.py:193-202). Row max and row sum go over the 4 threads of a
//    quad by shuffles in a fixed order: no atomics, so a rerun is bit-identical.
//  * P goes to a strip of shared memory private to its warp and comes back as A fragments
//    (the m16n8k8 accumulator layout is not the A layout). P V goes by 3xTF32 products, a
//    key tile's chained from zero and then added to O's accumulators on the CUDA cores (O's
//    sum runs over all of T, too long to leave to the tensor cores' truncating adds). O
//    stays in registers: D / 2 a thread (128 at D = 256, one warp owning 16 rows of all 256
//    columns; one block an SM allows 255 registers).
//  * Causal: key tiles wholly above a warp's rows are skipped; inside the diagonal tile,
//    and for keys at or beyond T, the score takes the finite mask value -1e30, as the TPU
//    kernel's where(row >= col, s, -1e30). T is any length: rows at or beyond T are
//    computed on zeros and not stored.
//  * D is a template parameter (32, 64, 128, 256); any other D up to 256 runs the next
//    larger instantiation with the extra columns zero in shared memory and never stored.
//  * Q, K, V and O are (B, T, H, D) read by their strides with a unit stride on D, so a
//    head slice or a transposed view needs no copy. 16-byte copies where D, the strides and
//    the pointers allow, 4-byte copies otherwise.
//
// Interface: a plain C function, launched on the caller's stream, allocating nothing and
// never synchronising; it returns cudaGetLastError() after its launch, 0 when accepted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int BQ = 64;        // queries a block
constexpr int NW = 4;         // warps a block, 16 query rows each
constexpr int NT = NW * 32;
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int BKV = DP >= 128 ? 32 : 64;  // key rows a tile
  static constexpr int QS = DP + 4;   // row stride of the Q and K tiles ([row][d], ldmatrix)
  static constexpr int VS = DP + 8;   // row stride of the V tile ([key][d], 32-bit loads)
  static constexpr int PS = BKV + 4;  // row stride of a warp's probability strip
  static constexpr int NS = BKV / 8;  // n8 score blocks of a warp a tile
  static constexpr int NO = DP / 8;   // n8 output blocks of a warp
  static constexpr int q_floats = BQ * QS;
  static constexpr int kv_floats = BKV * QS + BKV * VS;  // one stage: K then V
  static constexpr int p_floats = NW * 16 * PS;
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)(q_floats + 2 * kv_floats + p_floats);
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long st[4][3];  // (batch, time, head) strides of q, k, v, o, in floats
  int T, D;
  float scale_log2;    // scale * log2(e)
  int causal;
  int vec;             // q, k, v rows can be copied in 16-byte pieces
  int vec2;            // o can be written in 8-byte pieces
};

template <int DP>
__global__ void __launch_bounds__(NT, DP > 128 ? 1 : 2)
flash_attn_kernel(const Args a) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KV = Qs + C::q_floats;  // stage s: K at KV + s * kv_floats, V after it
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float* Ps = KV + 2 * C::kv_floats + warp * 16 * C::PS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, D = a.D;
  const bool vec = a.vec != 0, causal = a.causal != 0;
  const float* qb = a.q + b * a.st[0][0] + h * a.st[0][2];
  const float* kb = a.k + b * a.st[1][0] + h * a.st[1][2];
  const float* vb = a.v + b * a.st[2][0] + h * a.st[2][2];

  const int kend = causal ? min(T, q0 + BQ) : T;
  const int ntiles = (kend + C::BKV - 1) / C::BKV;
  auto load_kv = [&](int stage, int k0) {
    float* ks = KV + stage * C::kv_floats;
    tf32x3::copy_tile<C::BKV, DP, C::QS, NT>(ks, kb, a.st[1][1], k0, T, 0, D, vec);
    tf32x3::copy_tile<C::BKV, DP, C::VS, NT>(ks + C::BKV * C::QS, vb, a.st[2][1], k0, T, 0, D,
                                             vec);
  };
  tf32x3::copy_tile<BQ, DP, C::QS, NT>(Qs, qb, a.st[0][1], q0, T, 0, D, vec);
  load_kv(0, 0);
  tf32x3::cp_async_commit();

  const int wrow = q0 + warp * 16;  // the warp's first query row
  const float* Qw = Qs + warp * 16 * C::QS;
  float o[C::NO][4];
#pragma unroll
  for (int j = 0; j < C::NO; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv((it + 1) & 1, (it + 1) * C::BKV);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<1>();
    __syncthreads();  // tile it (and Q) in place
    const int k0 = it * C::BKV;
    const float* Kt = KV + (it & 1) * C::kv_floats;
    const float* Vt = Kt + C::BKV * C::QS;
    if (!causal || k0 <= wrow + 15) {
      // S = Q K^T, 3xTF32
      float s[C::NS][4];
#pragma unroll
      for (int j = 0; j < C::NS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; d += 8) {
        uint32_t araw[4];
        tf32x3::frag_a_rows(Qw + d, C::QS, araw);
        tf32x3::Split<4> qa;
        tf32x3::split(araw, qa);
#pragma unroll
        for (int j = 0; j < C::NS; j += 2) {
          uint32_t b4[4];
          tf32x3::frag_b2_rows(Kt + j * 8 * C::QS + d, C::QS, b4);
          const uint32_t r0[2] = {b4[0], b4[1]}, r1[2] = {b4[2], b4[3]};
          tf32x3::Split<2> kb0, kb1;
          tf32x3::split(r0, kb0);
          tf32x3::split(r1, kb1);
          tf32x3::mma3(s[j], qa, kb0);
          tf32x3::mma3(s[j + 1], qa, kb1);
        }
      }

      // scale into base 2; mask keys at or beyond T and, causal, after the row
      const bool edge = k0 + C::BKV > T || (causal && k0 + C::BKV - 1 > wrow);
#pragma unroll
      for (int j = 0; j < C::NS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = s[j][r] * a.scale_log2;
          if (edge) {
            const int key = k0 + j * 8 + 2 * t + (r & 1);
            const int row = wrow + g + (r >> 1) * 8;
            if (key >= T || (causal && key > row)) x = kMask;
          }
          s[j][r] = x;
        }

      // online softmax over the quad's rows g and g + 8
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kMask;
#pragma unroll
        for (int j = 0; j < C::NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hr], mx);
        alpha[hr] = exp2f(m[hr] - mn);
        m[hr] = mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::NS; ++j) {
          s[j][2 * hr] = exp2f(s[j][2 * hr] - mn);
          s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - mn);
          sum += s[j][2 * hr] + s[j][2 * hr + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hr] = l[hr] * alpha[hr] + sum;
      }

      // P to the warp's strip, read back as A fragments
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {
        *reinterpret_cast<float2*>(Ps + g * C::PS + j * 8 + 2 * t) =
            make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(Ps + (g + 8) * C::PS + j * 8 + 2 * t) =
            make_float2(s[j][2], s[j][3]);
      }
      __syncwarp();
      asm volatile("" ::: "memory");  // the strip's stores stay ahead of its ldmatrix reads
#pragma unroll
      for (int j = 0; j < C::NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += P V, 3xTF32: the tile's P fragments split once; for each n8 block of O the
      // tile's products chain into p from zero, then into O with rounding to nearest
      constexpr int KS = C::BKV / 8;
      tf32x3::Split<4> pa[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t praw[4];
        tf32x3::frag_a_rows(Ps + ks * 8, C::PS, praw);
        tf32x3::split(praw, pa[ks]);
      }
#pragma unroll
      for (int j = 0; j < C::NO; ++j) {
        float p[4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t vraw[2];
          tf32x3::frag_b_kmajor(Vt + ks * 8 * C::VS + j * 8, C::VS, vraw);
          tf32x3::Split<2> vf;
          tf32x3::split(vraw, vf);
          tf32x3::mma3(p, pa[ks], vf);
        }
        tf32x3::add(o[j], p);
      }
      __syncwarp();  // the strip is read before the next tile writes it
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* ob = a.o + b * a.st[3][0] + h * a.st[3][2];
  const bool vec2 = a.vec2 != 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wrow + g + hr * 8;
    if (row >= T) continue;
    float* orow = ob + (long long)row * a.st[3][1];
#pragma unroll
    for (int j = 0; j < C::NO; ++j) {
      const int col = j * 8 + 2 * t;
      const float v0 = o[j][2 * hr] / l[hr], v1 = o[j][2 * hr + 1] / l[hr];
      if (vec2 && col + 1 < D) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < D) orow[col] = v0;
        if (col + 1 < D) orow[col + 1] = v1;
      }
    }
  }
}

template <int DP>
int launch(const Args& a, int b, int h, cudaStream_t stream) {
  const size_t smem = Cfg<DP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((a.T + BQ - 1) / BQ), (unsigned int)h, (unsigned int)b);
  flash_attn_kernel<DP><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (b, t, h, d) float32 with a unit stride on d; strides holds the (batch, time,
// head) strides of q, k, v and o in that order, in floats (12 values). o = softmax(q k^T *
// scale, causal) v, with the mask value -1e30. 1 <= d <= 256; b, h <= 65535 (the grid's z
// and y axes); row indices fit an int.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, long long b,
                              long long t, long long h, long long d, const long long* strides,
                              float scale, int causal, void* stream) {
  if (b <= 0 || t <= 0 || h <= 0 || d <= 0 || d > 256 || b > 65535 || h > 65535 ||
      t > 0x7fffffffLL - BQ || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  bool vec = d % 4 == 0, vec2 = d % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 8 == 0;
  const void* in[3] = {q, k, v};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) {
      a.st[i][j] = strides[3 * i + j];
      if (i < 3 && a.st[i][j] % 4 != 0) vec = false;
      if (i == 3 && a.st[i][j] % 2 != 0) vec2 = false;
    }
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(in[i]) % 16 != 0) vec = false;
  a.T = (int)t;
  a.D = (int)d;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  a.vec = vec ? 1 : 0;
  a.vec2 = vec2 ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch<32>(a, (int)b, (int)h, s);
  if (d <= 64) return launch<64>(a, (int)b, (int)h, s);
  if (d <= 128) return launch<128>(a, (int)b, (int)h, s);
  return launch<256>(a, (int)b, (int)h, s);
}
