// Fused per-channel scale/shift + activation: the forward y = act(x * scale + shift)
// (K4) and its backward (K5).
//
// Forward. Replaces the TPU kernel `_norm_act_fwd_call` in
// mxnet_tpu/ops/pallas_kernels.py (reached through `fused_norm_act`), which
// BatchNorm's channels-last apply runs with act="none": 53 launches per ResNet-50
// forward.
//
// What bounds it on an H100: HBM bytes. Each element is read once and written
// once and takes two flops, so the kernel sits ~100x below the float32 ridge
// point; the only lever is moving those bytes at the full memory rate.
//
// What the forward's design does about that:
//  * x is viewed as (rows, C) channels-last; C is the innermost, contiguous axis.
//  * Vector path: when C is a multiple of the 16-byte vector width (4 float32 or
//    8 bfloat16 values) and every pointer is 16-byte aligned, each thread moves
//    16 bytes per load and per store, so a warp touches 512 contiguous bytes: the
//    widest coalesced access the memory system serves. Because C is a multiple
//    of the width, one vector never straddles two rows, and all its values share
//    one run of consecutive channels.
//  * Otherwise a scalar path covers any (rows, C), ragged shapes included. The
//    TPU kernel's (128 rows, 128 channels) tiling condition is gone: the grid
//    stride loop masks the edge itself, so ResNet's 64-channel layers take the
//    kernel too.
//  * Grid-stride loop over R*C elements with 64-bit indices. The channel of the
//    element a thread holds is computed once with a modulo and then advanced by
//    (stride mod C) with one compare-and-subtract per step, so no 64-bit division
//    runs inside the loop.
//  * scale and shift (float32, per channel) are staged into shared memory when
//    C <= 4096 (at most 32 KB a block); above that they are read from global
//    memory, where L1 and L2 hold them.
//  * Math in float32. The product and the sum are rounded separately
//    (__fmul_rn, __fadd_rn, no fused multiply-add), which is what the plain
//    PyTorch version `x.float() * scale + shift` does on the same card, so the
//    two agree bit for bit. bfloat16 converts with __bfloat162float and
//    __float2bfloat16 (round to nearest even), as torch's own casts do.
//  * ReLU is `y < 0 ? 0 : y`, so a NaN propagates as it does through torch.relu.
//
// Backward. Replaces `_norm_act_bwd_call` (pallas_kernels.py:610), the backward
// of all 53 BatchNorms of a ResNet-50 training step. One pass over x and the
// cotangent g gives dx = g' * scale and the per-channel sums dscale = sum g' * x and
// dshift = sum g', where g' is g with the ReLU mask applied (act="relu").
//
// What bounds it: HBM bytes again (x and g read once, dx written once, ~6 flops an
// element). What the backward's design does:
//  * The TPU kernel carries the per-channel sums across an ordered grid. A GPU
//    grid has no order, so the sums take two launches and no atomics: stage 1
//    gives each block a (32 channels x a run of rows) tile, one channel per lane
//    and eight warps over the rows, so a warp reads 32 consecutive channels of a
//    row (128 contiguous bytes in float32). Each block writes its per-channel
//    partial sums to a (row blocks, 2, C) float32 scratch that the caller
//    allocates; stage 2 sums the partials of each channel in a fixed order. The
//    work split depends only on the shape and the card's SM count, so a rerun is
//    bit-identical.
//  * The ReLU mask is recomputed with the forward's rounding (__fmul_rn then
//    __fadd_rn), so it matches the forward's output exactly: g' = pre > 0 ? g : 0.
//  * dx = __fmul_rn(g', scale) rounds as the plain version's `g * scale` does, so
//    float32 dx is bit-equal to it. The sums accumulate in float32 with fused
//    multiply-adds; they agree with a float64 sum within the rounding of the
//    accumulation order.
//  * No 128-row or 128-channel tiling condition: every edge is masked.
//
// Interface: plain C functions, launched on the caller's stream, allocating
// nothing and never synchronising. Each returns cudaGetLastError() after its
// launches; 0 means the launches were accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemChannels = 4096;
constexpr int kBlocksPerSm = 4;

struct F32 {
  static constexpr int kVec = 4;
  __device__ static void load(const void* p, long long i, float (&f)[kVec]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(void* p, long long i, const float (&f)[kVec]) {
    reinterpret_cast<float4*>(p)[i] = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ static float load1(const void* p, long long i) {
    return __ldg(reinterpret_cast<const float*>(p) + i);
  }
  __device__ static void store1(void* p, long long i, float v) {
    reinterpret_cast<float*>(p)[i] = v;
  }
};

struct BF16 {
  static constexpr int kVec = 8;
  __device__ static float lo(unsigned int w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
  }
  __device__ static float hi(unsigned int w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
  }
  __device__ static unsigned int bits(float v) {
    return (unsigned int)__bfloat16_as_ushort(__float2bfloat16(v));
  }
  __device__ static unsigned int pack(float a, float b) {
    return bits(a) | (bits(b) << 16);
  }
  __device__ static void load(const void* p, long long i, float (&f)[kVec]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    f[0] = lo(v.x);
    f[1] = hi(v.x);
    f[2] = lo(v.y);
    f[3] = hi(v.y);
    f[4] = lo(v.z);
    f[5] = hi(v.z);
    f[6] = lo(v.w);
    f[7] = hi(v.w);
  }
  __device__ static void store(void* p, long long i, const float (&f)[kVec]) {
    uint4 v;
    v.x = pack(f[0], f[1]);
    v.y = pack(f[2], f[3]);
    v.z = pack(f[4], f[5]);
    v.w = pack(f[6], f[7]);
    reinterpret_cast<uint4*>(p)[i] = v;
  }
  __device__ static float load1(const void* p, long long i) {
    const unsigned short s = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
    return __bfloat162float(__ushort_as_bfloat16(s));
  }
  __device__ static void store1(void* p, long long i, float v) {
    reinterpret_cast<unsigned short*>(p)[i] = (unsigned short)bits(v);
  }
};

template <bool RELU>
__device__ __forceinline__ float scale_shift(float x, float s, float b) {
  const float y = __fadd_rn(__fmul_rn(x, s), b);
  if (RELU) return y < 0.f ? 0.f : y;
  return y;
}

// Stage scale then shift into shared memory; returns where to read them.
template <bool SMEM>
__device__ __forceinline__ void stage(const float* scale, const float* shift, int C,
                                      const float** sc, const float** sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  *sc = scale;
  *sh = shift;
  if (SMEM) {
    float* s = reinterpret_cast<float*>(smem_raw);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      s[c] = scale[c];
      s[C + c] = shift[c];
    }
    __syncthreads();
    *sc = s;
    *sh = s + C;
  }
}

// One 16-byte vector per thread per step; nvec = rows * C / kVec.
template <class E, bool RELU, bool SMEM>
__global__ void __launch_bounds__(kThreads)
norm_act_vec_kernel(const void* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, void* __restrict__ y,
                    long long nvec, int C) {
  constexpr int N = E::kVec;
  const float* sc;
  const float* sh;
  stage<SMEM>(scale, shift, C, &sc, &sh);
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = (int)((i * N) % C);                // first channel of this vector
  const int cstep = (int)((stride * N) % C);
  for (; i < nvec; i += stride) {
    float f[N];
    E::load(x, i, f);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 s4 = reinterpret_cast<const float4*>(sc + c)[j];
      const float4 b4 = reinterpret_cast<const float4*>(sh + c)[j];
      f[4 * j + 0] = scale_shift<RELU>(f[4 * j + 0], s4.x, b4.x);
      f[4 * j + 1] = scale_shift<RELU>(f[4 * j + 1], s4.y, b4.y);
      f[4 * j + 2] = scale_shift<RELU>(f[4 * j + 2], s4.z, b4.z);
      f[4 * j + 3] = scale_shift<RELU>(f[4 * j + 3], s4.w, b4.w);
    }
    E::store(y, i, f);
    c += cstep;
    if (c >= C) c -= C;
  }
}

// One element per thread per step, for any C and any alignment.
template <class E, bool RELU, bool SMEM>
__global__ void __launch_bounds__(kThreads)
norm_act_scalar_kernel(const void* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ shift, void* __restrict__ y,
                       long long n, int C) {
  const float* sc;
  const float* sh;
  stage<SMEM>(scale, shift, C, &sc, &sh);
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = (int)(i % C);
  const int cstep = (int)(stride % C);
  for (; i < n; i += stride) {
    E::store1(y, i, scale_shift<RELU>(E::load1(x, i), sc[c], sh[c]));
    c += cstep;
    if (c >= C) c -= C;
  }
}

int num_sms() {
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

template <class E, bool RELU>
void launch(const void* x, const float* sc, const float* sh, void* y, long long n, int C,
            bool vec, cudaStream_t stream) {
  const bool smem = C <= kMaxSmemChannels;
  const size_t smem_bytes = smem ? 2 * (size_t)C * sizeof(float) : 0;
  const long long work = vec ? n / E::kVec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)num_sms() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned int)blocks);
  if (vec) {
    if (smem)
      norm_act_vec_kernel<E, RELU, true><<<grid, kThreads, smem_bytes, stream>>>(x, sc, sh, y, work, C);
    else
      norm_act_vec_kernel<E, RELU, false><<<grid, kThreads, 0, stream>>>(x, sc, sh, y, work, C);
  } else {
    if (smem)
      norm_act_scalar_kernel<E, RELU, true><<<grid, kThreads, smem_bytes, stream>>>(x, sc, sh, y, work, C);
    else
      norm_act_scalar_kernel<E, RELU, false><<<grid, kThreads, 0, stream>>>(x, sc, sh, y, work, C);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
constexpr int kBwdLanes = 32;          // channels of a block, one per lane
constexpr int kBwdWarps = 8;           // warps of a block, striding over its rows
constexpr int kBwdBlocksPerSm = 8;     // 8 x 256 threads fill an SM
constexpr int kReduceThreads = 256;

// Row blocks of stage 1 for (rows, C): enough blocks to fill the card, at least
// one row per warp. The caller sizes the partials scratch with this.
int bwd_row_blocks(long long rows, int C) {
  if (rows <= 0 || C <= 0) return 0;
  const long long col_blocks = (C + kBwdLanes - 1) / kBwdLanes;
  const long long target = (long long)num_sms() * kBwdBlocksPerSm;
  long long rb = (target + col_blocks - 1) / col_blocks;
  const long long most = (rows + kBwdWarps - 1) / kBwdWarps;
  if (rb > most) rb = most;
  if (rb < 1) rb = 1;
  if (rb > 65535) rb = 65535;
  const long long rows_per_block = (rows + rb - 1) / rb;
  return (int)((rows + rows_per_block - 1) / rows_per_block);
}

// Stage 1: dx for the block's tile, and the tile's per-channel partial sums,
// written to partial[blockIdx.y][0][c] (sum g'x) and partial[blockIdx.y][1][c]
// (sum g').
template <class E, bool RELU>
__global__ void __launch_bounds__(kBwdLanes * kBwdWarps)
norm_act_bwd_partial_kernel(const void* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ shift, const void* __restrict__ g,
                            void* __restrict__ dx, float* __restrict__ partial,
                            long long rows, int C, long long rows_per_block) {
  __shared__ float red[2][kBwdWarps][kBwdLanes];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int c = blockIdx.x * kBwdLanes + lane;
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  long long r1 = r0 + rows_per_block;
  if (r1 > rows) r1 = rows;
  float sgx = 0.f, sg = 0.f;
  if (c < C) {
    const float s = scale[c];
    const float b = shift[c];
#pragma unroll 4
    for (long long r = r0 + warp; r < r1; r += kBwdWarps) {
      const long long i = r * C + c;
      const float xv = E::load1(x, i);
      float gv = E::load1(g, i);
      if (RELU && !(__fadd_rn(__fmul_rn(xv, s), b) > 0.f)) gv = 0.f;
      E::store1(dx, i, __fmul_rn(gv, s));
      sgx = __fmaf_rn(gv, xv, sgx);
      sg = __fadd_rn(sg, gv);
    }
  }
  red[0][warp][lane] = sgx;
  red[1][warp][lane] = sg;
  __syncthreads();
  if (warp == 0 && c < C) {
    float a = red[0][0][lane];
    float d = red[1][0][lane];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) {
      a = __fadd_rn(a, red[0][w][lane]);
      d = __fadd_rn(d, red[1][w][lane]);
    }
    float* p = partial + (long long)blockIdx.y * 2 * C;
    p[c] = a;
    p[C + c] = d;
  }
}

// Stage 2: one thread per (sum, channel) adds the row blocks' partials in order.
__global__ void __launch_bounds__(kReduceThreads)
norm_act_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                           float* __restrict__ dshift, int row_blocks, int C) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;   // j < C: dscale, else dshift
  if (j >= 2 * C) return;
  float s = 0.f;
  for (int b = 0; b < row_blocks; ++b) s = __fadd_rn(s, partial[(long long)b * 2 * C + j]);
  if (j < C)
    dscale[j] = s;
  else
    dshift[j - C] = s;
}

template <class E, bool RELU>
void launch_bwd(const void* x, const float* sc, const float* sh, const void* g, void* dx,
                float* dscale, float* dshift, float* partial, long long rows, int C,
                int row_blocks, cudaStream_t stream) {
  const long long rows_per_block = (rows + row_blocks - 1) / row_blocks;
  const dim3 grid((unsigned int)((C + kBwdLanes - 1) / kBwdLanes), (unsigned int)row_blocks);
  const dim3 block(kBwdLanes, kBwdWarps);
  norm_act_bwd_partial_kernel<E, RELU><<<grid, block, 0, stream>>>(
      x, sc, sh, g, dx, partial, rows, C, rows_per_block);
  const int rgrid = (2 * C + kReduceThreads - 1) / kReduceThreads;
  norm_act_bwd_reduce_kernel<<<rgrid, kReduceThreads, 0, stream>>>(partial, dscale, dshift,
                                                                    row_blocks, C);
}

}  // namespace

// x, y: (rows, channels) contiguous, float32 (dtype 0) or bfloat16 (dtype 1).
// scale, shift: (channels,) contiguous float32. relu: 0 = none, 1 = relu.
extern "C" int norm_act_fwd(const void* x, const void* scale, const void* shift, void* y,
                            long long rows, int channels, int dtype, int relu, void* stream) {
  if (rows < 0 || channels <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const long long n = rows * (long long)channels;
  if (n == 0) return 0;
  const int vec_width = dtype == 0 ? F32::kVec : BF16::kVec;
  const uintptr_t addr_bits = (uintptr_t)x | (uintptr_t)y | (uintptr_t)scale | (uintptr_t)shift;
  const bool vec = channels % vec_width == 0 && addr_bits % 16 == 0;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (relu) launch<F32, true>(x, sc, sh, y, n, channels, vec, s);
    else launch<F32, false>(x, sc, sh, y, n, channels, vec, s);
  } else {
    if (relu) launch<BF16, true>(x, sc, sh, y, n, channels, vec, s);
    else launch<BF16, false>(x, sc, sh, y, n, channels, vec, s);
  }
  return (int)cudaGetLastError();
}

// Row blocks of norm_act_bwd's first stage for (rows, channels) on the current
// device: the caller allocates partial as (row_blocks, 2, channels) float32.
extern "C" int norm_act_bwd_row_blocks(long long rows, int channels) {
  return bwd_row_blocks(rows, channels);
}

// x, g, dx: (rows, channels) contiguous, float32 (dtype 0) or bfloat16 (dtype 1).
// scale, shift: (channels,) float32. dscale, dshift: (channels,) float32 outputs.
// partial: (row_blocks, 2, channels) float32 scratch, row_blocks as
// norm_act_bwd_row_blocks gives it. relu: 0 = none, 1 = relu.
extern "C" int norm_act_bwd(const void* x, const void* scale, const void* shift, const void* g,
                            void* dx, void* dscale, void* dshift, void* partial,
                            long long rows, int channels, int row_blocks, int dtype, int relu,
                            void* stream) {
  if (rows <= 0 || channels <= 0 || (dtype != 0 && dtype != 1) ||
      row_blocks != bwd_row_blocks(rows, channels))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* dsc = static_cast<float*>(dscale);
  float* dsh = static_cast<float*>(dshift);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (relu) launch_bwd<F32, true>(x, sc, sh, g, dx, dsc, dsh, part, rows, channels, row_blocks, s);
    else launch_bwd<F32, false>(x, sc, sh, g, dx, dsc, dsh, part, rows, channels, row_blocks, s);
  } else {
    if (relu) launch_bwd<BF16, true>(x, sc, sh, g, dx, dsc, dsh, part, rows, channels, row_blocks, s);
    else launch_bwd<BF16, false>(x, sc, sh, g, dx, dsc, dsh, part, rows, channels, row_blocks, s);
  }
  return (int)cudaGetLastError();
}
