// Fused per-channel scale/shift + activation, forward: y = act(x * scale + shift).
//
// Replaces the TPU kernel `_norm_act_fwd_call` in mxnet_tpu/ops/pallas_kernels.py
// (reached through `fused_norm_act`), which BatchNorm's channels-last apply runs
// with act="none": 53 launches per ResNet-50 forward.
//
// What bounds it on an H100: HBM bytes. Each element is read once and written
// once and takes two flops, so the kernel sits ~100x below the float32 ridge
// point; the only lever is moving those bytes at the full memory rate.
//
// What the design does about that:
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
// Interface: a plain C function, launched on the caller's stream, allocating
// nothing and never synchronising. It returns cudaGetLastError() after the
// launch; 0 means the launch was accepted.

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
