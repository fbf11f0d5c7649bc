// crop_norm: the device feed's augmentation. uint8 stored frames in, a float32 batch
// out: per image a crop at (top, left), a mirror of the crop's columns where its flag
// is set, (x - mean[c]) * scale, in NCHW or NHWC.
//
// A port-only kernel. The JAX package computes this in XLA: the jitted augment of
// mxnet_tpu/io_cache.py (`_device_augment` :455, `materialize_device_feed` :675, the
// host-crop normalize `_normalize` :430) and the fused step's in-graph `_augment`
// (mxnet_tpu/fused_step.py:543): `dynamic_slice` of each frame (its start clamped so
// the slice fits), `where(mirror, crop[:, ::-1], crop)`, the cast to float32, the
// subtraction of the mean and the product with the scale. Here it is one launch that
// the fused train step records as the first node of its CUDA graph, writing straight
// into the bound data array; every per-batch value (the frames, the offsets, the
// flags, the mean and the scale) is read from device memory, so one graph serves
// every batch, mean and scale.
//
// Arithmetic: __fsub_rn then __fmul_rn, each rounded once, as XLA and the plain
// PyTorch version compute them (there is no product-then-sum to contract), so the
// result is bit-equal to both.
//
// What bounds it on an H100: bytes. At ResNet-50's feed (32 frames of 256x256x3 cut
// to 224x224) it reads the crops, 4.82 MB of uint8, and writes 19.27 MB of float32:
// 7.2 us at 3.35 TB/s. It does no more than a few operations a byte. One thread per
// output pixel (image, row, column) reads the pixel's C bytes and writes its C
// floats: in NHWC neighbouring threads write neighbouring 4C-byte runs, in NCHW each
// channel plane's row is written by consecutive threads; the reads of neighbouring
// threads are neighbouring bytes of one frame row (backwards where mirrored).
//
// Interface: a plain C function, launched on the caller's stream, allocating nothing
// and never synchronising; it returns cudaGetLastError() after the launch (0: the
// launch was accepted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
crop_norm_kernel(const uint8_t* __restrict__ x, const int* __restrict__ tops,
                 const int* __restrict__ lefts, const uint8_t* __restrict__ mirror,
                 const float* __restrict__ mean, const float* __restrict__ scale,
                 float* __restrict__ out, int b, int sh, int sw, int c, int h, int w,
                 int nchw) {
  const long long pixels = (long long)b * h * w;
  const float s = *scale;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < pixels;
       p += (long long)gridDim.x * blockDim.x) {
    const int xo = (int)(p % w);
    const int yo = (int)((p / w) % h);
    const int n = (int)(p / ((long long)w * h));
    // dynamic_slice clamps the start so that the slice lies inside the frame
    const int top = min(max(tops[n], 0), sh - h);
    const int left = min(max(lefts[n], 0), sw - w);
    const int xs = left + (mirror[n] ? w - 1 - xo : xo);
    const uint8_t* src = x + (((long long)n * sh + top + yo) * sw + xs) * c;
    if (nchw) {
      float* dst = out + (long long)n * c * h * w + (long long)yo * w + xo;
      const long long plane = (long long)h * w;
      for (int ch = 0; ch < c; ++ch)
        dst[ch * plane] = __fmul_rn(__fsub_rn((float)src[ch], mean[ch]), s);
    } else {
      float* dst = out + p * c;
      for (int ch = 0; ch < c; ++ch)
        dst[ch] = __fmul_rn(__fsub_rn((float)src[ch], mean[ch]), s);
    }
  }
}

}  // namespace

extern "C" int crop_norm(const uint8_t* x, const int* tops, const int* lefts,
                         const uint8_t* mirror, const float* mean, const float* scale,
                         float* out, int b, int sh, int sw, int c, int h, int w,
                         int nchw, void* stream) {
  const long long pixels = (long long)b * h * w;
  if (pixels == 0 || c == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (pixels + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  const int grid = (int)(need < cap ? need : cap);
  crop_norm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, tops, lefts, mirror, mean, scale, out, b, sh, sw, c, h, w, nchw);
  return (int)cudaGetLastError();
}
