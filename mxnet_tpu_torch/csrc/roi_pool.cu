// ROIPooling: max over each bin of each region of interest, forward and backward.
//
// A port-only kernel. The JAX package computes ROIPooling in XLA
// (mxnet_tpu/ops/vision.py:28, `ROIPooling.apply`): for each roi it masks the whole
// feature map once per bin, a (C, ph, pw, H, W) tensor, and takes the max over (H, W).
// At Fast R-CNN's shape (conv5_3 of VGG-16 at 600x1000: C 512, H 37, W 62; 128 rois;
// 7x7 bins) that is 7.4 G elements, about 29.5 GB in float32, and its backward needs
// as much again. These kernels never build it.
//
// What bounds it on an H100: neither bytes nor operations at this shape. The forward
// reads each bin's pixels (a bin is ~6x9 of the 37x62 map) and writes one value; the
// backward reads the cotangent of every bin that holds a pixel. Both sit far below
// the card's rates; the first version aims at being right and deterministic.
//
// Semantics held exactly (the reference's rules):
//  * batch index: the roi's first value truncated toward zero (astype(int32)), a
//    negative index counted from the end, then clamped to [0, N-1], as a JAX
//    gather indexes;
//  * x1 = round(roi[1] * scale) with round half to even (rintf), products and sums
//    rounded separately (__fmul_rn, __fadd_rn: no fused multiply-add, as the plain
//    PyTorch version computes them op by op);
//  * roi_h = max(y2 - y1 + 1, 1), bin_h = roi_h / ph (IEEE division);
//  * bin i runs from floor(y1 + i * bin_h) to ceil(y1 + (i + 1) * bin_h), clipped
//    to [0, H] (and the same over x);
//  * an empty bin, or one whose max is not finite (an infinity, or a NaN anywhere in
//    the bin), gives 0 and takes no gradient.
//
// Forward: one thread per (roi, c, i, j). It writes the bin's max and the count of
// positions equal to it (0 for a bin that gives 0).
//
// Backward: one block per (image, channel) plane, one thread per input pixel of it
// (a thread keeps the same pixels throughout). The block first tabulates, in shared
// memory, each roi's image index and its bins' integer row and column ranges (the
// forward's arithmetic), in chunks of rois that fit in 48 KB; then each thread loops
// over the rois in order, skips those of another image or whose bins do not span its
// pixel, and over the bins of a roi that hold the pixel, in order; where the pixel
// equals the bin's max it adds g / count. This is JAX's VJP of max: the gradient of a
// bin is split equally over every position that ties for its max (a bin of zeros
// after a ReLU splits it over the whole bin). The sum runs in one fixed order with no
// atomics, so a rerun is bit-identical, and the chunking does not change it. The
// table leaves integer compares in the roi loop, where recomputing each roi's
// geometry for every pixel would cost a division and a dozen roundings a roi.
//
// Interface: plain C functions, float32, NCHW contiguous data, (R, 5) rois, launched
// on the caller's stream, allocating nothing and never synchronising. Each returns
// cudaGetLastError() after its launch; 0 means the launch was accepted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct RoiGeom {
  int b;
  float x1, y1, bin_h, bin_w;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* __restrict__ rois, long long r,
                                            int n, float scale, int ph, int pw) {
  const float* p = rois + r * 5;
  RoiGeom g;
  int b = (int)p[0];
  if (b < 0) b += n;
  g.b = b < 0 ? 0 : (b > n - 1 ? n - 1 : b);
  g.x1 = rintf(__fmul_rn(p[1], scale));
  g.y1 = rintf(__fmul_rn(p[2], scale));
  const float x2 = rintf(__fmul_rn(p[3], scale));
  const float y2 = rintf(__fmul_rn(p[4], scale));
  const float roi_h = fmaxf(__fadd_rn(__fsub_rn(y2, g.y1), 1.0f), 1.0f);
  const float roi_w = fmaxf(__fadd_rn(__fsub_rn(x2, g.x1), 1.0f), 1.0f);
  g.bin_h = __fdiv_rn(roi_h, (float)ph);
  g.bin_w = __fdiv_rn(roi_w, (float)pw);
  return g;
}

// The first row (column) of bin i: floor(start + i * bin) clipped to [0, lim].
__device__ __forceinline__ int bin_lo(float start, int i, float bin, int lim) {
  const float v = floorf(__fadd_rn(start, __fmul_rn((float)i, bin)));
  return (int)fminf(fmaxf(v, 0.0f), (float)lim);
}

// One past the last row (column) of bin i: ceil(start + (i + 1) * bin) clipped.
__device__ __forceinline__ int bin_hi(float start, int i, float bin, int lim) {
  const float v = ceilf(__fadd_rn(start, __fmul_rn((float)(i + 1), bin)));
  return (int)fminf(fmaxf(v, 0.0f), (float)lim);
}

__global__ void __launch_bounds__(kThreads)
roi_pool_fwd_kernel(const float* __restrict__ data, const float* __restrict__ rois,
                    float* __restrict__ out, int* __restrict__ count, int n, int c,
                    int h, int w, long long total, int ph, int pw, float scale) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(t % pw);
    const int i = (int)((t / pw) % ph);
    const int ch = (int)((t / ((long long)pw * ph)) % c);
    const long long r = t / ((long long)pw * ph * c);
    const RoiGeom g = roi_geom(rois, r, n, scale, ph, pw);
    const int ys = bin_lo(g.y1, i, g.bin_h, h), ye = bin_hi(g.y1, i, g.bin_h, h);
    const int xs = bin_lo(g.x1, j, g.bin_w, w), xe = bin_hi(g.x1, j, g.bin_w, w);
    const float* img = data + ((long long)g.b * c + ch) * h * w;
    float m = -INFINITY;
    int k = 0;
    bool nan = false;   // a NaN is the max of its bin, as JAX's max takes it
    for (int y = ys; y < ye; ++y) {
      const float* row = img + (long long)y * w;
      for (int x = xs; x < xe; ++x) {
        const float v = __ldg(row + x);
        if (v > m) {
          m = v;
          k = 1;
        } else if (v == m) {
          ++k;
        }
        nan |= v != v;
      }
    }
    const bool finite = !nan && fabsf(m) < INFINITY;
    out[t] = finite ? m : 0.0f;
    count[t] = finite ? k : 0;
  }
}

// The per-roi table the backward keeps in shared memory: the image index, the span
// of all bins (first row, one past the last row, first column, one past the last
// column), then each bin's row range and column range.
__host__ __device__ constexpr int table_ints(int ph, int pw) { return 5 + 2 * (ph + pw); }

// Rois a block's table holds at once: 48 KB of shared memory, the default limit.
constexpr int kTableInts = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_kernel(const float* __restrict__ data, const float* __restrict__ rois,
                    const float* __restrict__ out, const int* __restrict__ count,
                    const float* __restrict__ gy, float* dx, int n, int c, int h, int w,
                    long long nrois, int ph, int pw, float scale, int chunk) {
  extern __shared__ int table[];
  const int per = table_ints(ph, pw);
  const long long planes = (long long)n * c;
  const int hw = h * w;
  for (long long plane = blockIdx.x; plane < planes; plane += gridDim.x) {
    const int b = (int)(plane / c), ch = (int)(plane % c);
    const float* img = data + plane * hw;
    float* grad = dx + plane * hw;
    if (nrois == 0) {
      for (int pix = threadIdx.x; pix < hw; pix += blockDim.x) grad[pix] = 0.0f;
      continue;
    }
    for (long long r0 = 0; r0 < nrois; r0 += chunk) {
      const int rc = (int)(nrois - r0 < chunk ? nrois - r0 : chunk);
      __syncthreads();  // every thread is done with the previous table
      for (int k = threadIdx.x; k < rc; k += blockDim.x) {
        const RoiGeom g = roi_geom(rois, r0 + k, n, scale, ph, pw);
        int* e = table + k * per;
        e[0] = g.b;
        e[1] = bin_lo(g.y1, 0, g.bin_h, h);
        e[2] = bin_hi(g.y1, ph - 1, g.bin_h, h);
        e[3] = bin_lo(g.x1, 0, g.bin_w, w);
        e[4] = bin_hi(g.x1, pw - 1, g.bin_w, w);
        for (int i = 0; i < ph; ++i) {
          e[5 + i] = bin_lo(g.y1, i, g.bin_h, h);
          e[5 + ph + i] = bin_hi(g.y1, i, g.bin_h, h);
        }
        for (int j = 0; j < pw; ++j) {
          e[5 + 2 * ph + j] = bin_lo(g.x1, j, g.bin_w, w);
          e[5 + 2 * ph + pw + j] = bin_hi(g.x1, j, g.bin_w, w);
        }
      }
      __syncthreads();
      // each thread keeps its pixels from chunk to chunk, so every pixel's sum
      // runs over the rois in order, whatever the chunking
      for (int pix = threadIdx.x; pix < hw; pix += blockDim.x) {
        const int y = pix / w, x = pix % w;
        const float v = __ldg(img + pix);
        float acc = r0 == 0 ? 0.0f : grad[pix];
        for (int k = 0; k < rc; ++k) {
          const int* e = table + k * per;
          // bins are monotonic: bin 0 starts first, the last bin ends last
          if (e[0] != b || y < e[1] || y >= e[2] || x < e[3] || x >= e[4]) continue;
          const long long base = ((r0 + k) * c + ch) * ph * pw;
          for (int i = 0; i < ph; ++i) {
            if (y < e[5 + i] || y >= e[5 + ph + i]) continue;
            for (int j = 0; j < pw; ++j) {
              if (x < e[5 + 2 * ph + j] || x >= e[5 + 2 * ph + pw + j]) continue;
              const long long o = base + (long long)i * pw + j;
              const int cnt = __ldg(count + o);
              if (cnt > 0 && v == __ldg(out + o))
                acc = __fadd_rn(acc, __fdiv_rn(__ldg(gy + o), (float)cnt));
            }
          }
        }
        grad[pix] = acc;
      }
    }
  }
}

int grid_for(long long total) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

}  // namespace

extern "C" int roi_pool_fwd(const float* data, const float* rois, float* out, int* count,
                            int n, int c, int h, int w, long long nrois, int ph, int pw,
                            float scale, void* stream) {
  const long long total = nrois * c * ph * pw;
  if (total == 0) return 0;
  roi_pool_fwd_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      data, rois, out, count, n, c, h, w, total, ph, pw, scale);
  return (int)cudaGetLastError();
}

extern "C" int roi_pool_bwd(const float* data, const float* rois, const float* out,
                            const int* count, const float* gy, float* dx, int n, int c,
                            int h, int w, long long nrois, int ph, int pw, float scale,
                            void* stream) {
  const long long planes = (long long)n * c;
  if (planes == 0 || h * w == 0) return 0;
  const int per = table_ints(ph, pw);
  if (per > kTableInts) return (int)cudaErrorInvalidValue;
  const long long chunk = nrois < kTableInts / per ? (nrois > 0 ? nrois : 1)
                                                   : kTableInts / per;
  // one block a (image, channel) plane, at most eight blocks an SM
  const long long cap = grid_for(1LL << 40);
  const int grid = (int)(planes < cap ? planes : cap);
  roi_pool_bwd_kernel<<<grid, kThreads, chunk * per * sizeof(int),
                        (cudaStream_t)stream>>>(data, rois, out, count, gy, dx, n, c, h, w,
                                                nrois, ph, pw, scale, (int)chunk);
  return (int)cudaGetLastError();
}
