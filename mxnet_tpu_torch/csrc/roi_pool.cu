// ROIPooling: max over each bin of each region of interest, forward and backward,
// in float32, bfloat16 or float16.
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
// the card's rates; the design aims at being right and deterministic.
//
// The bins are integers. The reference computes each bin's edges in the data's
// dtype (round(roi * scale), y2 - y1 + 1, the division by ph, iy * bin_h, the sum,
// floor and ceil, each step rounded to that dtype, then compares the dtype's arange
// of rows against them), so a first small kernel (`roi_geom_kernel`, one thread a
// roi) does that arithmetic with the same roundings: each float32 operation on two
// values of the dtype, rounded once to the dtype (__float2bfloat16_rn,
// __float2half_rn), which is what PyTorch's and XLA's 16-bit elementwise operations
// compute (a product of two 16-bit values is exact in float32, and float32's 24 bits
// make the one extra rounding of a division harmless). It writes each roi's image
// index and its bins' row and column ranges [start, end) as int32 into the
// caller's scratch, an edge being the count of rows whose dtype value lies below
// it; the pooling kernels read that table. The plain version computes the same table
// with PyTorch operations in the dtype (ops/kernels.py, `_roi_geometry`), so both
// paths pool the same positions in every dtype.
//
// Semantics held exactly (the reference's rules): an empty bin, or one whose max is
// not finite (an infinity, or a NaN anywhere in the bin), gives 0 and takes no
// gradient; the max and the comparisons are exact in any of the three types (each
// value is widened to float32, which is exact).
//
// Forward: one thread per (roi, c, i, j). It writes the bin's max (in the data's
// type: exact) and the count of positions equal to it (0 for a bin that gives 0).
//
// Backward: one block per (image, channel) plane, one thread per input pixel of it
// (a thread keeps the same pixels throughout). The block first copies into shared
// memory, in chunks of rois that fit in 48 KB, each roi's image index, the span of
// its bins and its bins' ranges; then each thread loops over the rois in order, skips
// those of another image or whose bins do not span its pixel, and over the bins of a
// roi that hold the pixel, in order; where the pixel equals the bin's max it adds
// g / count. This is JAX's VJP of max: the gradient of a bin is split equally over
// every position that ties for its max. In a 16-bit type each term g / count is
// rounded to that type, as JAX divides in it; the terms are summed in float32 and the
// sum rounded to the type once (JAX sums in the 16-bit type, so the two differ by
// the roundings of its sum: tests/test_torch_queue_c.py states the bound). The sum
// runs in one fixed order with no atomics, so a rerun is bit-identical, and the
// chunking does not change it.
//
// Interface: plain C functions over NCHW contiguous data and (R, 5) rois of type
// `dtype` (0 float32, 1 bfloat16, 2 float16) and an int32 scratch of
// R * (1 + 2 ph + 2 pw) for the geometry, launched on the caller's stream, allocating
// nothing and never synchronising. Each returns cudaGetLastError() after its
// launches; 0 means they were accepted.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <class T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

// x rounded to T, back in float32: one operation of the dtype.
template <class T> __device__ __forceinline__ float in_t(float x) {
  return widen(narrow<T>(x));
}

// The count of rows 0..lim-1 whose value in T lies below e. T's arange is monotonic
// and close to the rows' indices (equal to them up to 256 in bfloat16, 2048 in
// float16), so the count is ceil(e), clamped, moved by the few steps where T rounds
// the rows near e.
template <class T> __device__ __forceinline__ int rows_below(float e, int lim) {
  int k = (int)fminf(fmaxf(ceilf(e), 0.0f), (float)lim);
  while (k > 0 && in_t<T>((float)(k - 1)) >= e) --k;
  while (k < lim && in_t<T>((float)k) < e) ++k;
  return k;
}

// Each roi's image index and bin ranges, the reference's arithmetic in T
// (mxnet_tpu/ops/vision.py:55-79): table = [b (R), ys (R, ph), ye (R, ph),
// xs (R, pw), xe (R, pw)].
template <class T>
__global__ void __launch_bounds__(kThreads)
roi_geom_kernel(const T* __restrict__ rois, int* __restrict__ table, long long nrois,
                int n, int h, int w, int ph, int pw, float scale) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= nrois) return;
  const T* p = rois + r * 5;
  int* bidx = table;
  int* ys = bidx + nrois;
  int* ye = ys + nrois * ph;
  int* xs = ye + nrois * ph;
  int* xe = xs + nrois * pw;
  // the image index: truncated toward zero, negative from the end, clamped
  int b = (int)widen(p[0]);
  if (b < 0) b += n;
  bidx[r] = b < 0 ? 0 : (b > n - 1 ? n - 1 : b);
  const float s = in_t<T>(scale);
  float c[4];
  for (int k = 0; k < 4; ++k)
    c[k] = in_t<T>(rintf(in_t<T>(__fmul_rn(widen(p[1 + k]), s))));
  const float x1 = c[0], y1 = c[1], x2 = c[2], y2 = c[3];
  const float one = 1.0f;
  const float bin_h = in_t<T>(__fdiv_rn(
      fmaxf(in_t<T>(__fadd_rn(in_t<T>(__fsub_rn(y2, y1)), one)), one), in_t<T>(ph)));
  const float bin_w = in_t<T>(__fdiv_rn(
      fmaxf(in_t<T>(__fadd_rn(in_t<T>(__fsub_rn(x2, x1)), one)), one), in_t<T>(pw)));
  const float lim_h = in_t<T>((float)h), lim_w = in_t<T>((float)w);
  for (int i = 0; i < ph; ++i) {
    const float fi = in_t<T>((float)i), fi1 = in_t<T>(__fadd_rn(fi, one));
    const float lo = floorf(in_t<T>(__fadd_rn(y1, in_t<T>(__fmul_rn(fi, bin_h)))));
    const float hi = ceilf(in_t<T>(__fadd_rn(y1, in_t<T>(__fmul_rn(fi1, bin_h)))));
    ys[r * ph + i] = rows_below<T>(fminf(fmaxf(lo, 0.0f), lim_h), h);
    ye[r * ph + i] = rows_below<T>(fminf(fmaxf(hi, 0.0f), lim_h), h);
  }
  for (int j = 0; j < pw; ++j) {
    const float fj = in_t<T>((float)j), fj1 = in_t<T>(__fadd_rn(fj, one));
    const float lo = floorf(in_t<T>(__fadd_rn(x1, in_t<T>(__fmul_rn(fj, bin_w)))));
    const float hi = ceilf(in_t<T>(__fadd_rn(x1, in_t<T>(__fmul_rn(fj1, bin_w)))));
    xs[r * pw + j] = rows_below<T>(fminf(fmaxf(lo, 0.0f), lim_w), w);
    xe[r * pw + j] = rows_below<T>(fminf(fmaxf(hi, 0.0f), lim_w), w);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
roi_pool_fwd_kernel(const T* __restrict__ data, const int* __restrict__ bidx,
                    const int* __restrict__ ys, const int* __restrict__ ye,
                    const int* __restrict__ xs, const int* __restrict__ xe,
                    T* __restrict__ out, int* __restrict__ count, int c, int h, int w,
                    long long total, int ph, int pw) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(t % pw);
    const int i = (int)((t / pw) % ph);
    const int ch = (int)((t / ((long long)pw * ph)) % c);
    const long long r = t / ((long long)pw * ph * c);
    const int y0 = ys[r * ph + i], y1 = ye[r * ph + i];
    const int x0 = xs[r * pw + j], x1 = xe[r * pw + j];
    const T* img = data + ((long long)bidx[r] * c + ch) * h * w;
    float m = -INFINITY;
    int k = 0;
    bool nan = false;   // a NaN is the max of its bin, as JAX's max takes it
    for (int y = y0; y < y1; ++y) {
      const T* row = img + (long long)y * w;
      for (int x = x0; x < x1; ++x) {
        const float v = widen(row[x]);
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
    out[t] = narrow<T>(finite ? m : 0.0f);
    count[t] = finite ? k : 0;
  }
}

// The per-roi table the backward keeps in shared memory: the image index, the span
// of all bins (first row, one past the last row, first column, one past the last
// column), then each bin's row range and column range.
__host__ __device__ constexpr int table_ints(int ph, int pw) { return 5 + 2 * (ph + pw); }

// Rois a block's table holds at once: 48 KB of shared memory, the default limit.
constexpr int kTableInts = 48 * 1024 / 4;

template <class T>
__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_kernel(const T* __restrict__ data, const int* __restrict__ bidx,
                    const int* __restrict__ ys, const int* __restrict__ ye,
                    const int* __restrict__ xs, const int* __restrict__ xe,
                    const T* __restrict__ out, const int* __restrict__ count,
                    const T* __restrict__ gy, T* dx, int n, int c, int h, int w,
                    long long nrois, int ph, int pw, int chunk) {
  extern __shared__ int table[];
  const int per = table_ints(ph, pw);
  const long long planes = (long long)n * c;
  const int hw = h * w;
  for (long long plane = blockIdx.x; plane < planes; plane += gridDim.x) {
    const int b = (int)(plane / c), ch = (int)(plane % c);
    const T* img = data + plane * hw;
    T* grad = dx + plane * hw;
    // a pixel's whole float32 sum stays in one register: the pixels are walked in
    // groups of blockDim.x, and for each group the rois chunk by chunk, in order; with
    // one chunk (every roi in the table, the usual case) the table is built once a
    // plane
    const bool one_chunk = nrois <= chunk;
    for (int pix0 = 0; pix0 < hw; pix0 += blockDim.x) {
      const int pix = pix0 + threadIdx.x;
      const bool mine = pix < hw;
      const int y = mine ? pix / w : 0, x = mine ? pix % w : 0;
      const float v = mine ? widen(img[pix]) : 0.0f;
      float acc = 0.0f;
      for (long long r0 = 0; r0 < nrois; r0 += chunk) {
        const int rc = (int)(nrois - r0 < chunk ? nrois - r0 : chunk);
        if (!one_chunk || pix0 == 0) {
          __syncthreads();  // every thread is done with the previous table
          for (int k = threadIdx.x; k < rc; k += blockDim.x) {
            const long long r = r0 + k;
            int* e = table + k * per;
            int lo_y = h, hi_y = 0, lo_x = w, hi_x = 0;
            for (int i = 0; i < ph; ++i) {
              const int s = ys[r * ph + i], f = ye[r * ph + i];
              e[5 + i] = s;
              e[5 + ph + i] = f;
              lo_y = min(lo_y, s);
              hi_y = max(hi_y, f);
            }
            for (int j = 0; j < pw; ++j) {
              const int s = xs[r * pw + j], f = xe[r * pw + j];
              e[5 + 2 * ph + j] = s;
              e[5 + 2 * ph + pw + j] = f;
              lo_x = min(lo_x, s);
              hi_x = max(hi_x, f);
            }
            e[0] = bidx[r];
            e[1] = lo_y;
            e[2] = hi_y;
            e[3] = lo_x;
            e[4] = hi_x;
          }
          __syncthreads();
        }
        if (!mine) continue;
        for (int k = 0; k < rc; ++k) {
          const int* e = table + k * per;
          if (e[0] != b || y < e[1] || y >= e[2] || x < e[3] || x >= e[4]) continue;
          const long long base = ((r0 + k) * c + ch) * ph * pw;
          for (int i = 0; i < ph; ++i) {
            if (y < e[5 + i] || y >= e[5 + ph + i]) continue;
            for (int j = 0; j < pw; ++j) {
              if (x < e[5 + 2 * ph + j] || x >= e[5 + 2 * ph + pw + j]) continue;
              const long long o = base + (long long)i * pw + j;
              const int cnt = count[o];
              if (cnt > 0 && v == widen(out[o])) {
                // g / count in the data's type (JAX divides in it), summed in float32
                const float term = widen(narrow<T>(__fdiv_rn(widen(gy[o]), (float)cnt)));
                acc = __fadd_rn(acc, term);
              }
            }
          }
        }
      }
      if (mine) grad[pix] = narrow<T>(acc);
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

// The geometry table in `table` (one thread a roi); returns the table's parts.
template <class T>
void launch_geom(const void* rois, int* table, long long nrois, int n, int h, int w,
                 int ph, int pw, float scale, cudaStream_t stream) {
  const int grid = (int)((nrois + kThreads - 1) / kThreads);
  roi_geom_kernel<T><<<grid, kThreads, 0, stream>>>((const T*)rois, table, nrois, n, h,
                                                    w, ph, pw, scale);
}

template <class T>
int launch_fwd(const void* data, const void* rois, int* table, void* out, int* count,
               int n, int c, int h, int w, long long nrois, int ph, int pw, float scale,
               cudaStream_t stream) {
  const long long total = nrois * c * ph * pw;
  if (total == 0) return 0;
  launch_geom<T>(rois, table, nrois, n, h, w, ph, pw, scale, stream);
  const int* ys = table + nrois;
  const int* xs = ys + 2 * nrois * ph;
  roi_pool_fwd_kernel<T><<<grid_for(total), kThreads, 0, stream>>>(
      (const T*)data, table, ys, ys + nrois * ph, xs, xs + nrois * pw, (T*)out, count, c,
      h, w, total, ph, pw);
  return (int)cudaGetLastError();
}

template <class T>
int launch_bwd(const void* data, const void* rois, int* table, const void* out,
               const int* count, const void* gy, void* dx, int n, int c, int h, int w,
               long long nrois, int ph, int pw, float scale, cudaStream_t stream) {
  const long long planes = (long long)n * c;
  if (planes == 0 || h * w == 0) return 0;
  const int per = table_ints(ph, pw);
  if (per > kTableInts) return (int)cudaErrorInvalidValue;
  const long long chunk = nrois < kTableInts / per ? (nrois > 0 ? nrois : 1)
                                                   : kTableInts / per;
  if (nrois > 0) launch_geom<T>(rois, table, nrois, n, h, w, ph, pw, scale, stream);
  const int* ys = table + nrois;
  const int* xs = ys + 2 * nrois * ph;
  // one block a (image, channel) plane, at most eight blocks an SM
  const long long cap = grid_for(1LL << 40);
  const int grid = (int)(planes < cap ? planes : cap);
  roi_pool_bwd_kernel<T><<<grid, kThreads, chunk * per * sizeof(int), stream>>>(
      (const T*)data, table, ys, ys + nrois * ph, xs, xs + nrois * pw, (const T*)out,
      count, (const T*)gy, (T*)dx, n, c, h, w, nrois, ph, pw, (int)chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roi_pool_fwd(const void* data, const void* rois, int* table, void* out,
                            int* count, int n, int c, int h, int w, long long nrois,
                            int ph, int pw, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_fwd<float>(data, rois, table, out, count, n, c, h, w, nrois, ph, pw,
                               scale, s);
    case 1:
      return launch_fwd<__nv_bfloat16>(data, rois, table, out, count, n, c, h, w, nrois,
                                       ph, pw, scale, s);
    case 2:
      return launch_fwd<__half>(data, rois, table, out, count, n, c, h, w, nrois, ph, pw,
                                scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int roi_pool_bwd(const void* data, const void* rois, int* table,
                            const void* out, const int* count, const void* gy, void* dx,
                            int n, int c, int h, int w, long long nrois, int ph, int pw,
                            float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_bwd<float>(data, rois, table, out, count, gy, dx, n, c, h, w, nrois,
                               ph, pw, scale, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(data, rois, table, out, count, gy, dx, n, c, h, w,
                                       nrois, ph, pw, scale, s);
    case 2:
      return launch_bwd<__half>(data, rois, table, out, count, gy, dx, n, c, h, w, nrois,
                                ph, pw, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
