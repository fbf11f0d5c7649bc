// Float32-accurate products on Hopper's tensor cores ("3xTF32"), and the asynchronous copies
// that feed them: the warp-level pieces shared by the GEMM tile (gemm_tile.cuh: K3 and K1)
// and flash attention (flash_attn.cu: K2).
//
// The numerics contract of the port is float32: K3 and K1 within 1e-6 * sum|a||b| of a
// float64 product, K2 within rtol 2e-4 / atol 2e-5 of its plain version. One TF32 pass keeps
// 10 mantissa bits (relative error 2^-11) and breaks both. So every operand x is split as
// x = hi + lo, hi = tf32(x) (round to nearest, ties away), lo = x - hi (see split), and
// a product takes three m16n8k8 TF32 MMAs into one float32 fragment, the small terms
// first: hi*lo, lo*hi, then hi*hi (lo*lo, <= 2^-22 relative, is dropped), as CUTLASS's
// OpMultiplyAddFastF32 orders them (cutlass/gemm/warp/mma_tensor_op_fast_f32.h); the
// fragment is added to the running sum on the CUDA cores (see add).
//
// mma.sync and not wgmma: wgmma takes TF32 operands only K-major from shared memory, while
// here each fragment is read from a plain float32 tile in shared memory, whatever its
// layout, and split in registers right before its products.
//
// Fragment layouts of mma.m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A tile held row by row ([row][k], rows 16-byte aligned) gives its A fragment, and a tile
// held [n][k] two B fragments, with one ldmatrix.x4: an 8 x 8 matrix of 16-bit values is an
// 8 x 4 matrix of 32-bit ones, and ldmatrix hands thread l word l % 4 of row l / 4. Tiles
// held [k][row] or [k][n] are read with plain 32-bit shared loads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// ---- the split and the product --------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero: the low 13
// bits cleared after adding half of them to the magnitude, in two integer instructions.
// This is cvt.rna.tf32.f32 for every finite x that does not round past the largest float
// (an infinite or NaN x gives a NaN lo below, as with cvt), which the compiler expands on
// sm_90a into a compare and a select around the same rounding.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x), and lo = x - hi exactly (|lo| <= 2^-11 |x|), left for the MMA,
// which reads a TF32 operand's top 19 bits and so truncates lo to 2^-21 |x|. Rounding lo
// first (to 2^-22 |x|) costs two more instructions a value; on an H100 it moved K3's worst
// error only from 3.7e-7 to 3.5e-7 of sum|a||b| (bound 1e-6).
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = to_tf32(f);
  lo = __float_as_uint(__fsub_rn(f, __uint_as_float(hi)));
}

// N 32-bit fragment registers of an operand, split.
template <int N>
struct Split {
  uint32_t hi[N];
  uint32_t lo[N];
};

template <int N>
__device__ __forceinline__ void split(const uint32_t (&x)[N], Split<N>& s) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], s.hi[i], s.lo[i]);
}

// d += a * b, one m16n8k8 TF32 MMA with a float32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b to float32 accuracy: hi*lo, lo*hi, hi*hi, in that order, chained into d.
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  mma(d, a.hi, b.lo);
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.hi);
}

// The tensor cores add into their float32 accumulator with truncation, not rounding to
// nearest, so a long chain of MMAs into one accumulator drifts one way: products chained
// along all of K missed K3's contract at (100352, 64, 576). So the products of a short run
// (one BK-deep step of a GEMM, one key tile of attention) chain into a fragment that starts
// at zero, and add() puts that fragment into the running sum on the CUDA cores, rounding to
// nearest: each truncation stays relative to one short run's sum.

// d += p, rounding to nearest.
__device__ __forceinline__ void add(float (&d)[4], const float (&p)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], p[i]);
}

// ---- fragments from shared memory -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The A fragment of the 16 x 8 block at p of a tile held [row][k] with row stride s floats
// (rows 16-byte aligned).
__device__ __forceinline__ void frag_a_rows(const float* p, int s, uint32_t (&a)[4]) {
  const int l = threadIdx.x & 31;
  const float* q = p + ((l & 7) + ((l >> 3) & 1) * 8) * s + (l >> 4) * 4;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(q)));
}

// The A fragment of the 16 x 8 block at p of a tile held [k][row] with row stride s floats.
__device__ __forceinline__ void frag_a_kmajor(const float* p, int s, uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = __float_as_uint(p[t * s + g]);
  a[1] = __float_as_uint(p[t * s + g + 8]);
  a[2] = __float_as_uint(p[(t + 4) * s + g]);
  a[3] = __float_as_uint(p[(t + 4) * s + g + 8]);
}

// The B fragments of the two 8 x 8 blocks at p (n 0-7 into b[0..1], n 8-15 into b[2..3]) of a
// tile held [n][k] with row stride s floats (rows 16-byte aligned).
__device__ __forceinline__ void frag_b2_rows(const float* p, int s, uint32_t (&b)[4]) {
  const int l = threadIdx.x & 31;
  const float* q = p + ((l & 7) + (l >> 4) * 8) * s + ((l >> 3) & 1) * 4;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(q)));
}

// The B fragment of the 8 x 8 block at p of a tile held [k][n] with row stride s floats.
__device__ __forceinline__ void frag_b_kmajor(const float* p, int s, uint32_t (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  b[0] = __float_as_uint(p[t * s + g]);
  b[1] = __float_as_uint(p[(t + 4) * s + g]);
}

// ---- asynchronous copies --------------------------------------------------------------------

// 16 bytes from global to shared memory (both 16-byte aligned), or 16 zero bytes when !valid
// (nothing is read then; src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the ROWS x COLS block at (row0, col0) of the row-major matrix g (leading dimension ld)
// into shared memory s (row stride SS floats) with the NT threads of a block, zeros outside
// rows < rend and cols < cend: 16-byte pieces when vec (rows 16-byte aligned, and cend and
// col0 multiples of 4, so a piece is wholly inside or wholly outside), else 4-byte pieces.
template <int ROWS, int COLS, int SS, int NT>
__device__ __forceinline__ void copy_tile(float* s, const float* __restrict__ g, long long ld,
                                          int row0, int rend, int col0, int cend, bool vec) {
  constexpr int CPR = COLS / 4;  // 16-byte pieces a row
  static_assert((ROWS * CPR) % NT == 0, "tile does not divide among the threads");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CPR, c = (e % CPR) * 4;
    const int gr = row0 + r, gc = col0 + c;
    float* d = s + r * SS + c;
    const float* src = g + (long long)gr * ld + gc;
    if (vec) {
      const bool ok = gr < rend && gc < cend;
      cp_async16(d, ok ? src : g, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gr < rend && gc + j < cend;
        cp_async4(d + j, ok ? src + j : g, ok);
      }
    }
  }
}

}  // namespace tf32x3
