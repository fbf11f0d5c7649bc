// The 16-bit mainloop of the convolution-backward GEMM (conv_gemm.cu, K3): C = A @ B or
// C = A^T @ B with bfloat16 or float16 operands, exact products, float32 sums and a float32
// output, as the TPU kernel `_matmul` (mxnet_tpu/ops/pallas_kernels.py:319) computes them
// from bfloat16 operands under `compute_dtype` (`preferred_element_type=jnp.float32`).
//
// What bounds it on an H100: operations, at the tensor cores' dense 16-bit rate (989
// TFLOP/s), twice TF32's and six times that of the 3xTF32 float32 path: a ResNet-50 step's
// products reuse every loaded value BM or BN times, far above the ridge point. So the
// operands go to the tensor cores as they are, never widened:
//  * They stay 16-bit in shared memory, copied by cp.async in 16-byte pieces (8 elements);
//    an operand whose rows are not 16-byte aligned (a stride that is not a multiple of 8
//    elements: the stem's M = 7 * 7 * 3 = 147 is odd, so not even 4-byte pieces line up)
//    is copied one element at a time through registers. Outside the operand and [kbeg, kend)
//    the copy writes zeros.
//  * Tiles lie as in global memory, rows padded by 8 elements (16 bytes) so that the eight
//    16-byte rows an ldmatrix phase reads fall in eight distinct groups of four banks:
//    [m][k] (a row-major A) with rows of BK + 8, or [k][row] (A^T, and B, which is
//    row-major (K, N)) with rows of ROWS + 8.
//  * Fragments are read with ldmatrix.x4, and with ldmatrix.x4.trans from the K-major tiles
//    (A of A^T @ B, whose transpose thus stays folded into the tile loads, and B).
//  * The products are mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}: a 16-bit product is
//    exact in float32. The tensor cores truncate when they add, so, as in the float32 path
//    (tf32x3.cuh), one K step's products (BK = 32: two k16 MMAs) chain into a fragment from
//    zero, which is then added to the accumulator with rounding to nearest.
//  * The block tile (128 x 128, or 128 x 64 when N <= 64), the 8 warps and their 64 x 32 or
//    32 x 32 tiles, the three-stage cp.async ring, BK = 32, the ragged-edge masking and
//    split K with its fixed-order reduce are gemm_tile.cuh's: a rerun is bit-identical.
// wgmma and TMA would reach further toward the 16-bit rate; mma.sync keeps the tile and its
// fragments those of the float32 path.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_tile.cuh"

namespace gemm_tile16 {

using gemm_tile::BK;
using gemm_tile::BM;
using gemm_tile::NT;
using gemm_tile::STAGES;
using gemm_tile::Warps;

// A BK-deep tile of ROWS rows of 16-bit values, held [row][k] or, KMAJOR, [k][row].
template <bool KMAJOR, int ROWS>
struct Tile {
  static constexpr int stride = KMAJOR ? ROWS + 8 : BK + 8;  // elements
  static constexpr int elems = KMAJOR ? BK * stride : ROWS * stride;
  static_assert((elems * 2) % 16 == 0, "a tile must keep the next one 16-byte aligned");
};

// One stage: A (K-major when A_KMAJOR) then B, which is always [k][n].
template <int BN, bool A_KMAJOR>
struct Smem {
  using A = Tile<A_KMAJOR, BM>;
  using B = Tile<true, BN>;
  static constexpr int stage = A::elems + B::elems;  // elements
  static constexpr size_t bytes = 2 * (size_t)STAGES * stage;
};

// Copy the ROWS x COLS block at (row0, col0) of a row-major matrix of 16-bit values
// (leading dimension ld) into s (row stride SS elements), zeros outside rows < rend and
// cols < cend: 16-byte cp.async pieces when vec (rows 16-byte aligned; col0 and cend are then
// multiples of 8, so a piece is wholly inside or wholly outside), else one element a thread
// at a time through registers, stored before the caller's next __syncthreads.
template <int ROWS, int COLS, int SS>
__device__ __forceinline__ void copy_tile(uint16_t* s, const uint16_t* __restrict__ g,
                                          long long ld, int row0, int rend, int col0, int cend,
                                          bool vec) {
  if (vec) {
    constexpr int CPR = COLS / 8;  // 16-byte pieces a row
    static_assert((ROWS * CPR) % NT == 0, "tile does not divide among the threads");
#pragma unroll
    for (int i = 0; i < ROWS * CPR / NT; ++i) {
      const int e = threadIdx.x + i * NT;
      const int r = e / CPR, c = (e % CPR) * 8;
      const int gr = row0 + r, gc = col0 + c;
      const bool ok = gr < rend && gc < cend;
      tf32x3::cp_async16(s + r * SS + c, ok ? g + (long long)gr * ld + gc : g, ok);
    }
  } else {
    static_assert((ROWS * COLS) % NT == 0, "tile does not divide among the threads");
#pragma unroll 4
    for (int i = 0; i < ROWS * COLS / NT; ++i) {
      const int e = threadIdx.x + i * NT;
      const int r = e / COLS, c = e % COLS;
      const int gr = row0 + r, gc = col0 + c;
      s[r * SS + c] = (gr < rend && gc < cend) ? __ldg(g + (long long)gr * ld + gc)
                                               : (uint16_t)0;
    }
  }
}

__device__ __forceinline__ void ldsm_x4(const uint16_t* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tf32x3::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const uint16_t* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tf32x3::smem_addr(p)));
}

// Fragment layouts of mma.m16n8k16 with 16-bit operands (g = lane / 4, t = lane % 4; each
// 32-bit register holds two neighbours along k, the lower k in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
//   B (16 x 8):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
// ldmatrix.x4 hands register i the 8 x 8 matrix whose rows lanes 8i..8i+7 address: thread l
// gets row l / 4, elements 2(l % 4) and 2(l % 4) + 1, or with .trans the transposed pair.

// The A fragment of the 16 x 16 block at p of a tile held [m][k] with row stride s.
__device__ __forceinline__ void frag_a_rows(const uint16_t* p, int s, uint32_t (&a)[4]) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  ldsm_x4(p + ((l & 7) + (mat & 1) * 8) * s + (mat >> 1) * 8, a);
}

// The A fragment of the 16 x 16 block at p (k, m) of a tile held [k][m] with row stride s.
__device__ __forceinline__ void frag_a_kmajor(const uint16_t* p, int s, uint32_t (&a)[4]) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  ldsm_x4_trans(p + ((l & 7) + (mat >> 1) * 8) * s + (mat & 1) * 8, a);
}

// The B fragments of the two 16 x 8 blocks at p (k, n) and p + 8 (n 8-15) of a tile held
// [k][n] with row stride s: b0 = b[0..1], b1 = b[2..3].
__device__ __forceinline__ void frag_b2_kmajor(const uint16_t* p, int s, uint32_t (&b)[4]) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  ldsm_x4_trans(p + ((l & 7) + (mat & 1) * 8) * s + (mat >> 1) * 8, b);
}

// d += a * b, one m16n8k16 MMA with 16-bit operands of type T and a float32 accumulator.
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    static_assert(std::is_same<T, __nv_bfloat16>::value, "bfloat16 or float16 operands");
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// acc = A[:, kbeg:kend] @ B[kbeg:kend, :] for the block's BM x BN tile with 16-bit operands of
// type T. load(As, Bs, k0) copies the K step at k0 into a stage's A and B tiles (copy_tile),
// zero outside the operands and [kbeg, kend); it may issue cp.async copies, which the loop
// commits and waits for, or store through registers. The accumulator's layout is
// gemm_tile::mainloop's, so gemm_tile::for_each_pair stores it.
template <typename T, int BN, bool A_KMAJOR, typename Load>
__device__ __forceinline__ void mainloop(uint16_t* smem, Load&& load, int kbeg, int kend,
                                         float (&acc)[Warps<BN>::MI][Warps<BN>::NI][4]) {
  using W = Warps<BN>;
  using S = Smem<BN, A_KMAJOR>;
  constexpr int SA = S::A::stride, SB = S::B::stride;
  static_assert(W::NI % 2 == 0, "B fragments are read two n8 blocks at a time");
#pragma unroll
  for (int i = 0; i < W::MI; ++i)
#pragma unroll
    for (int j = 0; j < W::NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int warp = threadIdx.x >> 5;
  const int wm = (warp / W::N) * W::WM;
  const int wn = (warp % W::N) * W::WN;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(smem + s * S::stage, smem + s * S::stage + S::A::elems, kbeg + s * BK);
    tf32x3::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t is in place; every warp is done with step t - 1's stage
    {
      const int nt = t + STAGES - 1;
      uint16_t* st = smem + (nt % STAGES) * S::stage;
      if (nt < ntiles) load(st, st + S::A::elems, kbeg + nt * BK);
      tf32x3::cp_async_commit();
    }
    const uint16_t* As = smem + (t % STAGES) * S::stage;
    const uint16_t* Bs = As + S::A::elems;
    constexpr int KS = BK / 16;
    uint32_t b[KS][W::NI][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < W::NI; j += 2) {
        uint32_t b4[4];
        frag_b2_kmajor(Bs + ks * 16 * SB + wn + j * 8, SB, b4);
        b[ks][j][0] = b4[0];
        b[ks][j][1] = b4[1];
        b[ks][j + 1][0] = b4[2];
        b[ks][j + 1][1] = b4[3];
      }
    // a row of m16 blocks at a time: the step's products chain into p from zero, then into
    // acc with rounding to nearest
#pragma unroll
    for (int i = 0; i < W::MI; ++i) {
      float p[W::NI][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        if constexpr (A_KMAJOR)
          frag_a_kmajor(As + ks * 16 * SA + wm + i * 16, SA, a);
        else
          frag_a_rows(As + (wm + i * 16) * SA + ks * 16, SA, a);
#pragma unroll
        for (int j = 0; j < W::NI; ++j) mma<T>(p[j], a, b[ks][j]);
      }
#pragma unroll
      for (int j = 0; j < W::NI; ++j) tf32x3::add(acc[i][j], p[j]);
    }
  }
  tf32x3::cp_async_wait<0>();
}

}  // namespace gemm_tile16
