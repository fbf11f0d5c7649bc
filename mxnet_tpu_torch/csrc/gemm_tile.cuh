// The tiled float32-accurate GEMM shared by the convolution-backward GEMM (conv_gemm.cu, K3)
// and the fused linear layer (linear.cu, K1): tile sizes, the tensor-core mainloop, the
// split-K rule and the in-order split-K sum. Each kernel supplies its own operand feed (which
// global block of A and B a K step reads, and in which layout it lands in shared memory) and
// its own epilogue; the kernels keep their own names, so a profile still tells them apart.
//
//  * A block of 8 warps computes a BM x BN tile of the output (128 x 128, or 128 x 64 when
//    N <= 64, so half a tile is not wasted on masked columns). The warps stand 2 x 4 (64 x 32
//    each) or, for BN = 64, 4 x 2 (32 x 32 each); a warp's tile is MI x NI m16n8k8 products.
//  * The products run on the tensor cores at float32 accuracy: each fragment is read from a
//    float32 tile in shared memory, split into TF32 hi and lo parts in registers and
//    multiplied as hi*lo + lo*hi + hi*hi (tf32x3.cuh). Operands that are exact in TF32
//    (bfloat16, widened) take the hi*hi product alone. A step's products chain into a
//    fragment from zero, which is then added to the accumulator with rounding to nearest.
//  * A ring of STAGES shared-memory stages of BK = 32 along K, fed by cp.async: the loads of
//    the next STAGES - 1 steps are in flight while one step is multiplied; one __syncthreads
//    a step. An operand whose rows are 16-byte aligned is copied in 16-byte pieces, any other
//    (a stride that is not a multiple of 4 floats, as the stem's M = 7 * 7 * 3 = 147) in
//    4-byte pieces; outside the operand and [kbeg, kend) the copy writes zeros.
//  * Tiles lie in shared memory as they lie in global memory, padded against bank
//    conflicts: held [row][k] (a row-major A, K1's w) with rows of BK + 4 floats, whose
//    fragments ldmatrix reads, or [k][row] (A^T, a row-major B) with rows of ROWS + 8 floats,
//    read by 32-bit loads.
//  * A kernel may take a narrower tile with fewer warps (TM x BN by NW warps; K1's small
//    layers take 32 x 64 by 4): every warp's tile stays 32 columns wide, and a product's
//    arithmetic for one output element does not depend on the tile.
//  * Split K for products with few output tiles and a long K: blockIdx.z takes one K range.
//    K3 writes its partial tile to a (splits, M, N) float32 scratch that the caller
//    allocates, and a second launch sums the splits in a fixed order (splitk_reduce); K1
//    sums them in the same order across a thread block cluster (linear.cu). A rerun is
//    bit-identical.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace gemm_tile {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int NT = 256;       // threads of a block: 8 warps
constexpr int STAGES = 3;     // shared-memory stages of the copy ring
constexpr int MIN_BLOCKS = 1; // blocks an SM (__launch_bounds__): up to 255 registers
constexpr int kMaxSplits = 256;
constexpr int kReduceThreads = 256;

// The warp grid of a TM x BN tile computed by NW warps.
template <int BN, int TM = BM, int NW = 8>
struct Warps {
  static constexpr int N = BN / 32;       // warps along N
  static constexpr int M = NW / N;        // warps along M
  static constexpr int WM = TM / M;       // rows of a warp's tile
  static constexpr int WN = 32;           // columns of a warp's tile
  static constexpr int MI = WM / 16;      // m16 products along M
  static constexpr int NI = WN / 8;       // n8 products along N
  static_assert(M * N == NW && WM % 16 == 0, "the warps do not tile the block");
};

// A BK-deep tile of ROWS rows (A's m, B's n) held [row][k] or, KMAJOR, [k][row].
template <bool KMAJOR, int ROWS>
struct Tile {
  static constexpr int stride = KMAJOR ? ROWS + 8 : BK + 4;
  static constexpr int floats = KMAJOR ? BK * stride : ROWS * stride;
};

template <int BN, bool A_KMAJOR, bool B_KMAJOR, int TM = BM>
struct Smem {
  using A = Tile<A_KMAJOR, TM>;
  using B = Tile<B_KMAJOR, BN>;
  static constexpr int stage = A::floats + B::floats;
  static constexpr size_t bytes = sizeof(float) * (size_t)STAGES * stage;
};

inline int num_sms() {
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

inline int tile_n(long long n) { return n <= 64 ? 64 : 128; }

// The K range each split of an (m, n, k) product takes on the current device, a multiple
// of BK. A product with at least one wave of output tiles (MIN_BLOCKS an SM) is not split.
// Otherwise it is split so that its blocks fill at least one wave and waste the least of
// their last one: the fewest splits of those whose blocks fill whole waves best, among one
// to four times the least, each split at least min_split long, at most kMaxSplits of them.
inline long long k_chunk(long long m, long long n, long long k, long long min_split) {
  if (m <= 0 || n <= 0 || k <= 0) return BK;
  const long long tiles = ((m + BM - 1) / BM) * ((n + tile_n(n) - 1) / tile_n(n));
  const long long slots = (long long)MIN_BLOCKS * num_sms();
  long long splits = 1;
  if (tiles < slots) {
    long long most = k / min_split;
    if (most > kMaxSplits) most = kMaxSplits;
    const long long least = (slots + tiles - 1) / tiles;
    if (least >= most) {
      splits = most > 1 ? most : 1;
    } else {
      long long best_used = -1;  // blocks / (waves * slots), compared as a cross product
      long long best_waves = 1;
      for (long long s = least; s <= most && s <= 4 * least; ++s) {
        const long long blocks = tiles * s;
        const long long waves = (blocks + slots - 1) / slots;
        if (best_used < 0 || blocks * best_waves > best_used * waves) {
          best_used = blocks;
          best_waves = waves;
          splits = s;
        }
      }
    }
  }
  const long long per = (k + splits - 1) / splits;
  return (per + BK - 1) / BK * BK;
}

// Whether rows of leading dimension ld starting at p can be copied in 16-byte pieces.
template <typename T>
__host__ __device__ inline bool rows_aligned16(const T* p, long long ld) {
  return (ld * (long long)sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Copy the ROWS x COLS block at (row0, col0) of a row-major float32 matrix into a stage by
// cp.async with the NTH threads of a block, zeros outside it (tf32x3::copy_tile).
template <int ROWS, int COLS, int SS, int NTH = NT>
__device__ __forceinline__ void copy_tile(float* s, const float* __restrict__ g, long long ld,
                                          int row0, int rend, int col0, int cend, bool vec) {
  tf32x3::copy_tile<ROWS, COLS, SS, NTH>(s, g, ld, row0, rend, col0, cend, vec);
}

// The same for bfloat16, loaded through registers and widened (exact) into a float32 tile.
template <int ROWS, int COLS, int SS>
__device__ __forceinline__ void copy_tile(float* s, const __nv_bfloat16* __restrict__ g,
                                          long long ld, int row0, int rend, int col0, int cend,
                                          bool) {
  constexpr int CPR = COLS / 4;
  static_assert((ROWS * CPR) % NT == 0, "tile does not divide among the threads");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CPR, c = (e % CPR) * 4;
    const int gr = row0 + r, gc = col0 + c;
    const __nv_bfloat16* src = g + (long long)gr * ld + gc;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (gr < rend && gc + j < cend) ? __bfloat162float(src[j]) : 0.f;
    *reinterpret_cast<float4*>(s + r * SS + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// acc = A[:, kbeg:kend] @ B[kbeg:kend, :] for the block's TM x BN tile, NW warps. load(As,
// Bs, k0) copies the K step at k0 into a stage's A and B tiles (copy_tile), zero outside the
// operands and [kbeg, kend); it may issue cp.async copies, which the loop commits and waits
// for. EXACT: the operands are exact in TF32, one product a fragment.
template <int BN, bool A_KMAJOR, bool B_KMAJOR, bool EXACT, int TM = BM, int NW = 8,
          typename Load>
__device__ __forceinline__ void mainloop(
    float* smem, Load&& load, int kbeg, int kend,
    float (&acc)[Warps<BN, TM, NW>::MI][Warps<BN, TM, NW>::NI][4]) {
  using W = Warps<BN, TM, NW>;
  using S = Smem<BN, A_KMAJOR, B_KMAJOR, TM>;
  constexpr int SA = S::A::stride, SB = S::B::stride;
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
    if (s < ntiles) load(smem + s * S::stage, smem + s * S::stage + S::A::floats, kbeg + s * BK);
    tf32x3::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t is in place; every warp is done with step t - 1's stage
    {
      const int nt = t + STAGES - 1;
      float* st = smem + (nt % STAGES) * S::stage;
      if (nt < ntiles) load(st, st + S::A::floats, kbeg + nt * BK);
      tf32x3::cp_async_commit();
    }
    const float* As = smem + (t % STAGES) * S::stage;
    const float* Bs = As + S::A::floats;
    // the step's B fragments, split once
    constexpr int KS = BK / 8;
    tf32x3::Split<2> b[KS][W::NI];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t braw[W::NI][2];
#pragma unroll
      for (int j = 0; j < W::NI; ++j) {
        if constexpr (B_KMAJOR) {
          tf32x3::frag_b_kmajor(Bs + ks * 8 * SB + wn + j * 8, SB, braw[j]);
        } else if (j % 2 == 0) {
          uint32_t b4[4];
          tf32x3::frag_b2_rows(Bs + (wn + j * 8) * SB + ks * 8, SB, b4);
          braw[j][0] = b4[0];
          braw[j][1] = b4[1];
          braw[j + 1][0] = b4[2];
          braw[j + 1][1] = b4[3];
        }
      }
#pragma unroll
      for (int j = 0; j < W::NI; ++j) {
        if constexpr (EXACT) {
          b[ks][j].hi[0] = braw[j][0];
          b[ks][j].hi[1] = braw[j][1];
        } else {
          tf32x3::split(braw[j], b[ks][j]);
        }
      }
    }
    // a row of m16 blocks at a time: the step's products chain into p from zero, then
    // into acc with rounding to nearest
#pragma unroll
    for (int i = 0; i < W::MI; ++i) {
      float p[W::NI][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t araw[4];
        if constexpr (A_KMAJOR)
          tf32x3::frag_a_kmajor(As + ks * 8 * SA + wm + i * 16, SA, araw);
        else
          tf32x3::frag_a_rows(As + (wm + i * 16) * SA + ks * 8, SA, araw);
        if constexpr (EXACT) {
#pragma unroll
          for (int j = 0; j < W::NI; ++j) tf32x3::mma(p[j], araw, b[ks][j].hi);
        } else {
          tf32x3::Split<4> a;
          tf32x3::split(araw, a);
#pragma unroll
          for (int j = 0; j < W::NI; ++j) tf32x3::mma3(p[j], a, b[ks][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < W::NI; ++j) tf32x3::add(acc[i][j], p[j]);
    }
  }
  tf32x3::cp_async_wait<0>();
}

// st(m, n, acc[.][.][r], acc[.][.][r + 1]) for every pair of neighbouring columns (n even)
// a thread holds, at the block tile's origin (m0, n0).
template <int BN, int TM = BM, int NW = 8, typename Store>
__device__ __forceinline__ void for_each_pair(
    const float (&acc)[Warps<BN, TM, NW>::MI][Warps<BN, TM, NW>::NI][4], int m0, int n0,
    Store&& st) {
  using W = Warps<BN, TM, NW>;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int rm = m0 + (warp / W::N) * W::WM + g;
  const int cn = n0 + (warp % W::N) * W::WN + 2 * t;
#pragma unroll
  for (int i = 0; i < W::MI; ++i)
#pragma unroll
    for (int j = 0; j < W::NI; ++j) {
      st(rm + i * 16, cn + j * 8, acc[i][j][0], acc[i][j][1]);
      st(rm + i * 16 + 8, cn + j * 8, acc[i][j][2], acc[i][j][3]);
    }
}

// out[i] = epi(sum over z of ws[z][i], z in order, i) for i < mn: the body of a split-K
// reduce kernel (grid-stride over kReduceThreads-thread blocks).
template <typename Epi>
__device__ __forceinline__ void splitk_reduce(const float* __restrict__ ws,
                                              float* __restrict__ out, long long mn, int splits,
                                              Epi epi) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn; i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[(long long)z * mn + i]);
    out[i] = epi(s, i);
  }
}

// Blocks of a split-K reduce over mn outputs: one thread an output, at most four blocks an
// SM (grid-stride beyond).
inline unsigned int reduce_blocks(long long mn) {
  long long blocks = (mn + kReduceThreads - 1) / kReduceThreads;
  const long long cap = 4LL * num_sms();
  return (unsigned int)(blocks > cap ? cap : blocks);
}

}  // namespace gemm_tile
