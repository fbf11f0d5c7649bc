// The 16-bit mainloop of the convolution-backward GEMM (conv_gemm.cu, K3), written for
// Hopper: C = A @ B or C = A^T @ B with bfloat16 or float16 operands, exact products,
// float32 sums and a float32 output, as the TPU kernel `_matmul`
// (mxnet_tpu/ops/pallas_kernels.py:319) computes them from bfloat16 operands under
// `compute_dtype` (`preferred_element_type=jnp.float32`).
//
// What bounds it on an H100: bytes. Summed over a ResNet-50 step the 105 products move
// 5.4 GB (1.61 ms at 3.35 TB/s) for 0.64 TFLOP (0.65 ms at 989 TFLOP/s): most are a
// skinny pass over one large im2col operand (input gradients with M = 25,088-100,352 and
// N = 64-256; weight gradients with K = 6,272-401,408, split along K). So the design keeps
// many bytes in flight and spends no thread on moving them:
//  * Loads are TMA: one thread asks for whole tiles, which land in shared memory in the
//    128-byte swizzle that wgmma reads, into a ring of STAGES stages of BK = 64 (24-32 KB
//    a stage, 192 KB in flight an SM). Each stage has a `full` mbarrier (the producer's
//    expected bytes, completed by the TMA unit) and an `empty` one (one arrival from each
//    consumer warpgroup when its products have read the stage). Boxes outside the
//    operand are filled with zeros by the TMA unit: ragged M, N and K edges need no masked
//    copy, only masked stores.
//  * Warp specialisation: a block is three warpgroups. The third is the producer: one of
//    its threads issues every load, and the warpgroup gives up registers (setmaxnreg) to
//    the two consumers, each of which owns 64 rows of the 128-row tile and runs
//    wgmma.mma_async m64nNk16 (N = BN = 64 or 128, gemm_tile::tile_n) on the stages that
//    have arrived.
//  * Transposes: wgmma reads 16-bit operands K-major or MN-major (its transpose bits). A
//    row-major A (M, K) is K-major; A^T of the weight gradient, a (K, M) row-major patch
//    matrix, and B, (K, N) row-major, are MN-major. Each goes in as it lies in memory, and
//    no transpose is ever materialised.
//  * Persistent blocks: one block an SM walks the work units (output tile and split-K
//    slice) in a static order, block b taking units b, b + grid, ...; the producer runs on
//    into the next unit's loads while the consumers store the last one. The order is
//    fixed, so no output's sum depends on scheduling.
//  * Accuracy: the tensor cores truncate when they add, so a K block's four k16 products
//    chain into a fragment from zero (scale-d = 0 on the first), which after
//    wgmma.wait_group is added to the float32 accumulator with rounding to nearest, as
//    the float32 path (tf32x3.cuh) does a step's products. Two fragments take turns, so
//    the next K block's products run while the last one's fragment joins the sum.
//  * Split K (weight gradients: few output tiles, long K) by a cost model of this kernel
//    (k_chunk below): bytes against waves of units, the scratch's traffic counted, so a
//    product is split only where the card would otherwise idle; slices write a (splits,
//    M, N) float32 scratch that conv_gemm_splitk_reduce_kernel sums in a fixed order. A
//    rerun is bit-identical.
//  * TMA needs 16-byte aligned rows: the leading dimensions are the caller's (lda, ldb, in
//    elements, multiples of 8), so an operand of odd width (the stem's M = 7 * 7 * 3 = 147)
//    arrives at a padded pitch whose pad is never read.
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled, taken from the driver
// through cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_tile.cuh"

namespace gemm16 {

constexpr int BM = 128;            // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 64;             // K of a stage: one 128-byte swizzle row of 16-bit values
constexpr int NT = 384;            // threads: consumer warpgroups 0 and 1, producer 2
constexpr int kConsumers = 2;
constexpr int kProducerRegs = 40;  // setmaxnreg of the producer warpgroup
constexpr int kConsumerRegs = 232; // and of the consumers: 128 * 40 + 256 * 232 <= 65,536
constexpr int kBox = 64;           // MN extent of one MN-major box (128 bytes)
constexpr int kBoxBytes = kBox * BK * 2;

static_assert(BM == gemm_tile::BM, "tiles are counted as gemm_tile counts them for k_chunk");

template <int BN>
struct Ring {
  static constexpr int a_bytes = BM * BK * 2;              // 16 KB
  static constexpr int b_bytes = BN * BK * 2;              // 16 or 8 KB
  static constexpr int stage = a_bytes + b_bytes;
  static constexpr int stages = (192 * 1024) / stage;      // 6 or 8
  // the tiles (1024-byte aligned for the swizzle), then 2 * stages mbarriers, plus the
  // slack to align the dynamic shared memory's base
  static constexpr size_t bytes = (size_t)stages * stage + 16 * stages + 1024;
  static_assert(stage % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
};

// ---------------------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (c0 along the contiguous axis, c1 along rows) of the map into shared memory
// at dst, completing its bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at shared address a:
// lbo and sbo in bytes (K-major: sbo the stride of 8-row groups, lbo unused; MN-major:
// lbo the stride of 64-element MN blocks, sbo that of 8-deep K groups).
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins a register array in place around the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define GEMM16_WGMMA_N64(TY)                                                                 \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"               \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"    \
      " %32, %33, p, 1, 1, %35, 1;\n}\n"                                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
        "+f"(d[31])                                                                          \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA))

#define GEMM16_WGMMA_N128(TY)                                                                \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"               \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"     \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"     \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"    \
      " %64, %65, p, 1, 1, %67, 1;\n}\n"                                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                                \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA))

// d (+)= A(da) @ B(db), one m64nBNk16 product of 16-bit operands of type T with a float32
// fragment; d is overwritten when scale_d is 0. A is MN-major when TA, B always is.
template <typename T, int BN, int TA>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                      int scale_d) {
  static_assert(std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value,
                "bfloat16 or float16 operands");
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (BN == 64) {
    if constexpr (bf) GEMM16_WGMMA_N64("bf16");
    else GEMM16_WGMMA_N64("f16");
  } else {
    static_assert(BN == 128, "tiles 64 or 128 wide");
    if constexpr (bf) GEMM16_WGMMA_N128("bf16");
    else GEMM16_WGMMA_N128("f16");
  }
}

#undef GEMM16_WGMMA_N64
#undef GEMM16_WGMMA_N128

// ---------------------------------------------------------------------------------------
// The work: units of (output tile, K slice), walked in a static order
// ---------------------------------------------------------------------------------------
struct Unit {
  int m0, n0, z, kbeg, nkb;  // tile origin, slice, its first K and its K blocks
};

template <int BN>
__device__ __forceinline__ Unit unit_at(long long u, int M, int N, int K, int k_chunk) {
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  Unit w;
  const long long r = u / tiles_n;
  w.n0 = (int)(u % tiles_n) * BN;   // n fastest: a tile row's blocks share A's panel in L2
  w.m0 = (int)(r % tiles_m) * BM;
  w.z = (int)(r / tiles_m);
  w.kbeg = w.z * k_chunk;
  const int kend = min(K, w.kbeg + k_chunk);
  w.nkb = (kend - w.kbeg + BK - 1) / BK;
  return w;
}

// The body of a kernel of NT threads, one block an SM, with Ring<BN>::bytes of dynamic
// shared memory at smem_raw: C[z] = op(A)[:, slice z] @ B[slice z, :] for every unit; C[z]
// is C itself when there is one split, else slice z of the scratch. map_a holds A (M, K)
// row-major in boxes of BK x BM, or, TRANS_A, (K, M) row-major in boxes of 64 x BK; map_b
// holds B (K, N) in boxes of 64 x BK; both are the kernel's __grid_constant__ parameters.
// T is __nv_bfloat16 or __half.
template <typename T, int BN, bool TRANS_A>
__device__ __forceinline__ void gemm(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                     float* __restrict__ C, int M, int N, int K, int k_chunk,
                                     long long units, uint8_t* smem_raw) {
  using R = Ring<BN>;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + R::stages * R::stage;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * R::stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread issues every load, stage after stage, unit after unit
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at<BN>(u, M, N, K, k_chunk);
        for (int kb = 0; kb < w.nkb; ++kb) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, R::stage);
          const int k0 = w.kbeg + kb * BK;
          const uint32_t sa = base + stage * R::stage, sb = sa + R::a_bytes;
          if constexpr (TRANS_A) {
#pragma unroll
            for (int h = 0; h < BM / kBox; ++h)
              tma_load(sa + h * kBoxBytes, &map_a, w.m0 + h * kBox, k0, full);
          } else {
            tma_load(sa, &map_a, k0, w.m0, full);
          }
#pragma unroll
          for (int h = 0; h < BN / kBox; ++h)
            tma_load(sb + h * kBoxBytes, &map_b, w.n0 + h * kBox, k0, full);
          if (++stage == R::stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // a consumer: rows wg * 64 .. wg * 64 + 63 of each unit's tile. Two fragments take
    // turns: K block kb + 1's products are issued before kb's are waited for, so the
    // tensor cores work while kb's fragment joins the sum.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128;
    int issue_stage = 0, free_stage = 0;
    uint32_t issue_phase = 0;
    // the next K block's four k16 products into p, chained from zero
    auto issue = [&](float(&p)[BN / 2]) {
      mbar_wait(full0 + 8 * issue_stage, issue_phase);
      const uint32_t sa = base + issue_stage * R::stage + wg * kBoxBytes;
      const uint32_t sb = base + issue_stage * R::stage + R::a_bytes;
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major A: the next 16 of a 128-byte row are 32 bytes on; MN-major operands:
        // 16 rows of 128 bytes on
        const uint64_t da = TRANS_A ? desc(sa + kk * 2048, kBoxBytes, 1024)
                                    : desc(sa + kk * 32, 16, 1024);
        const uint64_t db = desc(sb + kk * 2048, kBoxBytes, 1024);
        wgmma<T, BN, TRANS_A ? 1 : 0>(p, da, db, kk);
      }
      wgmma_commit();
      if (++issue_stage == R::stages) {
        issue_stage = 0;
        issue_phase ^= 1;
      }
    };
    // the oldest K block's products have landed in p: free its stage, add p to acc
    auto retire = [&](float(&p)[BN / 2], float(&acc)[BN / 2]) {
      fence_regs(p);
      if (t == 0) mbar_arrive(empty0 + 8 * free_stage);
      if (++free_stage == R::stages) free_stage = 0;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
    };
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_at<BN>(u, M, N, K, k_chunk);
      float acc[BN / 2], pa[BN / 2], pb[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      // K blocks in pairs, so that no product is in flight across the loop's back edge
      // (ptxas then sees which fragment each wait completes and keeps them asynchronous)
      int kb = 0;
      for (; kb + 1 < w.nkb; kb += 2) {
        issue(pa);
        issue(pb);
        wgmma_wait<1>();
        retire(pa, acc);
        wgmma_wait<0>();
        retire(pb, acc);
      }
      if (kb < w.nkb) {
        issue(pa);
        wgmma_wait<0>();
        retire(pa, acc);
      }
      // the fragment: warp t / 32 holds rows 16 (t / 32) + (t % 32) / 4 and + 8; n8
      // block j columns 8 j + 2 (t % 4) and + 1 in acc[4 j .. 4 j + 3]
      float* Cz = C + (long long)w.z * M * N;
      const int r0 = w.m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
      const int c0 = w.n0 + 2 * (t % 4);
      const bool vec2 = (N % 2) == 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, c = c0 + 8 * j;
          if (r >= M) continue;
          float* q = Cz + (long long)r * N + c;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (vec2 && c + 1 < N) {
            *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
          } else {
            if (c < N) q[0] = v0;
            if (c + 1 < N) q[1] = v1;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------------------
// The split-K rule's cost model of this kernel on an H100 (ns, bytes): HBM at 3 TB/s in
// all; one SM's tensor cores at 65% of 989 / 132 TFLOP/s, and its loads at 100 bytes a
// ns; a unit's prologue and epilogue; the reduce launch.
constexpr double kBytesPerNs = 3000.0;
constexpr double kSmFlopPerNs = 4900.0;
constexpr double kSmBytesPerNs = 100.0;
constexpr double kUnitNs = 1000.0;
constexpr double kReduceNs = 3000.0;

// The K range each split of an (m, n, k) product takes, a multiple of BK (only the last
// slice has a ragged end, and that one at K, where the TMA unit fills zeros): of 1 to
// k / min_split splits (at most gemm_tile::kMaxSplits), the fewest of those whose
// modelled time is least. The model: the product's bytes at the card's rate (split K adds
// the scratch, written once and read once, and a reduce launch) against the waves of
// units, each its K blocks at the slower of one SM's tensor rate and its load rate. The
// float32 path's rule splits until the card is full, which for this byte-bound kernel can
// triple a mid-size product's bytes.
inline long long k_chunk(long long m, long long n, long long k, long long min_split) {
  if (m <= 0 || n <= 0 || k <= 0) return BK;
  const long long bn = gemm_tile::tile_n(n);
  const long long tiles = ((m + BM - 1) / BM) * ((n + bn - 1) / bn);
  const long long sms = gemm_tile::num_sms();
  const double kb_ns = (double)(BM * bn * BK * 2) / kSmFlopPerNs;
  const double kb_load_ns = (double)((BM + bn) * BK * 2) / kSmBytesPerNs;
  const double kb_unit_ns = kb_ns > kb_load_ns ? kb_ns : kb_load_ns;
  long long most = k / min_split;
  if (most > gemm_tile::kMaxSplits) most = gemm_tile::kMaxSplits;
  if (most < 1) most = 1;
  double best = -1.0;
  long long best_chunk = (k + BK - 1) / BK * BK;
  for (long long s = 1; s <= most; ++s) {
    const long long chunk = ((k + s - 1) / s + BK - 1) / BK * BK;
    const long long splits = (k + chunk - 1) / chunk;
    if (splits != s) continue;  // the same slices as fewer splits
    const long long waves = (tiles * splits + sms - 1) / sms;
    const double unit_ns = (double)(chunk / BK) * kb_unit_ns + kUnitNs;
    double bytes = 2.0 * (double)(m * k + k * n) + 4.0 * (double)(m * n);
    if (splits > 1) bytes += 8.0 * (double)splits * (double)(m * n);
    const double mem_ns = bytes / kBytesPerNs, run_ns = (double)waves * unit_ns;
    const double t = (mem_ns > run_ns ? mem_ns : run_ns) + (splits > 1 ? kReduceNs : 0.0);
    if (best < 0.0 || t < best) {
      best = t;
      best_chunk = chunk;
    }
  }
  return best_chunk;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, or null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess && p != nullptr
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major rows x cols matrix of 16-bit values with leading dimension ld
// (elements; ld * 2 a multiple of 16, p 16-byte aligned), read in boxes of box_rows rows
// by 64 columns (128 bytes, the swizzle's row), zeros outside the matrix.
inline cudaError_t make_map(CUtensorMap* map, bool f16, const void* p, long long rows,
                            long long cols, long long ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      encode(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace gemm16
