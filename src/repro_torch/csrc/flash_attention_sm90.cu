// Flash attention with GQA and causal masking on Hopper's tensor cores
// (sm_90a: wgmma, TMA, mbarriers, warp specialisation): the route for
// bfloat16 storage at head dims 64 and 128.  float32 storage, and
// bfloat16 at head dims 16 and 32, take flash_attention.cu.
//
// Replaces: src/repro/kernels/attention/attention.py:88,
//   flash_attention_pallas (body _kernel) -- the TPU kernel whose grid
//   (G, Tq/bq, Tk/bk) carries a running max m, denominator l and f32
//   accumulator in VMEM scratch across the sequential key axis.
//
// Computes, per query head g and row t (head-folded q (G, Tq, d), k/v
// (Gkv, Tk, d), KV head (g / Hq) Hkv + (g % Hq) / (Hq / Hkv)):
//   o[t] = sum_j softmax_j(scale q[t].k[j]) v[j]
// with the reference's constants, as flash_attention.cu states them:
// q_offset = Tk - Tq, the per-row key limit K_lim of the caller's blocks
// (key_limit in common.cuh), -inf at or past K_lim, -1e30 for causally
// masked keys below it, l == 0 replaced by 1.  Scores are exact bf16
// products summed in f32, as in the reference.  p is rounded to bf16 for
// the PV product -- as the reference's xla attention rounds it
// (p.astype(v.dtype)) -- while l sums the unrounded f32 p; O accumulates
// in f32 and is rounded to bf16 once, after the division by l.  Given a
// non-null `lse` (G, Tq) float32, it also writes each row's m + log(l) in
// natural units for the backward (flash_attention_bwd.cu); the output is
// the same either way.
//
// Bound on an H100 SXM: operations.  At B = 4, Hq = 16, Hkv = 8,
// T = 4096, d = 128, causal, the call reads q, k, v and writes o once
// (201 MB, 0.06 ms at 3.35 TB/s) but does 4 G d sum_t(keys row t sees)
// = 274.9 GFLOP, 0.278 ms at the 989 TFLOP/s bf16 tensor-core peak.
// Only the tensor cores can approach that, so both products are wgmma
// and everything else is arranged to keep them fed:
//
// - One CTA of 384 threads per (query head, tile of 128 query rows); the
//   grid's y axis walks the query tiles last to first, so the longest
//   causal rows start first.  Warpgroup 0 is the producer: it gives up
//   registers (setmaxnreg 24) and one of its threads issues every TMA
//   load.  Warpgroups 1 and 2 are consumers of 64 query rows each
//   (setmaxnreg 240): S (64 x 128 keys) and O (64 x d) live in f32
//   registers.  The two consumers are independent, so one's softmax
//   overlaps the other's products on the tensor cores.
// - TMA brings the Q tile once and K and V tiles of 128 keys through a
//   2-stage ring in shared memory, with a full and an empty mbarrier per
//   stage (Q 32 KB + 2 x (K + V) 128 KB at d = 128: one CTA per SM).
//   Tiles are stored with the 128-byte swizzle that wgmma reads without
//   bank conflicts; a d = 128 row (256 B) is two boxes of 64 columns.
//   The tensor maps are 3-D, (G or Gkv, T, d), so a ragged last tile is
//   zero-filled at its head's edge, never read from the next head.
// - S = Q K^T: wgmma m64n128k16 from shared memory, both operands
//   K-major (K as stored, keys x d, needs no transpose), d / 16 steps.
// - The online softmax runs on the accumulator fragment in registers,
//   in log2 units (exp2f of scale log2(e) s - m): row max and sum by quad
//   shuffles; key tiles wholly below the diagonal skip the mask.
// - O += P V: p is converted to bf16 pairs in registers and fed directly
//   as wgmma's A operand (the f32 accumulator layout is the A-fragment
//   layout); V comes from shared memory as an MN-major B operand (the
//   transpose bit), 8 steps of 16 keys.
// - Each row depends only on its own head's data and the fixed tiles, so
//   G heads are bitwise equal to two calls of G/2.
//
// The tensor maps are encoded per call on the host with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// (no -lcuda), and passed as __grid_constant__ kernel parameters.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBM = 128;       // query rows per CTA (two consumers of 64)
constexpr int kBN = 128;       // keys per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kSpan = 64;      // bf16 columns per 128-byte swizzle span
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the reference's masked score -1e30, in log2 units
constexpr float kMaskedL2 = -1e30f * kLog2e;

// Byte offsets in dynamic shared memory (from a 1024-byte aligned base,
// the swizzle atom) for head dim D.
template <int D>
struct Sm90Smem {
  static constexpr int kSpans = D / kSpan;              // boxes per row
  static constexpr int kQSpan = kBM * kRowBytes;        // one Q box
  static constexpr int kKVSpan = kBN * kRowBytes;       // one K or V box
  static constexpr int kKVTile = kSpans * kKVSpan;
  static constexpr int kQ = 0;
  static constexpr int kK = kSpans * kQSpan;            // + stage * kKVTile
  static constexpr int kV = kK + kStages * kKVTile;     // + stage * kKVTile
  static constexpr int kBar = kV + kStages * kKVTile;   // 8-byte mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
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

// One TMA box of a 3-D tensor map into shared memory; completion counts
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), bf16, both from shared memory
// through descriptors, K-major (no transpose); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 pairs in registers, the
// accumulator's own layout) B (16 x 128) from shared memory, MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 pairs in registers, the
// accumulator's own layout) B (16 x 64) from shared memory, MN-major
// (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, desc_v);
  } else {
    wgmma_rs_n64(o, a, desc_v);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int Tq, int Tk,
                      int n_q_heads, int n_kv_heads, int causal,
                      float scale_log2, int bq, int bk) {
  using S = Sm90Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + S::kBar;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage

  const int g = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int q_last = min(q0 + kBM, Tq) - 1;
  // the CTA walks the key tiles its rows need, ascending
  const int n_tiles =
      (key_stop(q0, q_last, Tq, Tk, causal, bq, bk) + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int group = n_q_heads / n_kv_heads;
      const int gkv = (g / n_q_heads) * n_kv_heads + (g % n_q_heads) / group;
      mbar_expect_tx(bar_q, S::kSpans * S::kQSpan);
      for (int b = 0; b < S::kSpans; ++b) {
        tma_load(base + S::kQ + b * S::kQSpan, &tm_q, bar_q, b * kSpan, q0, g);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(bar_empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * S::kKVTile);
        for (int b = 0; b < S::kSpans; ++b) {
          tma_load(base + S::kK + s * S::kKVTile + b * S::kKVSpan, &tm_k,
                   bar_full + 8 * s, b * kSpan, kt * kBN, gkv);
          tma_load(base + S::kV + s * S::kKVTile + b * S::kKVSpan, &tm_v,
                   bar_full + 8 * s, b * kSpan, kt * kBN, gkv);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int quad = lane % 4;
    // this thread's two rows: r and r + 8 of the accumulator fragment
    const int row0 = q0 + cw * 64 + (tid / 32) * 16 + lane / 4;
    const int row1 = row0 + 8;
    const int q_offset = Tk - Tq;
    const int lim0 = key_limit(row0, Tq, Tk, causal, bq, bk);
    const int lim1 = key_limit(row1, Tq, Tk, causal, bq, bk);
    const int qpos0 = row0 + q_offset, qpos1 = row1 + q_offset;
    // this warpgroup's rows: the tiles it needs, and the leading tiles
    // that every one of its rows sees whole (no mask)
    const int wg_first = q0 + cw * 64;
    const int wg_last = min(wg_first + 63, Tq - 1);
    const int wg_tiles =
        wg_first > wg_last
            ? 0
            : (key_stop(wg_first, wg_last, Tq, Tk, causal, bq, bk) + kBN -
               1) / kBN;
    const int seen = causal ? max(0, min(key_limit(wg_first, Tq, Tk, causal,
                                                   bq, bk),
                                         wg_first + q_offset + 1))
                            : Tk;
    const int full_tiles = seen / kBN;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kMaskedL2, m1 = kMaskedL2, l0 = 0.f, l1 = 0.f;
    const uint32_t q_base = base + S::kQ + cw * 64 * kRowBytes;
    mbar_wait(bar_q, 0);

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(bar_full + 8 * s, (kt / kStages) & 1);
      if (kt < wg_tiles) {
        // S = Q K^T over d / 16 steps of 16 columns
        const uint32_t k_base = base + S::kK + s * S::kKVTile;
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns within a span
          const uint64_t da = sw128_desc(
              q_base + (kk / 4) * S::kQSpan + off, 16, 1024);
          const uint64_t db = sw128_desc(
              k_base + (kk / 4) * S::kKVSpan + off, 16, 1024);
          wgmma_ss_n128(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // online softmax on the fragment: sc[4j + c] is (row0, key
        // 8j + 2 quad + c), sc[4j + 2 + c] is (row1, the same key)
        const int k0 = kt * kBN;
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x0 = sc[4 * j + c] * scale_log2;
            float x1 = sc[4 * j + 2 + c] * scale_log2;
            if (kt >= full_tiles) {
              const int key = k0 + 8 * j + 2 * quad + c;
              x0 = key >= lim0 ? -CUDART_INF_F
                   : (causal && key > qpos0) ? kMaskedL2 : x0;
              x1 = key >= lim1 ? -CUDART_INF_F
                   : (causal && key > qpos1) ? kMaskedL2 : x1;
            }
            sc[4 * j + c] = x0;
            sc[4 * j + 2 + c] = x1;
            mx0 = fmaxf(mx0, x0);
            mx1 = fmaxf(mx1, x1);
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
        const float corr0 = exp2f(m0 - n0), corr1 = exp2f(m1 - n1);
        m0 = n0;
        m1 = n1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sc[4 * j + c] = exp2f(sc[4 * j + c] - n0);
            sc[4 * j + 2 + c] = exp2f(sc[4 * j + 2 + c] - n1);
            sum0 += sc[4 * j + c];
            sum1 += sc[4 * j + 2 + c];
          }
        }
        // l per thread over its own keys; the quad's partial sums are
        // added once, at the end (every lane of a quad has the same m)
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= corr0;
          acc[4 * j + 1] *= corr0;
          acc[4 * j + 2] *= corr1;
          acc[4 * j + 3] *= corr1;
        }

        // O += P V over 8 steps of 16 keys; P's A fragment for keys
        // 16 kk .. 16 kk + 15 is S's n8 blocks 2 kk and 2 kk + 1
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        const uint32_t v_base = base + S::kV + s * S::kKVTile;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          // MN-major: 8-key groups 1024 B apart (SBO), 64-column spans
          // kKVSpan apart (LBO)
          wgmma_pv<D>(acc, pa[kk],
                      sw128_desc(v_base + kk * 16 * kRowBytes, S::kKVSpan,
                                 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den0 = l0 == 0.f ? 1.f : l0;
    const float den1 = l1 == 0.f ? 1.f : l1;
    if (lse != nullptr && quad == 0) {
      // m is in log2 units: lse = m ln 2 + log(l), natural
      float* lse_g = lse + static_cast<int64_t>(g) * Tq;
      if (row0 < Tq) lse_g[row0] = m0 * kLn2 + logf(den0);
      if (row1 < Tq) lse_g[row1] = m1 * kLn2 + logf(den1);
    }
    __nv_bfloat16* out = o + static_cast<int64_t>(g) * Tq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (row0 < Tq) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<int64_t>(row0) * D + col) =
            __floats2bfloat162_rn(acc[4 * j] / den0, acc[4 * j + 1] / den0);
      }
      if (row1 < Tq) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<int64_t>(row1) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / den1,
                                  acc[4 * j + 3] / den1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 3-D map over a (heads, T, d) bf16 tensor: boxes of `rows` rows by 64
// columns of one head, 128-byte swizzled; reads past T are zero.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int heads, int T,
                     int d, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(T) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSpan),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o,
                        float* lse, int G, int Gkv, int Tq, int Tk,
                        int n_q_heads, int n_kv_heads, int causal,
                        float scale, int bq, int bk, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, G, Tq, D, kBM);
  if (err == cudaSuccess) err = make_map(&tm_k, k, Gkv, Tk, D, kBN);
  if (err == cudaSuccess) err = make_map(&tm_v, v, Gkv, Tk, D, kBN);
  if (err != cudaSuccess) return err;
  const int smem = Sm90Smem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(G, (Tq + kBM - 1) / kBM);
  flash_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, Tq, Tk,
      n_q_heads, n_kv_heads, causal, scale * kLog2e, bq, bk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// bf16 q (G, Tq, d), k/v (G / Hq * Hkv, Tk, d), o like q; d in {64, 128};
// lse null or (G, Tq) float32; bq, bk the reference's effective blocks.
// Returns a cudaError_t.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o,
                                          float* lse, int G,
                                          int Tq, int Tk, int d,
                                          int n_q_heads, int n_kv_heads,
                                          int causal, float scale, int bq,
                                          int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q_heads <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      G % n_q_heads != 0 || bq <= 0 || bk <= 0 || Tq <= 0 || Tk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Gkv = G / n_q_heads * n_kv_heads;
  if (d == 128) {
    return repro::launch_sm90<128>(q, k, v, o, lse, G, Gkv, Tq, Tk,
                                   n_q_heads, n_kv_heads, causal, scale, bq,
                                   bk, s);
  }
  if (d == 64) {
    return repro::launch_sm90<64>(q, k, v, o, lse, G, Gkv, Tq, Tk,
                                  n_q_heads, n_kv_heads, causal, scale, bq,
                                  bk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
