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
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace repro {
namespace {

constexpr int kBM = 128;       // query rows per CTA (two consumers of 64)
constexpr int kBN = 128;       // keys per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumers
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
        wgmma_wait<0>();
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
        pack_a(sc, pa);
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
        wgmma_wait<0>();
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
