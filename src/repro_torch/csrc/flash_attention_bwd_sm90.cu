// The backward of flash attention with GQA and causal masking on Hopper's
// tensor cores (sm_90a: wgmma, TMA, mbarriers, warp specialisation): the
// "wgmma" route, bfloat16 storage at head dims 64 and 128, as the
// forward's route() splits them.  float32 storage, and bfloat16 at head
// dims 16 and 32, take flash_attention_bwd.cu (CUDA cores).
//
// Replaces: src/repro/kernels/attention/xla_flash.py:96, _flash_bwd -- the
//   reference's only flash-attention backward (a custom VJP that recomputes
//   each key chunk from the saved (q, k, v, o, lse)); its Pallas kernel
//   (attention.py:88) has no derivative.
//
// Computes the function of flash_attention_bwd.cu, per query head g
// (head-folded q, o, do (G, Tq, d); k, v (Gkv, Tk, d); KV head (g / Hq) Hkv
// + (g % Hq) / (Hq / Hkv)), from the forward's natural-log lse:
//   p[t, j]  = exp(scale q[t].k[j] - lse[t])     (0 where causally masked)
//   D[t]     = sum_c do[t, c] o[t, c]
//   dp[t, j] = do[t].v[j]
//   ds[t, j] = p[t, j] (dp[t, j] - D[t]) scale   (from the f32 p)
//   dv[j]    = sum_t bf16(p[t, j]) do[t]
//   dk[j]    = sum_t bf16(ds[t, j]) q[t]
//   dq[t]    = sum_j bf16(ds[t, j]) k[j]
// dk and dv sum over the group's query heads.  Scores and dp are exact
// bf16 products summed in f32; p and ds are rounded to bf16 only as the A
// operands of the products that follow (as the forward rounds p for PV),
// every sum is f32, and each output is rounded to bf16 once.  Causal is
// end-aligned (q_offset = Tk - Tq) with Tq <= Tk, so every row sees a key.
//
// Bound on an H100 SXM: operations.  At B = 4, Hq = 16, Hkv = 8, T = 4096,
// d = 128, causal, the function needs 5 products of 2 d flops a visible
// (row, key) pair, 687 GFLOP: 0.695 ms at the 989 TFLOP/s bf16 tensor-core
// peak, while it moves 0.4 GB (0.12 ms at 3.35 TB/s).  This design runs
// 7 products a pair (s and dp are formed in both kernels below, 962
// GFLOP) because it writes every output once, with no atomics: each
// output element is one fixed chain of f32 sums, so results are bitwise
// repeatable, a batch split across calls gives the same bits and a
// resumed training run stays bitwise.  Three kernels, in order on the
// caller's stream:
//
//   1. prep: one warp a row, D = rowsum(do o) (the fma route's arithmetic,
//      common.cuh row_dot) into a float32 workspace (2, G, Tpad) with Tq
//      padded to 64 rows a head: [0] D, [1] a copy of lse, zero past Tq,
//      so that a ring tile's 64 values of each are one aligned bulk copy.
//   2. dk, dv: one CTA of 384 threads per (KV head, tile of 128 keys).
//      Warpgroup 0 is the producer (setmaxnreg 24; one thread issues every
//      TMA load): K and V once, then Q, dO (64 rows), lse and D (64
//      values) through a 2-stage ring with full and empty mbarriers.
//      Warpgroups 1 and 2 are consumers of 64 keys each (setmaxnreg 240),
//      accumulating dk and dv (64 x d each) in f32 registers.  The CTA
//      walks the group's query heads in order and, for each, the query
//      tiles that see its keys, ascending.  Per tile and consumer:
//        S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands
//        K-major from shared memory, as the forward's S), committed as
//        two groups so that P^T = exp2(scale log2e S^T - log2e lse) is
//        formed while dP^T is still on the tensor cores; the causal mask
//        only on tiles that cross the diagonal (or the ragged last rows);
//        dV += bf16(P^T) dO is issued (A from registers: the f32
//        accumulator fragment is the A-operand layout, as the forward's
//        PV; dO an MN-major B operand at N = d) before dS^T = P^T (dP^T -
//        D) scale is formed from the unrounded P^T, then dK += bf16(dS^T)
//        Q.  A consumer skips (but releases) a tile that lies wholly
//        above its keys.
//   3. dq: one CTA of 384 threads per (query head, tile of 128 rows),
//      walked last to first (the longest causal rows start first), the
//      same warp roles: Q and dO once, K and V tiles of 64 keys through
//      the ring, ascending.  Per tile and consumer (64 rows): S = Q K^T
//      and dP = dO V^T (ss), P and dS as in 2, dQ += bf16(dS) K (rs, K
//      MN-major).
//
// Shared memory at d = 128: 2: K, V 64 KB + 2 stages x (Q, dO 32 KB + 512
// B) = 129 KB; 3: Q, dO 64 KB + 2 x (K, V 32 KB) = 128 KB; one CTA per SM.
// The tensor maps are 3-D (heads, T, d), so a ragged last tile is zero
// past its head's edge, never another head's rows.
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace repro {
namespace {

constexpr int kKeys = 128;     // dk/dv: keys per CTA (two consumers of 64)
constexpr int kRows = 64;      // dk/dv: query rows per ring tile
constexpr int kQRows = 128;    // dq: query rows per CTA (two consumers of 64)
constexpr int kKTile = 64;     // dq: keys per ring tile
constexpr int kStages = 2;     // ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kPad = 64;       // workspace rows a head round up to this
constexpr int kPrepThreads = 256;

// dk/dv kernel: byte offsets from a 1024-byte aligned base (the swizzle
// atom) for head dim D.
template <int D>
struct DkdvSmem {
  static constexpr int kSpans = D / kSpan;
  static constexpr int kKVSpan = kKeys * kRowBytes;    // one K or V box
  static constexpr int kQSpan = kRows * kRowBytes;     // one Q or dO box
  static constexpr int kKV = kSpans * kKVSpan;
  static constexpr int kQTile = kSpans * kQSpan;
  static constexpr int kVec = kRows * 4;               // 64 floats
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;                  // + stage * kQTile
  static constexpr int kDO = kQ + kStages * kQTile;    // + stage * kQTile
  static constexpr int kLse = kDO + kStages * kQTile;  // + stage * 2 kVec
  static constexpr int kBar = kLse + kStages * 2 * kVec;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// dq kernel: the same for its tiles.
template <int D>
struct DqSmem {
  static constexpr int kSpans = D / kSpan;
  static constexpr int kQSpan = kQRows * kRowBytes;    // one Q or dO box
  static constexpr int kKSpan = kKTile * kRowBytes;    // one K or V box
  static constexpr int kQTile = kSpans * kQSpan;
  static constexpr int kKVTile = kSpans * kKSpan;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQTile;
  static constexpr int kK = 2 * kQTile;                // + stage * kKVTile
  static constexpr int kV = kK + kStages * kKVTile;    // + stage * kKVTile
  static constexpr int kBar = kV + kStages * kKVTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// 1. D and the padded lse copy, one warp a padded row.
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_sm90_prep_kernel(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ ws, int G, int Tq,
                               int t_pad, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kPrepThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t rows = static_cast<int64_t>(G) * t_pad;
  if (row >= rows) return;
  const int64_t g = row / t_pad;
  const int t = static_cast<int>(row - g * t_pad);
  float delta = 0.f, l = 0.f;
  if (t < Tq) {
    const int64_t r = g * Tq + t;
    delta = row_dot(o + r * d, dout + r * d, d, lane);
    l = lse[r];
  }
  if (lane == 0) {
    ws[row] = delta;
    ws[rows + row] = l;
  }
}

// 2. dk and dv of one (KV head, tile of 128 keys).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ ws,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int G, int Tq,
                               int Tk, int t_pad, int n_q_heads,
                               int n_kv_heads, int causal, float scale,
                               float scale_log2) {
  using S = DkdvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + S::kBar;
  const uint32_t bar_full = bar_kv + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage

  const int gkv = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;
  const int group = n_q_heads / n_kv_heads;
  const int q_offset = Tk - Tq;
  // query head of group member h: (gkv / Hkv) Hq + (gkv % Hkv) group + h
  const int g0 = (gkv / n_kv_heads) * n_q_heads + (gkv % n_kv_heads) * group;
  const int n_qt = (Tq + kRows - 1) / kRows;
  // causal: the first row that sees key k0 is k0 - q_offset (< Tq)
  const int qt0 = causal ? max(0, k0 - q_offset) / kRows : 0;
  const int per_head = n_qt - qt0;
  const int n_tiles = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
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
      mbar_expect_tx(bar_kv, 2 * S::kKV);
      for (int b = 0; b < S::kSpans; ++b) {
        tma_load(base + S::kK + b * S::kKVSpan, &tm_k, bar_kv, b * kSpan, k0,
                 gkv);
        tma_load(base + S::kV + b * S::kKVSpan, &tm_v, bar_kv, b * kSpan, k0,
                 gkv);
      }
      const int64_t rows = static_cast<int64_t>(G) * t_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int g = g0 + it / per_head;
        const int q0 = (qt0 + it % per_head) * kRows;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * S::kQTile + 2 * S::kVec);
        for (int b = 0; b < S::kSpans; ++b) {
          tma_load(base + S::kQ + s * S::kQTile + b * S::kQSpan, &tm_q, full,
                   b * kSpan, q0, g);
          tma_load(base + S::kDO + s * S::kQTile + b * S::kQSpan, &tm_do,
                   full, b * kSpan, q0, g);
        }
        const int64_t w0 = static_cast<int64_t>(g) * t_pad + q0;
        const uint32_t vec = base + S::kLse + s * 2 * S::kVec;
        bulk_load(vec, ws + rows + w0, S::kVec, full);     // lse
        bulk_load(vec + S::kVec, ws + w0, S::kVec, full);  // D
      }
    }
  } else {
    // ---- consumers: 64 keys each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int quad = lane % 4;
    // this thread's two keys: fragment rows r and r + 8
    const int key0 = k0 + cw * 64 + (tid / 32) * 16 + lane / 4;
    const int key1 = key0 + 8;
    const int wg_key = k0 + cw * 64;  // this warpgroup's first key
    const uint32_t k_wg = base + S::kK + cw * 64 * kRowBytes;
    const uint32_t v_wg = base + S::kV + cw * 64 * kRowBytes;

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(bar_kv, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int q0 = (qt0 + it % per_head) * kRows;
      const int q_last = min(q0 + kRows, Tq) - 1;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      // skip a tile whose every row lies above this warpgroup's keys
      if (!causal || q_last + q_offset >= wg_key) {
        const uint32_t q_s = base + S::kQ + s * S::kQTile;
        const uint32_t do_s = base + S::kDO + s * S::kQTile;
        const float* lse_s =
            reinterpret_cast<const float*>(sbase + S::kLse + s * 2 * S::kVec);
        const float* del_s = lse_s + kRows;
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(st, sw128_desc(k_wg + (kk / 4) * S::kKVSpan + off, 16,
                                      1024),
                       sw128_desc(q_s + (kk / 4) * S::kQSpan + off, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(dpt, sw128_desc(v_wg + (kk / 4) * S::kKVSpan + off,
                                       16, 1024),
                       sw128_desc(do_s + (kk / 4) * S::kQSpan + off, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S^T is in; dP^T may still run
        fence_regs(st);

        // P^T on the fragment: st[4j + c] is (key0, row q0 + 8j + 2 quad +
        // c), st[4j + 2 + c] is (key1, the same row)
        const bool edge =
            q0 + kRows > Tq || (causal && q0 + q_offset < wg_key + 63);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * j + 2 * quad + c;
            const float l2 = lse_s[col] * kLog2e;
            float p0 = exp2f(st[4 * j + c] * scale_log2 - l2);
            float p1 = exp2f(st[4 * j + 2 + c] * scale_log2 - l2);
            if (edge) {
              const int row = q0 + col;
              // the last key the row sees (-1: a padding row sees none)
              const int seen =
                  row >= Tq ? -1 : causal ? row + q_offset : INT_MAX;
              if (key0 > seen) p0 = 0.f;
              if (key1 > seen) p1 = 0.f;
            }
            st[4 * j + c] = p0;
            st[4 * j + 2 + c] = p1;
          }
        }
        // dV += bf16(P^T) dO, dO MN-major: 16-row steps, 8-row groups
        // 1024 B apart, 64-column spans one box apart
        uint32_t pa[4][4];
        pack_a(st, pa);
        fence_regs(acc_v);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_pv<D>(acc_v, pa[kk],
                      sw128_desc(do_s + kk * 16 * kRowBytes, S::kQSpan, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is in; dV may still run
        fence_regs(dpt);

        // dS^T = P^T (dP^T - D) scale from the unrounded P^T
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float dl = del_s[8 * j + 2 * quad + c];
            dpt[4 * j + c] = st[4 * j + c] * (dpt[4 * j + c] - dl) * scale;
            dpt[4 * j + 2 + c] =
                st[4 * j + 2 + c] * (dpt[4 * j + 2 + c] - dl) * scale;
          }
        }
        uint32_t da[4][4];
        pack_a(dpt, da);
        fence_regs(acc_k);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_pv<D>(acc_k, da[kk],
                      sw128_desc(q_s + kk * 16 * kRowBytes, S::kQSpan, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    // write dk, dv once: fragment n8 block j holds columns 8j + 2 quad, +1
    const int64_t out0 = static_cast<int64_t>(gkv) * Tk;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (key0 < Tk) {
        const int64_t at = (out0 + key0) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(acc_k[4 * j], acc_k[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(acc_v[4 * j], acc_v[4 * j + 1]);
      }
      if (key1 < Tk) {
        const int64_t at = (out0 + key1) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(acc_k[4 * j + 2], acc_k[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(acc_v[4 * j + 2], acc_v[4 * j + 3]);
      }
    }
  }
}

// 3. dq of one (query head, tile of 128 rows).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ ws,
                             __nv_bfloat16* __restrict__ dq, int Tq, int Tk,
                             int t_pad, int n_q_heads, int n_kv_heads,
                             int causal, float scale, float scale_log2) {
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + S::kBar;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage

  const int g = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;
  const int q_last = min(q0 + kQRows, Tq) - 1;
  const int q_offset = Tk - Tq;
  // the CTA walks the key tiles its rows see, ascending
  const int stop = causal ? min(Tk, q_last + q_offset + 1) : Tk;
  const int n_tiles = (stop + kKTile - 1) / kKTile;

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
      mbar_expect_tx(bar_q, 2 * S::kQTile);
      for (int b = 0; b < S::kSpans; ++b) {
        tma_load(base + S::kQ + b * S::kQSpan, &tm_q, bar_q, b * kSpan, q0, g);
        tma_load(base + S::kDO + b * S::kQSpan, &tm_do, bar_q, b * kSpan, q0,
                 g);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * S::kKVTile);
        for (int b = 0; b < S::kSpans; ++b) {
          tma_load(base + S::kK + s * S::kKVTile + b * S::kKSpan, &tm_k, full,
                   b * kSpan, kt * kKTile, gkv);
          tma_load(base + S::kV + s * S::kKVTile + b * S::kKSpan, &tm_v, full,
                   b * kSpan, kt * kKTile, gkv);
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
    // this thread's two rows: fragment rows r and r + 8
    const int row0 = q0 + cw * 64 + (tid / 32) * 16 + lane / 4;
    const int row1 = row0 + 8;
    // the last key each row sees (-1: a padding row sees none)
    const int seen0 = row0 >= Tq ? -1 : causal ? row0 + q_offset : Tk - 1;
    const int seen1 = row1 >= Tq ? -1 : causal ? row1 + q_offset : Tk - 1;
    const int64_t r0 = static_cast<int64_t>(g) * Tq + row0;
    const float l0 = row0 < Tq ? lse[r0] * kLog2e : 0.f;
    const float l1 = row1 < Tq ? lse[r0 + 8] * kLog2e : 0.f;
    const int64_t w0 = static_cast<int64_t>(g) * t_pad + row0;
    const float del0 = row0 < Tq ? ws[w0] : 0.f;
    const float del1 = row1 < Tq ? ws[w0 + 8] : 0.f;
    // this warpgroup's rows: the key tiles they see, and the leading tiles
    // every one of them sees whole (no mask)
    const int wg_first = q0 + cw * 64;
    const int wg_last = min(wg_first + 63, Tq - 1);
    const int wg_tiles =
        wg_first > wg_last
            ? 0
            : ((causal ? min(Tk, wg_last + q_offset + 1) : Tk) + kKTile - 1) /
                  kKTile;
    const int full_tiles = (causal ? wg_first + q_offset + 1 : Tk) / kKTile;
    const uint32_t q_wg = base + S::kQ + cw * 64 * kRowBytes;
    const uint32_t do_wg = base + S::kDO + cw * 64 * kRowBytes;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(bar_q, 0);

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(bar_full + 8 * s, (kt / kStages) & 1);
      if (kt < wg_tiles) {
        const uint32_t k_s = base + S::kK + s * S::kKVTile;
        const uint32_t v_s = base + S::kV + s * S::kKVTile;
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(q_wg + (kk / 4) * S::kQSpan + off, 16,
                                      1024),
                       sw128_desc(k_s + (kk / 4) * S::kKSpan + off, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(dp, sw128_desc(do_wg + (kk / 4) * S::kQSpan + off, 16,
                                      1024),
                       sw128_desc(v_s + (kk / 4) * S::kKSpan + off, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S is in; dP may still run
        fence_regs(sc);

        // P on the fragment: sc[4j + c] is (row0, key kt 64 + 8j + 2 quad
        // + c), sc[4j + 2 + c] is (row1, the same key)
        const bool edge = kt >= full_tiles;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float p0 = exp2f(sc[4 * j + c] * scale_log2 - l0);
            float p1 = exp2f(sc[4 * j + 2 + c] * scale_log2 - l1);
            if (edge) {
              const int key = kt * kKTile + 8 * j + 2 * quad + c;
              if (key > seen0) p0 = 0.f;
              if (key > seen1) p1 = 0.f;
            }
            sc[4 * j + c] = p0;
            sc[4 * j + 2 + c] = p1;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = P (dP - D) scale from the unrounded P
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            dp[4 * j + c] = sc[4 * j + c] * (dp[4 * j + c] - del0) * scale;
            dp[4 * j + 2 + c] =
                sc[4 * j + 2 + c] * (dp[4 * j + 2 + c] - del1) * scale;
          }
        }
        // dQ += bf16(dS) K, K MN-major
        uint32_t da[4][4];
        pack_a(dp, da);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_pv<D>(acc, da[kk],
                      sw128_desc(k_s + kk * 16 * kRowBytes, S::kKSpan, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    __nv_bfloat16* out = dq + static_cast<int64_t>(g) * Tq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (row0 < Tq) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<int64_t>(row0) * D + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      }
      if (row1 < Tq) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<int64_t>(row1) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int D>
cudaError_t launch_bwd_sm90(const void* q, const void* k, const void* v,
                            const void* o, const float* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            float* ws, int G, int Gkv, int Tq, int Tk,
                            int n_q_heads, int n_kv_heads, int causal,
                            float scale, cudaStream_t stream) {
  const int t_pad = (Tq + kPad - 1) / kPad * kPad;
  const int64_t rows = static_cast<int64_t>(G) * t_pad;
  const int per_cta = kPrepThreads / 32;
  flash_bwd_sm90_prep_kernel<<<static_cast<unsigned>((rows + per_cta - 1) /
                                                     per_cta),
                               kPrepThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, ws, G, Tq, t_pad, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  err = make_map(&tm_q, q, G, Tq, D, kRows);
  if (err == cudaSuccess) err = make_map(&tm_do, dout, G, Tq, D, kRows);
  if (err == cudaSuccess) err = make_map(&tm_k, k, Gkv, Tk, D, kKeys);
  if (err == cudaSuccess) err = make_map(&tm_v, v, Gkv, Tk, D, kKeys);
  if (err != cudaSuccess) return err;
  const int smem_kv = DkdvSmem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_sm90_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  flash_bwd_sm90_dkdv_kernel<D>
      <<<dim3(Gkv, (Tk + kKeys - 1) / kKeys), kThreads, smem_kv, stream>>>(
          tm_q, tm_k, tm_v, tm_do, ws, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), G, Tq, Tk, t_pad, n_q_heads,
          n_kv_heads, causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = make_map(&tm_q, q, G, Tq, D, kQRows);
  if (err == cudaSuccess) err = make_map(&tm_do, dout, G, Tq, D, kQRows);
  if (err == cudaSuccess) err = make_map(&tm_k, k, Gkv, Tk, D, kKTile);
  if (err == cudaSuccess) err = make_map(&tm_v, v, Gkv, Tk, D, kKTile);
  if (err != cudaSuccess) return err;
  const int smem_q = DqSmem<D>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_sm90_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_dq_kernel<D>
      <<<dim3(G, (Tq + kQRows - 1) / kQRows), kThreads, smem_q, stream>>>(
          tm_q, tm_k, tm_v, tm_do, lse, ws, static_cast<__nv_bfloat16*>(dq),
          Tq, Tk, t_pad, n_q_heads, n_kv_heads, causal, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// bf16 q, o, do (G, Tq, d); k, v (G / Hq * Hkv, Tk, d); dq, dk, dv like q,
// k, v; lse (G, Tq) float32 from the forward; ws a float32 workspace of
// 2 G Tpad values, Tpad = Tq rounded up to 64; Tq <= Tk; d in {64, 128}.
// Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* ws, int G, int Tq, int Tk, int d, int n_q_heads, int n_kv_heads,
    int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q_heads <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      G % n_q_heads != 0 || Tq <= 0 || Tk < Tq) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Gkv = G / n_q_heads * n_kv_heads;
  if (d == 128) {
    return repro::launch_bwd_sm90<128>(q, k, v, o, lse, dout, dq, dk, dv, ws,
                                       G, Gkv, Tq, Tk, n_q_heads, n_kv_heads,
                                       causal, scale, s);
  }
  if (d == 64) {
    return repro::launch_bwd_sm90<64>(q, k, v, o, lse, dout, dq, dk, dv, ws,
                                      G, Gkv, Tq, Tk, n_q_heads, n_kv_heads,
                                      causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
