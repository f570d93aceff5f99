// Flash attention with GQA and causal masking for Hopper (sm_90a): the
// CUDA-core route, for float32 storage and for bfloat16 at head dims 16
// and 32 (bfloat16 at d = 64 and 128 takes flash_attention_sm90.cu).
//
// Replaces: src/repro/kernels/attention/attention.py,
//   flash_attention_pallas (body _kernel) -- the TPU kernel whose grid
//   (G, Tq/bq, Tk/bk) carries a running max m, denominator l and f32
//   accumulator in VMEM scratch across the sequential key axis.
//
// Computes, per query head g and row t (head-folded q (G, Tq, d), k/v
// (Gkv, Tk, d), KV head (g / Hq) Hkv + (g % Hq) / (Hq / Hkv)):
//   o[t] = sum_j softmax_j(scale q[t].k[j]) v[j]
// with the reference's constants.  Queries align to the end of the keys
// (q_offset = Tk - Tq) and l == 0 is replaced by 1.  The reference
// visits key blocks by the caller's bq x bk blocks and skips a key block
// wholly above its query block's last row; its result is a function of
// (row, bq, bk) alone, which this kernel reproduces without taking those
// blocks as tiles: row t's query block ends at
//   q_end = (t / bq + 1) bq - 1 + q_offset,
// its key limit is K_lim = 0 if q_end < 0, else min(Tk, (q_end / bk + 1) bk),
// keys at or past K_lim score -inf and causally masked keys below it
// -1e30.  So a row masked everywhere (causal, Tq > Tk) takes p = exp(0) = 1
// on every key below K_lim -- the mean of those V rows, as in the
// reference -- and 0 when K_lim = 0, never NaN.
// Arithmetic is f32 on f32 or bf16 storage; only the output is rounded to
// the storage type (the Pallas kernel keeps p in f32 for the PV product).
// Given a non-null `lse` (G, Tq) float32, it also writes each row's
// m + log(l) (natural log, l == 0 replaced by 1) for the backward
// (flash_attention_bwd.cu); the output is the same either way.
//
// Bound on an H100 SXM: operations.  At B = 4, Hq = 16, Hkv = 8,
// T = 4096, d = 128, causal, f32, the call reads q, k, v and writes o
// once (403 MB, 0.12 ms at 3.35 TB/s) but does 4 G T^2 d / 2 = 275 GFLOP
// (4.1 ms at the 67 TFLOP/s f32 CUDA-core peak this kernel runs on).
//
// Design: one CTA of 256 threads per (query head, tile of 64 query rows);
// the grid's y axis walks the query tiles last to first, so the longest
// causal rows start first.  The Q tile is staged once in shared memory;
// the CTA walks the key tiles (64 keys) its rows need (key_stop in
// common.cuh) in ascending order, staging K and V in shared memory as f32.
// Thread (ty, tx) of a 16 x 16 layout owns query rows 4 ty .. 4 ty + 3:
// it forms their scores against keys tx + 16 j (j < 4) as ascending-d
// fmaf chains, reduces each row's max and sum over the 16 lanes of its
// half-warp with shuffles, keeps the row's m and l in registers, writes P
// over the K tile, and accumulates P V into d/16 output columns per row.
// All of it is CUDA-core FMA, which keeps p in f32.  Each row's result
// depends only on its own head's data and the fixed tiles, never on G or
// on how heads are split across calls.  Shared memory is
// 4 (64 d + max(64 (d + 4), 64 x 68) + 64 d) bytes (97 KB at d = 128, two
// CTAs per SM); cudaFuncAttributeMaxDynamicSharedMemorySize is set per
// launch.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kTileQ = 64;   // query rows per CTA
constexpr int kTileK = 64;   // keys per shared-memory tile
constexpr int kThreads = 256;
constexpr int kPS = kTileK + 4;  // P row stride: conflict-free stores
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage `rows` (<= 64) rows of a row-major (., D) tile into shared memory
// at row stride `ld` floats; rows past `rows` are zero.  Coalesced: one
// 4-value chunk per thread, neighbouring threads on neighbouring chunks.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int rows) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kTileQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = load4(src + static_cast<int64_t>(r) * D + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

template <int D>
struct Smem {
  static constexpr int kQS = D;      // Q rows: read as broadcasts
  static constexpr int kKS = D + 4;  // K rows tx + 16 j hit distinct banks
  static constexpr int kVS = D;
  static constexpr int kQ = kTileQ * kQS;
  static constexpr int kKP =
      kTileK * kKS > kTileQ * kPS ? kTileK * kKS : kTileQ * kPS;
  static constexpr int kV = kTileK * kVS;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int Tq, int Tk,
                           int n_q_heads, int n_kv_heads, int causal,
                           float scale, int bq, int bk) {
  using S = Smem<D>;
  constexpr int kVec = D / 16 < 4 ? D / 16 : 4;  // output columns per load
  constexpr int kGroups = D / (16 * kVec);
  constexpr int kCols = kVec * kGroups;           // = D / 16 per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + S::kQ;
  float* ps = ks;  // P overwrites the K tile once the scores are formed
  float* vs = ks + S::kKP;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int g = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;
  const int q_rows = min(kTileQ, Tq - q0);
  const int group = n_q_heads / n_kv_heads;
  const int gkv = (g / n_q_heads) * n_kv_heads + (g % n_q_heads) / group;
  const int q_offset = Tk - Tq;
  const T* kg = k + static_cast<int64_t>(gkv) * Tk * D;
  const T* vg = v + static_cast<int64_t>(gkv) * Tk * D;

  // the CTA walks the key tiles its rows need, ascending
  const int n_tiles =
      (key_stop(q0, q0 + q_rows - 1, Tq, Tk, causal, bq, bk) + kTileK - 1) /
      kTileK;
  stage_tile<D>(qs, S::kQS, q + (static_cast<int64_t>(g) * Tq + q0) * D,
                q_rows);

  float m[4], l[4], acc[4][kCols];
  int k_lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    k_lim[i] = key_limit(q0 + 4 * ty + i, Tq, Tk, causal, bq, bk);
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTileK;
    const int k_rows = min(kTileK, Tk - k0);
    __syncthreads();  // the last tile's P and V reads are done
    stage_tile<D>(ks, S::kKS, kg + static_cast<int64_t>(k0) * D, k_rows);
    stage_tile<D>(vs, S::kVS, vg + static_cast<int64_t>(k0) * D, k_rows);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j, ascending d
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * S::kQS + c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S::kKS + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every thread has read K before P overwrites it

    // online softmax: each row lives on the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + q_offset;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (key >= k_lim[i]) {
          x = -CUDART_INF_F;  // not visited by the reference: no weight
        } else if (causal && qpos < key) {
          x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      }
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V over this tile's keys, ascending
#pragma unroll 2
    for (int c = 0; c < kTileK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p4[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kPS + c);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * S::kVS + tx * kVec;
        float vv[kCols];
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          const float* src = vrow + gi * 16 * kVec;
          if constexpr (kVec == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[4 * gi] = x.x;
            vv[4 * gi + 1] = x.y;
            vv[4 * gi + 2] = x.z;
            vv[4 * gi + 3] = x.w;
          } else if constexpr (kVec == 2) {
            const float2 x = *reinterpret_cast<const float2*>(src);
            vv[2 * gi] = x.x;
            vv[2 * gi + 1] = x.y;
          } else {
            vv[gi] = src[0];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? p4[i].x
                        : cc == 1 ? p4[i].y
                        : cc == 2 ? p4[i].z
                                  : p4[i].w;
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= q_rows) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    if (lse != nullptr && tx == 0) {
      lse[static_cast<int64_t>(g) * Tq + q0 + r] = m[i] + logf(den);
    }
    T* orow = o + (static_cast<int64_t>(g) * Tq + q0 + r) * D + tx * kVec;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        orow[gi * 16 * kVec + e] = from_float<T>(acc[i][gi * kVec + e] / den);
      }
  }
}

template <int D, typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* o, float* lse, int G, int Tq, int Tk,
                         int n_q_heads, int n_kv_heads, int causal,
                         float scale, int bq, int bk, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(G, (Tq + kTileQ - 1) / kTileQ);
  flash_attention_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tq, Tk,
      n_q_heads, n_kv_heads, causal, scale, bq, bk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int d, const void* q, const void* k,
                           const void* v, void* o, float* lse, int G,
                           int Tq, int Tk, int n_q_heads, int n_kv_heads,
                           int causal, float scale, int bq, int bk,
                           cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_flash<16, T>(q, k, v, o, lse, G, Tq, Tk, n_q_heads,
                                 n_kv_heads, causal, scale, bq, bk, stream);
    case 32:
      return launch_flash<32, T>(q, k, v, o, lse, G, Tq, Tk, n_q_heads,
                                 n_kv_heads, causal, scale, bq, bk, stream);
    case 64:
      return launch_flash<64, T>(q, k, v, o, lse, G, Tq, Tk, n_q_heads,
                                 n_kv_heads, causal, scale, bq, bk, stream);
    case 128:
      return launch_flash<128, T>(q, k, v, o, lse, G, Tq, Tk, n_q_heads,
                                  n_kv_heads, causal, scale, bq, bk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int G, int Tq, int Tk, int d,
                                     int n_q_heads, int n_kv_heads,
                                     int causal, float scale, int bq, int bk,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q_heads <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      bq <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == repro::kFloat32) {
    return repro::dispatch_flash<float>(d, q, k, v, o, lse, G, Tq, Tk,
                                        n_q_heads, n_kv_heads, causal, scale,
                                        bq, bk, s);
  }
  if (dtype == repro::kBFloat16) {
    return repro::dispatch_flash<__nv_bfloat16>(
        d, q, k, v, o, lse, G, Tq, Tk, n_q_heads, n_kv_heads, causal, scale,
        bq, bk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
