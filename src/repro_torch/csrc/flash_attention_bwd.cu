// The backward of flash attention with GQA and causal masking, for Hopper
// (sm_90a), on CUDA cores -- the "fma" route: float32 storage at head dims
// 16, 32, 64 and 128 and bfloat16 at 16 and 32, float32 arithmetic
// throughout.  bfloat16 at head dims 64 and 128 takes
// flash_attention_bwd_sm90.cu (the "wgmma" route, tensor cores), as the
// forward's route() splits them.
//
// Replaces: src/repro/kernels/attention/xla_flash.py:96, _flash_bwd -- the
//   reference's only flash-attention backward (a custom VJP that recomputes
//   each key chunk from the saved (q, k, v, o, lse)); its Pallas kernel
//   (attention.py:88) has no derivative.
//
// Computes, per query head g (head-folded q, o, do (G, Tq, d); k, v
// (Gkv, Tk, d); KV head (g / Hq) Hkv + (g % Hq) / (Hq / Hkv)), with the
// forward's per-row lse = m + log(l) (natural log, float32):
//   p[t, j]  = exp(scale q[t].k[j] - lse[t])     (0 where causally masked)
//   D[t]     = sum_c do[t, c] o[t, c]
//   dv[j]   += sum_t p[t, j] do[t]
//   dp[t, j] = do[t].v[j]
//   ds[t, j] = p[t, j] (dp[t, j] - D[t]) scale
//   dq[t]    = sum_j ds[t, j] k[j]
//   dk[j]   += sum_t ds[t, j] q[t]
// dk and dv sum over every query head of the KV head's group.  Queries
// align to the end of the keys (q_offset = Tk - Tq) and Tq <= Tk, so
// every row sees at least one key and the forward's per-row key limit
// (common.cuh) masks no key a row's causal mask keeps: p is the plain
// causal softmax.  Outputs are rounded once to the storage type.
//
// Deterministic, with no atomics: every output element is one fixed
// chain of float32 fmas.  Three kernels, in order on the caller's stream:
//   1. D: one warp a row, rowsum(do o) into a float32 workspace;
//   2. dk, dv: one CTA of 256 threads per (KV head, tile of 64 keys),
//      keys walked first to last (the first tiles, which every causal
//      row sees, take longest).  K and V are staged once in shared
//      memory; the CTA walks the group's query heads in order and, for
//      each, the query tiles of 64 rows that see its keys, ascending.
//      Thread (ty, tx) of a 16 x 16 layout owns keys 4 ty .. 4 ty + 3:
//      it forms their scores and dp against rows tx + 16 j (j < 4) as
//      ascending-d fmaf chains, writes p and ds transposed into shared
//      memory, then accumulates d / 16 columns of dv (from p and do) and
//      dk (from ds and q) per key over the tile's rows, ascending;
//   3. dq: one CTA of 256 threads per (query head, tile of 64 rows),
//      walked last to first (the longest causal rows start first).  Q
//      and dO are staged once; the CTA walks the key tiles its rows see,
//      ascending, forms s and dp as in 2 with rows and keys swapped,
//      writes ds into shared memory and accumulates d / 16 columns of dq
//      per row over the tile's keys, ascending.
// Each head's results depend only on its own data and the fixed tiles,
// never on G or on how heads are split across calls.  Shared memory:
// 2: 4 (4 x 64 (d + 4) + 2 x 64 x 68 + 128) bytes (170.5 KB at d = 128);
// 3: 4 (4 x 64 (d + 4) + 64 x 68) bytes (152 KB); one CTA per SM.
//
// Bound on an H100 SXM: operations.  The backward does 5 products of
// 2 d flops per visible (row, key) pair -- 2.5 times the forward's 2 --
// all of them at the 67 TFLOP/s f32 CUDA-core peak this kernel runs on
// (and it recomputes s and dp in both 2 and 3: 7 products a pair, 14 d
// flops).
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kTile + 4;  // p / ds row stride: conflict-free stores

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
// at row stride `ld` floats; rows past `rows` are zero.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const T* __restrict__ src,
                                           int rows) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = load4(src + static_cast<int64_t>(r) * D + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

template <int D>
struct BwdSmem {
  static constexpr int kS = D + 4;  // rows tx + 16 j hit distinct banks
  static constexpr int kT = kTile * kS;
  static constexpr int kP = kTile * kPS;
  // dk/dv kernel: K, V, Q, dO, p^T, ds^T, lse, D
  static constexpr size_t kKVBytes =
      sizeof(float) * (4 * kT + 2 * kP + 2 * kTile);
  // dq kernel: Q, dO, K, V, ds
  static constexpr size_t kQBytes = sizeof(float) * (4 * kT + kP);
};

// sa[i][j] = sum_c a[ra + i][c] b[rb + 16 j][c] over two operand pairs at
// once: (x, y) and (u, w), each an ascending-c fmaf chain.  `a` rows are
// read as broadcasts (4 ty + i), `b` rows strided (tx + 16 j).
template <int D>
__device__ __forceinline__ void tile_dots(const float* x, const float* y,
                                          const float* u, const float* w,
                                          int ty, int tx, float (&s)[4][4],
                                          float (&t)[4][4]) {
  constexpr int kS = BwdSmem<D>::kS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 a[4], b[4], e[4], f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(x + (4 * ty + i) * kS + c);
      e[i] = *reinterpret_cast<const float4*>(u + (4 * ty + i) * kS + c);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(y + (tx + 16 * j) * kS + c);
      f[j] = *reinterpret_cast<const float4*>(w + (tx + 16 * j) * kS + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        t[i][j] = fmaf(e[i].x, f[j].x, t[i][j]);
        t[i][j] = fmaf(e[i].y, f[j].y, t[i][j]);
        t[i][j] = fmaf(e[i].z, f[j].z, t[i][j]);
        t[i][j] = fmaf(e[i].w, f[j].w, t[i][j]);
      }
  }
}

// acc[i][e] += sum_r w[4 ty + i][r] m[r][cols(e)] over the tile's 64 r,
// ascending, where thread tx owns columns tx kVec + 16 kVec gi + (0 ..
// kVec - 1): the forward's P V product.
template <int D>
__device__ __forceinline__ void tile_accumulate(const float* w,
                                                const float* m, int ty,
                                                int tx,
                                                float (&acc)[4][D / 16]) {
  constexpr int kS = BwdSmem<D>::kS;
  constexpr int kVec = D / 16 < 4 ? D / 16 : 4;
  constexpr int kGroups = D / (16 * kVec);
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 w4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w4[i] = *reinterpret_cast<const float4*>(w + (4 * ty + i) * kPS + c);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* mrow = m + (c + cc) * kS + tx * kVec;
      float mv[D / 16];
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const float* src = mrow + gi * 16 * kVec;
        if constexpr (kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          mv[4 * gi] = x.x;
          mv[4 * gi + 1] = x.y;
          mv[4 * gi + 2] = x.z;
          mv[4 * gi + 3] = x.w;
        } else if constexpr (kVec == 2) {
          const float2 x = *reinterpret_cast<const float2*>(src);
          mv[2 * gi] = x.x;
          mv[2 * gi + 1] = x.y;
        } else {
          mv[gi] = src[0];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = cc == 0 ? w4[i].x
                      : cc == 1 ? w4[i].y
                      : cc == 2 ? w4[i].z
                                : w4[i].w;
#pragma unroll
        for (int e = 0; e < D / 16; ++e) acc[i][e] = fmaf(a, mv[e], acc[i][e]);
      }
    }
  }
}

// Write a thread's 4 rows (4 ty + i, those below `rows`) of a (., D)
// float32 accumulator into `out` (row stride D) in the storage type.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, int ty, int tx, int rows,
                                           const float (&acc)[4][D / 16]) {
  constexpr int kVec = D / 16 < 4 ? D / 16 : 4;
  constexpr int kGroups = D / (16 * kVec);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    T* row = out + static_cast<int64_t>(r) * D + tx * kVec;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        row[gi * 16 * kVec + e] = from_float<T>(acc[i][gi * kVec + e]);
      }
  }
}

// 1. D[row] = sum_c do[row, c] o[row, c]: one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float acc = row_dot(o + row * d, dout + row * d, d, lane);
  if (lane == 0) delta[row] = acc;
}

// 2. dk and dv of one (KV head, tile of 64 keys).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int Tq, int Tk, int n_q_heads,
                          int n_kv_heads, int causal, float scale) {
  using S = BwdSmem<D>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + S::kT;
  float* qs = vs + S::kT;
  float* ds_in = qs + S::kT;  // dO
  float* pt = ds_in + S::kT;  // p^T (keys x rows)
  float* dst = pt + S::kP;    // ds^T
  float* lse_s = dst + S::kP;
  float* del_s = lse_s + kTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int gkv = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int k_rows = min(kTile, Tk - k0);
  const int group = n_q_heads / n_kv_heads;
  const int q_offset = Tk - Tq;
  // query head of group member h: (gkv / Hkv) Hq + (gkv % Hkv) group + h
  const int g0 = (gkv / n_kv_heads) * n_q_heads + (gkv % n_kv_heads) * group;
  const int n_qt = (Tq + kTile - 1) / kTile;
  // causal: the first row that sees key k0 is k0 - q_offset
  const int qt0 = causal ? max(0, k0 - q_offset) / kTile : 0;

  stage_tile<D>(ks, S::kS, k + (static_cast<int64_t>(gkv) * Tk + k0) * D,
                k_rows);
  stage_tile<D>(vs, S::kS, v + (static_cast<int64_t>(gkv) * Tk + k0) * D,
                k_rows);

  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int h = 0; h < group; ++h) {
    const int g = g0 + h;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      const int q_rows = min(kTile, Tq - q0);
      const int64_t row0 = static_cast<int64_t>(g) * Tq + q0;
      __syncthreads();  // the last tile's reads are done
      stage_tile<D>(qs, S::kS, q + row0 * D, q_rows);
      stage_tile<D>(ds_in, S::kS, dout + row0 * D, q_rows);
      if (threadIdx.x < kTile) {
        const bool in = threadIdx.x < q_rows;
        lse_s[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.f;
        del_s[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // keys 4 ty + i against rows tx + 16 j: s = k.q, dp = v.do
      float s[4][4], dp[4][4];
      tile_dots<D>(ks, qs, vs, ds_in, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool live = key < Tk && r < q_rows &&
                            (!causal || key <= q0 + r + q_offset);
          const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          pt[(4 * ty + i) * kPS + r] = p;
          dst[(4 * ty + i) * kPS + r] = p * (dp[i][j] - del_s[r]) * scale;
        }
      }
      __syncthreads();
      tile_accumulate<D>(pt, ds_in, ty, tx, acc_v);
      tile_accumulate<D>(dst, qs, ty, tx, acc_k);
    }
  }
  const int64_t out0 = (static_cast<int64_t>(gkv) * Tk + k0) * D;
  store_rows<D, T>(dk + out0, ty, tx, k_rows, acc_k);
  store_rows<D, T>(dv + out0, ty, tx, k_rows, acc_v);
}

// 3. dq of one (query head, tile of 64 rows).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int n_q_heads, int n_kv_heads,
                        int causal, float scale) {
  using S = BwdSmem<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + S::kT;
  float* ks = dos + S::kT;
  float* vs = ks + S::kT;
  float* dss = vs + S::kT;  // ds (rows x keys)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int g = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int q_rows = min(kTile, Tq - q0);
  const int group = n_q_heads / n_kv_heads;
  const int gkv = (g / n_q_heads) * n_kv_heads + (g % n_q_heads) / group;
  const int q_offset = Tk - Tq;
  const int64_t row0 = static_cast<int64_t>(g) * Tq + q0;
  const int k_stop = causal ? min(Tk, q0 + q_rows - 1 + q_offset + 1) : Tk;
  const int n_kt = (k_stop + kTile - 1) / kTile;

  stage_tile<D>(qs, S::kS, q + row0 * D, q_rows);
  stage_tile<D>(dos, S::kS, dout + row0 * D, q_rows);
  float row_lse[4], row_del[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    row_lse[i] = r < q_rows ? lse[row0 + r] : 0.f;
    row_del[i] = r < q_rows ? delta[row0 + r] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;

  const T* kg = k + static_cast<int64_t>(gkv) * Tk * D;
  const T* vg = v + static_cast<int64_t>(gkv) * Tk * D;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int k_rows = min(kTile, Tk - k0);
    __syncthreads();  // the last tile's reads are done
    stage_tile<D>(ks, S::kS, kg + static_cast<int64_t>(k0) * D, k_rows);
    stage_tile<D>(vs, S::kS, vg + static_cast<int64_t>(k0) * D, k_rows);
    __syncthreads();

    // rows 4 ty + i against keys tx + 16 j: s = q.k, dp = do.v
    float s[4][4], dp[4][4];
    tile_dots<D>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = key < Tk && r < q_rows &&
                          (!causal || key <= q0 + r + q_offset);
        const float p = live ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[r * kPS + tx + 16 * j] = p * (dp[i][j] - row_del[i]) * scale;
      }
    }
    __syncthreads();
    tile_accumulate<D>(dss, ks, ty, tx, acc);
  }
  store_rows<D, T>(dq + row0 * D, ty, tx, q_rows, acc);
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, int G,
                       int Gkv, int Tq, int Tk, int n_q_heads, int n_kv_heads,
                       int causal, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(G) * Tq;
  const int per_cta = kThreads / 32;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + per_cta - 1) /
                                                    per_cta),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_kv = static_cast<int>(BwdSmem<D>::kKVBytes);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D, T>
      <<<dim3(Gkv, (Tk + kTile - 1) / kTile), kThreads, smem_kv, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Tq, Tk, n_q_heads, n_kv_heads, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = static_cast<int>(BwdSmem<D>::kQBytes);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, T>
      <<<dim3(G, (Tq + kTile - 1) / kTile), kThreads, smem_q, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Tq, Tk,
          n_q_heads, n_kv_heads, causal, scale);
  return cudaGetLastError();
}

// float32 at head dims 16, 32, 64 and 128; bfloat16 at 16 and 32 only.
template <typename T>
cudaError_t dispatch_bwd(int d, const void* q, const void* k, const void* v,
                         const void* o, const float* lse, const void* dout,
                         void* dq, void* dk, void* dv, float* delta, int G,
                         int Gkv, int Tq, int Tk, int n_q_heads,
                         int n_kv_heads, int causal, float scale,
                         cudaStream_t s) {
#define REPRO_BWD_CASE(DIM)                                                  \
  case DIM:                                                                  \
    return launch_bwd<DIM, T>(q, k, v, o, lse, dout, dq, dk, dv, delta, G,   \
                              Gkv, Tq, Tk, n_q_heads, n_kv_heads, causal,    \
                              scale, s);
  switch (d) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    default:
      break;
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      REPRO_BWD_CASE(64)
      REPRO_BWD_CASE(128)
      default:
        break;
    }
  }
  return cudaErrorInvalidValue;
#undef REPRO_BWD_CASE
}

}  // namespace
}  // namespace repro

// q, o, do (G, Tq, d); k, v (G / Hq * Hkv, Tk, d); dq, dk, dv like q, k, v;
// lse (G, Tq) float32 from the forward; delta a (G, Tq) float32
// workspace; Tq <= Tk; d in {16, 32, 64, 128} for float32, {16, 32} for
// bfloat16.  Returns a cudaError_t.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int G, int Tq, int Tk, int d, int n_q_heads,
    int n_kv_heads, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q_heads <= 0 || n_kv_heads <= 0 || n_q_heads % n_kv_heads != 0 ||
      G % n_q_heads != 0 || Tq <= 0 || Tk < Tq) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Gkv = G / n_q_heads * n_kv_heads;
  if (dtype == repro::kFloat32) {
    return repro::dispatch_bwd<float>(d, q, k, v, o, lse, dout, dq, dk, dv,
                                      delta, G, Gkv, Tq, Tk, n_q_heads,
                                      n_kv_heads, causal, scale, s);
  }
  if (dtype == repro::kBFloat16) {
    return repro::dispatch_bwd<__nv_bfloat16>(
        d, q, k, v, o, lse, dout, dq, dk, dv, delta, G, Gkv, Tq, Tk,
        n_q_heads, n_kv_heads, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
