// Shared pieces of the repro_torch kernels: storage conversion, the one
// mode contraction both CFD kernels are built from, and the flash
// kernels' key limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Storage dtype codes, as the Python wrappers pass them.
enum Dtype : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Flash attention: the reference's key limit K_lim of query row `row`.
// The reference visits key blocks by the caller's bq x bk blocks (the
// effective ones, min(block, T)) and skips a key block wholly above its
// query block's last row, so the row sees keys [0, K_lim): 0 when its
// query block ends above every key, Tk when not causal.
__device__ __forceinline__ int key_limit(int row, int Tq, int Tk, int causal,
                                         int bq, int bk) {
  if (!causal) return Tk;
  const int q_end = (row / bq + 1) * bq - 1 + (Tk - Tq);
  return q_end < 0 ? 0 : min(Tk, (q_end / bk + 1) * bk);
}

// Flash attention: the keys [0, key_stop) that query rows r0..r1 (r1 <
// Tq) must visit.  A row that sees a key needs none past its own
// position: keys there score -1e30 and add p = 0 with a rescale of 1,
// exactly, so skipping them changes no bit.  A row that sees no key
// (causal, row < Tq - Tk) takes p = 1 on every key below its K_lim.
__device__ __forceinline__ int key_stop(int r0, int r1, int Tq, int Tk,
                                        int causal, int bq, int bk) {
  if (!causal) return Tk;
  const int q_offset = Tk - Tq;
  int stop = r1 + q_offset >= 0 ? r1 + q_offset + 1 : 0;
  const int last_masked = min(r1, -q_offset - 1);  // last row seeing none
  if (last_masked >= r0) {
    stop = max(stop, key_limit(last_masked, Tq, Tk, causal, bq, bk));
  }
  return stop;
}

// One mode contraction over a block of `be` elements held in shared
// memory, each a p x p x p cube stored row-major at src + e * p^3:
//
//   dst[e][o] = sum_l M(a, l) * src[e][y with axis `mode` set to l]
//
// where y is the in-place result index (axis `mode` holds the free index
// a) and the stored index is o[q] = y[perm[q]]'s position, i.e.
// y[perm[q]] = o[q].  M(a, l) = mat[a * a_stride + l * l_stride], so one
// matrix in shared memory serves both M and its transpose.  Every output
// entry is one p-term fmaf chain in ascending l: its value depends only
// on its own element, never on be, E or the grid.  Ends with a barrier.
__device__ __forceinline__ void contract_mode(
    float* __restrict__ dst, const float* __restrict__ src,
    const float* __restrict__ mat, int a_stride, int l_stride, int p,
    int be, int mode, int perm0, int perm1, int perm2) {
  const int p2 = p * p, p3 = p2 * p;
  const int stride[3] = {p2, p, 1};
  for (int idx = threadIdx.x; idx < be * p3; idx += blockDim.x) {
    const int e = idx / p3;
    const int r = idx - e * p3;
    int o[3];
    o[0] = r / p2;
    o[1] = (r / p) % p;
    o[2] = r % p;
    int y[3];
    y[perm0] = o[0];
    y[perm1] = o[1];
    y[perm2] = o[2];
    const int a = y[mode];
    int base = e * p3;
    for (int d = 0; d < 3; ++d) {
      if (d != mode) base += y[d] * stride[d];
    }
    const int step = stride[mode];
    const float* m = mat + a * a_stride;
    float acc = 0.0f;
    for (int l = 0; l < p; ++l) {
      acc = fmaf(m[l * l_stride], src[base + l * step], acc);
    }
    dst[idx] = acc;
  }
  __syncthreads();
}

}  // namespace repro
