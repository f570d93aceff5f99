// Fused Inverse-Helmholtz operator for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/helmholtz/helmholtz.py,
//   inverse_helmholtz_pallas (body _helmholtz_block) -- the TPU kernel that
//   runs each block of BE elements through three (p x p) x (p x BE*p^2)
//   MXU GEMMs per side.
//
// Computes, per element:  t = (S^T (x) S^T (x) S^T) u,  r = D o t,
//   v = (S (x) S (x) S) r, i.e. t_ijk = sum S_il S_jm S_kn u_lmn and
//   v_ijk = sum S_li S_mj S_nk r_lmn, accumulated in f32 and stored in the
//   input dtype (f32 or bf16).
//
// Bound on an H100 SXM: device-memory bytes.  Each element reads u and D
// and writes v once (3 p^3 scalars: 16 KB at p = 11, f32) and does about
// 12 p^4 + p^3 flops, so the work sits far below the card's
// flop-per-byte balance: at E = 50,420 and p = 11 that is 805 MB per
// batch, 0.24 ms at 3.35 TB/s against 0.13 ms of f32 FMA work.
//
// Design: one CTA per block of BE elements (BE from the plan; the wrapper
// keeps the reference's E % BE check).  S sits once in shared memory and
// is read with swapped strides for S^T.  u is loaded coalesced into one
// shared buffer; the six contractions ping-pong between two shared
// buffers (u -> t1 -> t2 -> t, r in place, -> ... -> v) so no
// intermediate ever touches device memory, and D is read once straight
// from device memory for the Hadamard step.  Every output entry is a
// p-term fmaf chain in ascending l, so an element's result never depends
// on BE, E or how a batch is split.  Shared memory is 4 (p^2 + 2 BE p^3)
// bytes (43 KB at p = 11, BE = 4); above 48 KB the launch needs
// cudaFuncAttributeMaxDynamicSharedMemorySize, which is set per launch.
// The plain loop over p is CUDA-core FMA: p = 11 is below the tensor
// cores' MMA depth and TF32 would break f32 parity.
#include <cstdint>

#include "common.cuh"

namespace repro {

template <typename T>
__global__ void helmholtz_kernel(const T* __restrict__ S,
                                 const T* __restrict__ D,
                                 const T* __restrict__ u, T* __restrict__ v,
                                 int p, int be) {
  extern __shared__ float smem[];
  const int p2 = p * p, p3 = p2 * p;
  const int n = be * p3;
  float* s = smem;          // S, p x p
  float* buf0 = s + p2;     // ping
  float* buf1 = buf0 + n;   // pong
  const int64_t off = static_cast<int64_t>(blockIdx.x) * n;

  for (int i = threadIdx.x; i < p2; i += blockDim.x) s[i] = to_float(S[i]);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    buf0[i] = to_float(u[off + i]);
  }
  __syncthreads();

  // t = (S^T)^{(x)3} u: M(a, l) = S[a][l]
  contract_mode(buf1, buf0, s, p, 1, p, be, 0, 0, 1, 2);
  contract_mode(buf0, buf1, s, p, 1, p, be, 1, 0, 1, 2);
  contract_mode(buf1, buf0, s, p, 1, p, be, 2, 0, 1, 2);
  // r = D o t, in place
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    buf1[i] *= to_float(D[off + i]);
  }
  __syncthreads();
  // v = S^{(x)3} r: M(a, l) = S[l][a]
  contract_mode(buf0, buf1, s, 1, p, p, be, 0, 0, 1, 2);
  contract_mode(buf1, buf0, s, 1, p, p, be, 1, 0, 1, 2);
  contract_mode(buf0, buf1, s, 1, p, p, be, 2, 0, 1, 2);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    v[off + i] = from_float<T>(buf0[i]);
  }
}

template <typename T>
static cudaError_t launch_helmholtz(const void* S, const void* D,
                                    const void* u, void* v, int E, int p,
                                    int be, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(p) * p +
                       2 * static_cast<size_t>(be) * p * p * p);
  cudaError_t err = cudaFuncSetAttribute(
      helmholtz_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  helmholtz_kernel<T><<<E / be, 256, smem, stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(D),
      static_cast<const T*>(u), static_cast<T*>(v), p, be);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_helmholtz(const void* S, const void* D, const void* u,
                               void* v, int E, int p, int be, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) {
    return repro::launch_helmholtz<float>(S, D, u, v, E, p, be, s);
  }
  if (dtype == repro::kBFloat16) {
    return repro::launch_helmholtz<__nv_bfloat16>(S, D, u, v, E, p, be, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
