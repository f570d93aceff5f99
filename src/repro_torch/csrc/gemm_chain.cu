// Generic GEMM-chain kernel for Hopper (sm_90a): one fused CU for any
// stage made of shared-matrix mode contractions and elementwise ops.
//
// Replaces: src/repro/kernels/gemm/gemm.py, gemm_chain_pallas (built in
//   _pallas_fn, body _kernel -> apply_recipe) -- the TPU kernel that runs
//   a GemmRecipe over blocks of BE elements with one MXU GEMM per
//   contraction.
//
// Computes a recipe read from a small int32 op table, so one build serves
// every recipe (no per-recipe code generation and no compile on the run's
// path):
//   contract: y[.., a at mode, ..] = sum_l M(a, l) x[.., l, ..], stored
//             with the element axes permuted by perm;
//   ewise:    add / sub / mul / div between element values, neg, scale.
// All arithmetic is f32; outputs are stored in the input dtype (f32 or
// bf16; the wrapper requires one dtype, so the output dtype is that of
// the recipe's first input, as in the reference).
//
// Bound on an H100 SXM: device-memory bytes.  At p = 11 a contraction is
// 2 p flops per output entry, so the interpolation stage (u in, w out,
// 3 contractions) and the gradient stage (w in, gx/gy/gz out) do about
// 5 flops per byte moved, far below the card's balance: at E = 50,420
// the interpolation moves 537 MB (0.16 ms at 3.35 TB/s) and the gradient
// 1,074 MB (0.32 ms).
//
// Design: one CTA per block of BE elements.  Every value slot of the
// recipe that carries the element axis (inputs and op results alike) is
// a p^3 f32 cube per element in shared memory, and the shared (p, p)
// matrices sit there too, so the chain runs between loading the element
// inputs (coalesced) and storing the outputs without touching device
// memory.  Slots are not reused: interpolation and gradient need 4 each
// (21 KB per element at p = 11).  A contraction applies perm at the
// store and sums in ascending l with fmaf, so an element's result never
// depends on BE, E or how a batch is split.
#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int kMaxIn = 8;
constexpr int kMaxOut = 8;
constexpr int kMaxOps = 32;
constexpr int kMaxSlots = 8;
constexpr int kMaxMats = 8;
constexpr int kOpWidth = 10;

// Op table rows.  Slots index element cubes in shared memory; mats index
// the shared matrices.
//   contract: {0, dst, src, mat, mode, mat_dim, perm0, perm1, perm2, 0}
//   ewise:    {1 + code, dst, lhs, rhs, 0, ...}, code in
//             0 add, 1 sub, 2 mul, 3 div, 4 neg, 5 scale (consts[i])
struct GemmChainArgs {
  const void* in[kMaxIn];
  void* out[kMaxOut];
  int n_in, n_out, n_ops, n_slots, n_mats, p, be;
  int in_is_elem[kMaxIn];
  int in_index[kMaxIn];  // element slot or matrix index
  int out_slot[kMaxOut];
  int ops[kMaxOps][kOpWidth];
  float consts[kMaxOps];
};

template <typename T>
__global__ void gemm_chain_kernel(const __grid_constant__ GemmChainArgs args) {
  extern __shared__ float smem[];
  const int p = args.p, p2 = p * p, p3 = p2 * p;
  const int n = args.be * p3;
  float* mats = smem;                      // n_mats x p x p
  float* slots = smem + args.n_mats * p2;  // n_slots x (be x p^3)
  const int64_t off = static_cast<int64_t>(blockIdx.x) * n;

  for (int j = 0; j < args.n_in; ++j) {
    const T* src = static_cast<const T*>(args.in[j]);
    if (args.in_is_elem[j]) {
      float* dst = slots + args.in_index[j] * n;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        dst[i] = to_float(src[off + i]);
      }
    } else {
      float* dst = mats + args.in_index[j] * p2;
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        dst[i] = to_float(src[i]);
      }
    }
  }
  __syncthreads();

  for (int k = 0; k < args.n_ops; ++k) {
    const int* op = args.ops[k];
    float* dst = slots + op[1] * n;
    if (op[0] == 0) {
      // mat_dim 0: M(a, l) = m[l][a]; mat_dim 1: M(a, l) = m[a][l]
      const bool dim0 = op[5] == 0;
      contract_mode(dst, slots + op[2] * n, mats + op[3] * p2,
                    dim0 ? 1 : p, dim0 ? p : 1, p, args.be, op[4], op[6],
                    op[7], op[8]);
      continue;
    }
    const float* a = slots + op[2] * n;
    const float* b = slots + (op[3] >= 0 ? op[3] : op[2]) * n;
    const int code = op[0] - 1;
    const float c = args.consts[k];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float y;
      switch (code) {
        case 0: y = a[i] + b[i]; break;
        case 1: y = a[i] - b[i]; break;
        case 2: y = a[i] * b[i]; break;
        case 3: y = a[i] / b[i]; break;
        case 4: y = -a[i]; break;
        default: y = a[i] * c; break;
      }
      dst[i] = y;
    }
    __syncthreads();
  }

  for (int j = 0; j < args.n_out; ++j) {
    T* dst = static_cast<T*>(args.out[j]);
    const float* src = slots + args.out_slot[j] * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      dst[off + i] = from_float<T>(src[i]);
    }
  }
}

template <typename T>
static cudaError_t launch_gemm_chain(const GemmChainArgs& args, int E,
                                     cudaStream_t stream) {
  const int p = args.p;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(args.n_mats) * p * p +
       static_cast<size_t>(args.n_slots) * args.be * p * p * p);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gemm_chain_kernel<T><<<E / args.be, 256, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_gemm_chain_limits(int* out) {
  out[0] = repro::kMaxIn;
  out[1] = repro::kMaxOut;
  out[2] = repro::kMaxOps;
  out[3] = repro::kMaxSlots;
  out[4] = repro::kMaxMats;
  out[5] = repro::kOpWidth;
  out[6] = static_cast<int>(sizeof(repro::GemmChainArgs));
  return 0;
}

extern "C" int repro_gemm_chain(const repro::GemmChainArgs* args, int E,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->n_in > repro::kMaxIn || args->n_out > repro::kMaxOut ||
      args->n_ops > repro::kMaxOps || args->n_slots > repro::kMaxSlots ||
      args->n_mats > repro::kMaxMats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == repro::kFloat32) {
    return repro::launch_gemm_chain<float>(*args, E, s);
  }
  if (dtype == repro::kBFloat16) {
    return repro::launch_gemm_chain<__nv_bfloat16>(*args, E, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
