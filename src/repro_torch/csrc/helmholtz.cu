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
// batch, 0.24 ms at 3.35 TB/s against 0.13 ms of f32 FMA work.  On the
// card the contractions take most of the time all the same: each output
// needs its p matrix values delivered from shared memory to registers,
// shared by only the kFibers fibers a thread holds, and a bfloat16 run,
// with half the bytes, takes nearly as long as a float32 one.
//
// Design (common.cuh):
// - p is a template parameter (1..16, one instantiation each, chosen by a
//   switch at launch), so index arithmetic is by constants, once a fiber.
// - Each thread owns kFibers fibers along the contracted mode and keeps
//   their p outputs in registers: at each l it loads x[l] of its fibers
//   and the matrix column M(:, l) as uniform float4 broadcasts (S and
//   S^T are both kept, columns padded to a multiple of 4) and adds the
//   outer product, about 0.25 shared loads per FMA against 2 in a
//   one-output-per-thread loop.  Every output is one fmaf chain in
//   ascending l from 0.0f, the arithmetic of the earlier
//   one-output-per-thread kernel, so every bit is as before and never
//   depends on tiles, E or the split.
// - The six contractions run in place in one f32 work cube per element
//   (row pitch p + 1 at even p against bank conflicts): a thread holds
//   its fibers in registers and writes its outputs back to those same
//   fibers, so no other thread's input changes under it.  The third one
//   multiplies by D as it stores (r = t * D, one rounding, as before).
//   The sixth stores to shared memory too, and a coalesced pass writes v:
//   a direct store along mode 2 would put a warp's lanes p words apart,
//   eight times the L2 write transactions.
// - Persistent grid, as many CTAs as fit at once (four an SM at p = 11),
//   each walking tiles of te elements.  The first contraction reads u
//   from its staging buffer and the third reads D there, in the storage
//   dtype; as soon as one has been read, cp.async starts copying the next
//   tile's into the same buffer (16-byte copies of the aligned middle;
//   the head and tail under 16 bytes by plain loads held in registers,
//   so any 2- or 4-byte alignment works), so the copies overlap the
//   remaining contractions with one buffer per input.
// - BE: the plan's block_elements is te, the elements a CTA takes a step
//   (cube_tile: threads follow te; without a block, 3 elements at
//   p = 11, f32, fill a CTA's 2 x 192 fiber slots within 75 KB of shared
//   memory).  The launch refuses a te above cube_max_tile (more than 192
//   threads or one block's shared memory), and the last tile may be
//   ragged, so E need not be a multiple of te.  Results depend on
//   neither.
// CUDA-core FMA: p = 11 is below the tensor cores' MMA depth and TF32
// would break f32 parity.
#include <cstdint>

#include "common.cuh"

namespace repro {

// Staged element inputs, work cubes and matrix row blocks.
constexpr int kHhStage = 2, kHhWork = 1, kHhMats = 2;
// CTAs an SM should hold: four at p = 11 (49 KB each) caps registers at
// 80, which ran 2 % faster on the H100 than three (96 registers) despite
// a few spilled bytes.
constexpr int kHhMinCtas = 4;

struct ToCube {  // store y into an f32 work cube
  float* dst;
  ModeStrides m;
  __device__ __forceinline__ void operator()(int e, int q0, int q1, int a,
                                             float y) const {
    dst[at(m, e, q0, q1, a)] = y;
  }
};

template <typename T>
struct ToCubeTimesD {  // r = t * D, then store
  float* dst;
  ModeStrides m;
  const T* d;
  ModeStrides dm;
  __device__ __forceinline__ void operator()(int e, int q0, int q1, int a,
                                             float y) const {
    dst[at(m, e, q0, q1, a)] = y * to_float(d[at(dm, e, q0, q1, a)]);
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(kCubeMaxThreads, kHhMinCtas)
    helmholtz_kernel(const T* __restrict__ S, const T* __restrict__ D,
                     const T* __restrict__ u, T* __restrict__ v, int E,
                     int te) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Cube<P>;
  constexpr int MR = mat_row<P>(), P3 = P * P * P;
  const int n_tiles = (E + te - 1) / te;
  float* s_cols = reinterpret_cast<float*>(smem);  // M(a, l) = S[a][l]
  float* st_cols = s_cols + P * MR;                // M(a, l) = S[l][a]
  unsigned char* stage = smem + round16(kHhMats * P * MR * 4);
  const int sb = stage_bytes(te * P3, sizeof(T));  // u, then D
  float* A = reinterpret_cast<float*>(stage + kHhStage * sb);

  load_mat_cols<P>(s_cols, S, false);
  load_mat_cols<P>(st_cols, S, true);

  const CubeView work{C::kElem, C::kPlane, C::kRow, 1};
  const CubeView flat{P3, P * P, P, 1};
  Held<T> held;
  // stage input `which` (0 u, 1 D) of a tile
  auto issue = [&](int tile, int which) {
    const int64_t off = static_cast<int64_t>(tile) * te * P3;
    const int n = min(te, E - tile * te) * P3;
    stage_async(stage + which * sb, (which ? D : u) + off, n, which, held);
  };
  int tile = blockIdx.x;
  if (tile < n_tiles) {
    issue(tile, 0);
    issue(tile, 1);
  }
  for (; tile < n_tiles; tile += gridDim.x) {
    cp_async_commit();
    cp_async_wait<0>();
    held.flush();
    __syncthreads();
    const int next = tile + static_cast<int>(gridDim.x);
    const int64_t off = static_cast<int64_t>(tile) * te * P3;
    const int n = min(te, E - tile * te);
    const int nf = n * P * P;
    const T* xu = staged(stage, u + off);
    const T* xd = staged(stage + sb, D + off);

    // t = (S^T)^{(x)3} u: M(a, l) = S[a][l]; r = D o t on the third store
    contract<P>(xu, flat, 0, s_cols, nf, ToCube{A, mode_strides(work, 0)});
    __syncthreads();
    if (next < n_tiles) issue(next, 0);  // u is read: fetch the next one
    contract<P>(A, work, 1, s_cols, nf, ToCube{A, mode_strides(work, 1)});
    __syncthreads();
    contract<P>(A, work, 2, s_cols, nf,
                ToCubeTimesD<T>{A, mode_strides(work, 2), xd,
                                mode_strides(flat, 2)});
    __syncthreads();
    if (next < n_tiles) issue(next, 1);  // and D
    // v = S^{(x)3} r: M(a, l) = S[l][a]
    contract<P>(A, work, 0, st_cols, nf, ToCube{A, mode_strides(work, 0)});
    __syncthreads();
    contract<P>(A, work, 1, st_cols, nf, ToCube{A, mode_strides(work, 1)});
    __syncthreads();
    contract<P>(A, work, 2, st_cols, nf, ToCube{A, mode_strides(work, 2)});
    __syncthreads();
    for (int i = threadIdx.x; i < n * P3; i += blockDim.x) {
      int k = i;
      if constexpr (C::kRow != P) {
        const int e = i / P3, r = i - e * P3;
        const int i0 = r / (P * P), r2 = r - i0 * (P * P);
        const int j = r2 / P;
        k = e * C::kElem + i0 * C::kPlane + j * C::kRow + (r2 - j * P);
      }
      v[off + i] = from_float<T>(A[k]);
    }
  }
}

template <typename T, int P>
constexpr CubeTile helmholtz_tile(int te) {
  return cube_tile(P, kHhStage, sizeof(T), kHhWork, kHhMats, te);
}

template <typename T, int P>
constexpr int helmholtz_max_tile() {
  return cube_max_tile(P, kHhStage, sizeof(T), kHhWork, kHhMats);
}

template <typename T, int P>
static cudaError_t launch_helmholtz(const void* S, const void* D,
                                    const void* u, void* v, int E, int te,
                                    cudaStream_t stream) {
  const CubeTile t = helmholtz_tile<T, P>(te);
  if (t.te > helmholtz_max_tile<T, P>()) return cudaErrorInvalidValue;
  if (E <= 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err = persistent_grid(helmholtz_kernel<T, P>, t,
                                    (E + t.te - 1) / t.te, &grid);
  if (err != cudaSuccess) return err;
  helmholtz_kernel<T, P><<<grid, t.threads, t.smem, stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(D),
      static_cast<const T*>(u), static_cast<T*>(v), E, t.te);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_helmholtz(const void* S, const void* D,
                                      const void* u, void* v, int E, int p,
                                      int te, cudaStream_t s) {
  switch (p) {
#define REPRO_HH_CASE(P) \
  case P:                \
    return launch_helmholtz<T, P>(S, D, u, v, E, te, s);
    REPRO_FOR_EACH_P(REPRO_HH_CASE)
#undef REPRO_HH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// {te, threads, shared bytes, largest te} at p (zeros for a p the kernel
// does not take)
template <typename T>
static void tile_of(int p, int te, int* out) {
  CubeTile t{0, 0, 0};
  int max_te = 0;
  switch (p) {
#define REPRO_HH_CASE(P)               \
  case P:                              \
    t = helmholtz_tile<T, P>(te);      \
    max_te = helmholtz_max_tile<T, P>(); \
    break;
    REPRO_FOR_EACH_P(REPRO_HH_CASE)
#undef REPRO_HH_CASE
    default:
      break;
  }
  out[0] = t.te;
  out[1] = t.threads;
  out[2] = t.smem;
  out[3] = max_te;
}

}  // namespace repro

// te: the elements a CTA takes a step; te <= 0 takes the kernel's default.
extern "C" int repro_helmholtz(const void* S, const void* D, const void* u,
                               void* v, int E, int p, int dtype, int te,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) {
    return repro::dispatch_helmholtz<float>(S, D, u, v, E, p, te, s);
  }
  if (dtype == repro::kBFloat16) {
    return repro::dispatch_helmholtz<__nv_bfloat16>(S, D, u, v, E, p, te, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's tile at p and te (te <= 0: the default): {te, threads,
// shared bytes, largest te}, for the wrapper's mirror to be checked
// against.
extern "C" int repro_helmholtz_tile(int p, int dtype, int te, int* out) {
  if (dtype == repro::kBFloat16) {
    repro::tile_of<__nv_bfloat16>(p, te, out);
  } else {
    repro::tile_of<float>(p, te, out);
  }
  return 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
