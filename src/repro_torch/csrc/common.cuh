// Shared pieces of the repro_torch kernels: storage conversion, the flash
// kernels' key limit, and what both CFD kernels are built from (element
// cubes in shared memory, the register-blocked mode contraction, cp.async
// staging, the CTA tile).
#pragma once

#include <cstdint>

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

// Flash backward: sum_c b[c] a[c] over one row of d values, read by the
// 32 lanes of a warp (lane-strided fmaf chains, then an xor-shuffle
// tree); every lane gets the sum.  The whole warp calls it.
template <typename T>
__device__ __forceinline__ float row_dot(const T* __restrict__ a,
                                         const T* __restrict__ b, int d,
                                         int lane) {
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    acc = fmaf(to_float(b[c]), to_float(a[c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The CFD kernels' building blocks: element cubes in shared memory, the
// register-blocked mode contraction, and the cp.async staging of element
// blocks.
// ---------------------------------------------------------------------------

// Every p the CFD kernels are built for (the wrappers' MAX_P = 16).
#define REPRO_FOR_EACH_P(X)                                              \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
      X(14) X(15) X(16)

// Threads a CFD CTA may have, and the fibers each thread owns at once.
constexpr int kCubeMaxThreads = 192;
constexpr int kCubeMinThreads = 128;
constexpr int kFibers = 2;
// Shared memory per CTA under which three CTAs fit on one SM (228 KB per
// SM, 1 KB of it reserved per CTA).
constexpr int kCubeCtaTarget = 75 * 1024;
// Shared memory one block may use on an H100 (227 KB).
constexpr int kMaxSharedBytes = 232448;

// An f32 work cube of p x p x p in shared memory.  At even p the row pitch
// is p + 1: a warp's fibers are 32 consecutive (fixed-index) pairs, and an
// odd pitch keeps every mode at most two-way bank conflicted (a pitch of
// p = 8 or 16 words would serialise the strided modes up to 16-way).
template <int P>
struct Cube {
  static constexpr int kRow = P | 1;
  static constexpr int kPlane = P * kRow;
  static constexpr int kElem = P * kPlane;
};

// Columns of a contraction matrix M(a, l) in shared memory, padded to
// whole float4s so that a warp reads column l as uniform 16-byte
// broadcasts.
template <int P>
__host__ __device__ constexpr int mat_row() { return (P + 3) & ~3; }

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Axis strides of a cube (element pitch, then axes 0, 1, 2).
struct CubeView {
  int elem, s0, s1, s2;
};

// The strides a contraction along `mode` walks in view v: along the mode,
// then along the two fixed axes (lower axis first).
struct ModeStrides {
  int elem, sm, sq0, sq1;
};
__device__ __forceinline__ ModeStrides mode_strides(CubeView v, int mode) {
  return {v.elem, mode == 0 ? v.s0 : mode == 1 ? v.s1 : v.s2,
          mode == 0 ? v.s1 : v.s0, mode == 2 ? v.s1 : v.s2};
}
__device__ __forceinline__ int at(ModeStrides m, int e, int q0, int q1,
                                  int a) {
  return e * m.elem + q0 * m.sq0 + q1 * m.sq1 + a * m.sm;
}

// One mode contraction over the first n_fibers fibers of a block of cubes:
//
//   y[.., a at mode, ..] = sum_l M(a, l) x[.., l at mode, ..],
//
// M(a, l) = mcols[l * mat_row<P>() + a].  A fiber is the p inputs along
// `mode` at fixed other indices (q0 < q1 by axis, q1 fastest); fiber f is
// element f / p^2.  Each thread owns kFibers fibers (consecutive threads
// take neighbouring fibers) and keeps their p outputs in registers: at
// each l it loads x[l] of its fibers and the column M(:, l) as uniform
// float4 broadcasts, and adds the outer product.  Every output is so one
// fmaf chain in ascending l from 0.0f -- the sum the reference order
// fixes, so an output never depends on the tile, E or the batch split.
// Then epi(e, q0, q1, a, y) stores each output.  No barrier.
template <int P, typename TS, typename Epi>
__device__ __forceinline__ void contract(const TS* __restrict__ src,
                                         CubeView v, int mode,
                                         const float* __restrict__ mcols,
                                         int n_fibers, Epi epi) {
  constexpr int MR = mat_row<P>();
  const ModeStrides ms = mode_strides(v, mode);
  for (int f0 = threadIdx.x; f0 < n_fibers;
       f0 += kFibers * static_cast<int>(blockDim.x)) {
    const TS* px[kFibers];
    int e[kFibers], q0[kFibers], q1[kFibers];
    bool on[kFibers];
#pragma unroll
    for (int s = 0; s < kFibers; ++s) {
      const int f = min(f0 + s * static_cast<int>(blockDim.x), n_fibers - 1);
      on[s] = f0 + s * static_cast<int>(blockDim.x) < n_fibers;
      e[s] = f / (P * P);
      const int r = f - e[s] * (P * P);
      q0[s] = r / P;
      q1[s] = r - q0[s] * P;
      px[s] = src + at(ms, e[s], q0[s], q1[s], 0);
    }
    // outer products: y[s][a] += M(a, l) x[s][l], l ascending
    float y[kFibers][P];
#pragma unroll
    for (int s = 0; s < kFibers; ++s) {
#pragma unroll
      for (int a = 0; a < P; ++a) y[s][a] = 0.0f;
    }
#pragma unroll
    for (int l = 0; l < P; ++l) {
      float x[kFibers];
#pragma unroll
      for (int s = 0; s < kFibers; ++s) x[s] = to_float(px[s][l * ms.sm]);
      float m[MR];
#pragma unroll
      for (int c = 0; c < MR; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(mcols + l * MR + c);
        m[c] = q.x;
        m[c + 1] = q.y;
        m[c + 2] = q.z;
        m[c + 3] = q.w;
      }
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int s = 0; s < kFibers; ++s) y[s][a] = fmaf(m[a], x[s], y[s][a]);
      }
    }
#pragma unroll
    for (int s = 0; s < kFibers; ++s) {
      if (!on[s]) continue;
#pragma unroll
      for (int a = 0; a < P; ++a) epi(e[s], q0[s], q1[s], a, y[s][a]);
    }
  }
}

// Write M(a, l) = m[a][l] (transpose false) or m[l][a] (true) of a p x p
// matrix in device memory as padded columns in shared memory (column l at
// cols + l * mat_row<P>()).
template <int P, typename T>
__device__ __forceinline__ void load_mat_cols(float* __restrict__ cols,
                                              const T* __restrict__ m,
                                              bool transpose) {
  constexpr int MR = mat_row<P>();
  for (int i = threadIdx.x; i < P * MR; i += blockDim.x) {
    const int l = i / MR, a = i - l * MR;
    cols[i] = a < P ? to_float(transpose ? m[l * P + a] : m[a * P + l]) : 0.0f;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed cp.async groups are in
// flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of one staging region holding `elems` values of T: the copy keeps
// device memory's offset modulo 16, so a region has 16 bytes of slack.
__host__ __device__ constexpr int stage_bytes(int elems, int elem_bytes) {
  return round16(elems * elem_bytes) + 16;
}

// An element value the staging leaves to a plain load: the under-16-byte
// head and tail of a range.  The thread holds it in a register until the
// tile is needed, so the load overlaps the current tile's work.
template <typename T>
struct Held {
  T v;
  T* dst = nullptr;
  __device__ __forceinline__ void flush() {
    if (dst) *dst = v;
    dst = nullptr;
  }
};

// Where stage_async puts value 0 of g in `region`: at g's offset modulo 16.
template <typename T>
__device__ __forceinline__ const T* staged(const void* region, const T* g) {
  return reinterpret_cast<const T*>(static_cast<const char*>(region) +
                                    (reinterpret_cast<uintptr_t>(g) & 15));
}

// Start copying n values of T from device memory at g into the staging
// region `region` (16-byte aligned; staged(region, g) is value 0):
// cp.async of 16 bytes for the aligned middle, and plain loads for the
// head and tail, which threads slot * 2 * (16 / sizeof(T)) + j hold (no
// over-read: every byte copied lies in [g, g + n)).  Before the values
// are read: commit and wait for the copies, held.flush() and a barrier.
template <typename T>
__device__ __forceinline__ void stage_async(void* region, const T* g, int n,
                                            int slot, Held<T>& held) {
  constexpr int kEdge = 16 / sizeof(T);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t end = ga + static_cast<uintptr_t>(n) * sizeof(T);
  const uintptr_t base = ga & ~uintptr_t(15);
  uintptr_t c0 = (ga + 15) & ~uintptr_t(15);
  if (c0 > end) c0 = end;
  uintptr_t c1 = end & ~uintptr_t(15);
  if (c1 < c0) c1 = c0;
  char* s = static_cast<char*>(region);
  const int chunks = static_cast<int>((c1 - c0) / 16);
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    cp_async16(s + (c0 - base) + 16 * k,
               reinterpret_cast<const char*>(c0) + 16 * k);
  }
  const int n_head = static_cast<int>((c0 - ga) / sizeof(T));
  const int n_tail = static_cast<int>((end - c1) / sizeof(T));
  const int j = static_cast<int>(threadIdx.x) - slot * 2 * kEdge;
  if (j >= 0 && j < n_head) {
    held.v = g[j];
    held.dst = reinterpret_cast<T*>(s + (ga - base)) + j;
  } else if (j >= kEdge && j - kEdge < n_tail) {
    const int i = static_cast<int>((c1 - ga) / sizeof(T)) + (j - kEdge);
    held.v = g[i];
    held.dst = reinterpret_cast<T*>(s + (ga - base)) + i;
  }
}

// The CTA's tile: te elements a step (the plan's block size), its thread
// count and its shared memory, for a CFD kernel at p with `n_stage`
// staging buffers (a tile of one element input each, elem_bytes a value),
// `n_work` f32 work cubes and `n_mat_rows` padded matrix row blocks.
// Threads follow te: kFibers fibers a thread, whole warps, at least
// kCubeMinThreads.  Mirrored by repro_torch.kernels._cube.
struct CubeTile {
  int te, threads, smem;
};

__host__ __device__ constexpr int cube_smem(int p, int te, int n_stage,
                                            int elem_bytes, int n_work,
                                            int n_mat_rows) {
  return round16(n_mat_rows * p * ((p + 3) & ~3) * 4) +
         n_stage * stage_bytes(te * p * p * p, elem_bytes) +
         n_work * round16(te * p * p * (p | 1) * 4);
}

__host__ __device__ constexpr int cube_threads(int p, int te) {
  int threads = (te * p * p + kFibers - 1) / kFibers;
  threads = (threads + 31) / 32 * 32;
  return threads < kCubeMinThreads ? kCubeMinThreads : threads;
}

// The tile at te; te <= 0 takes the default, which fills a CTA's fibers
// (kFibers * kCubeMaxThreads) and, where it can, keeps three CTAs on an
// SM.
__host__ __device__ constexpr CubeTile cube_tile(int p, int n_stage,
                                                 int elem_bytes, int n_work,
                                                 int n_mat_rows, int te = 0) {
  if (te <= 0) {
    te = kFibers * kCubeMaxThreads / (p * p);
    if (te < 1) te = 1;
    while (te > 1 && cube_smem(p, te, n_stage, elem_bytes, n_work,
                               n_mat_rows) > kCubeCtaTarget) {
      --te;
    }
  }
  return {te, cube_threads(p, te),
          cube_smem(p, te, n_stage, elem_bytes, n_work, n_mat_rows)};
}

// The largest te a CFD kernel launches with: at most kCubeMaxThreads
// threads (its __launch_bounds__) and one block's shared memory; 0 where
// not even one element fits.
__host__ __device__ constexpr int cube_max_tile(int p, int n_stage,
                                                int elem_bytes, int n_work,
                                                int n_mat_rows) {
  int te = kFibers * kCubeMaxThreads / (p * p);
  while (te > 0 && cube_smem(p, te, n_stage, elem_bytes, n_work,
                             n_mat_rows) > kMaxSharedBytes) {
    --te;
  }
  return te;
}

// Persistent grid: as many CTAs as fit on the card at once, at most one
// per tile.
template <typename K>
static cudaError_t persistent_grid(K kernel, CubeTile t, int n_tiles,
                                   int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        t.threads, t.smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  return cudaSuccess;
}

}  // namespace repro
