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
// 1,074 MB (0.32 ms).  On the card the contractions take most of the
// time all the same (chip_smoke.py's probe: at interpolation's bytes the
// kernel with no contraction takes about 0.21 ms, each contraction adds
// about 0.12 ms), as in helmholtz.cu.
//
// Design (common.cuh; the same building blocks as helmholtz.cu):
// - p is a template parameter (1..16, a switch at launch); the op table
//   stays runtime data.  Contractions use the register-blocked fiber
//   routine (kFibers fibers a thread, M columns as float4 broadcasts, one
//   ascending-l fmaf chain from 0.0f per output, so every bit equals the
//   earlier one-output-per-thread kernel's and never depends on tiles, E
//   or the split).  The
//   perm is folded into three output strides a fiber, not a division per
//   entry.
// - Shared memory by liveness (gemm.py buffer_table): element inputs are
//   read where they are staged, in the storage dtype; an op result gets
//   an f32 work cube (row pitch p + 1 at even p) only if a later op reads
//   it, and a cube is reused once its slot's last reader has run, or by
//   that reader itself where it writes in place (an ewise op, or a
//   contraction without a perm: a thread writes back the fibers it
//   holds in registers).  Every output is stored from registers straight
//   to device memory as its op produces it, with no staging pass: for
//   the CFD recipes each store
//   instruction covers runs of p or p^2 consecutive values (interp's last
//   contraction runs along mode 1, grad's perms put the new axis first).
//   Interpolation holds 1 work cube, the gradient none (w is read from
//   its staging buffer and gx, gy, gz go out from registers).
// - Persistent grid; at the top of each tile cp.async starts copying the
//   next tile's element inputs into the other staging buffer (copies as
//   in helmholtz.cu), before waiting for this tile's, so two tiles' copies
//   are in flight.  A thread gets there only past the last tile's final
//   barrier: the one after its last op, or, where inputs are fed
//   straight out, the one after that copy.  Two buffers, not
//   helmholtz.cu's one refilled once read: the gradient reads w in every
//   op, so a buffer refilled after its last reader would not overlap the
//   copy with any work, and the kernel's occupancy is bounded by
//   registers, not shared memory (one
//   buffer, at three CTAs an SM, ran interpolation 15 % and the gradient
//   10 % slower on the H100).
// - BE: the plan's block_elements is te, the elements a CTA takes a step
//   (cube_tile: threads follow te; the default depends on p, the dtype
//   and the recipe's cube counts).  The launch refuses a te above
//   cube_max_tile, and the last tile may be ragged, so E need not be a
//   multiple of te.
#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int kMaxIn = 8;
constexpr int kMaxOut = 8;
constexpr int kMaxOps = 32;
constexpr int kMaxMats = 8;
constexpr int kOpWidth = 10;
// Element slots: every element input and every op result has one, so a
// recipe within the other limits always fits.  A slot is only an index
// (shared memory follows the work cubes, n_bufs <= n_slots).
constexpr int kMaxSlots = kMaxIn + kMaxOps;

// Op table rows.  Element slots number the element inputs first (slot j
// is staged input j), then one slot per op; mats index the shared
// matrices.
//   contract: {0, dst, src, mat, mode, mat_dim, perm0, perm1, perm2, 0}
//   ewise:    {1 + code, dst, lhs, rhs, 0, ...}, code in
//             0 add, 1 sub, 2 mul, 3 div, 4 neg, 5 scale (consts[i])
// slot_buf gives each op result its work cube, -1 where no later op reads
// it (n_bufs cubes in all).
struct GemmChainArgs {
  const void* in[kMaxIn];
  void* out[kMaxOut];
  int n_in, n_out, n_ops, n_slots, n_mats, p;
  int in_is_elem[kMaxIn];
  int in_index[kMaxIn];  // element slot or matrix index
  int out_slot[kMaxOut];
  int ops[kMaxOps][kOpWidth];
  float consts[kMaxOps];
  int n_bufs;
  int slot_buf[kMaxSlots];
};

__host__ __device__ inline int n_elem_inputs(const GemmChainArgs& a) {
  int n = 0;
  for (int j = 0; j < a.n_in; ++j) n += a.in_is_elem[j];
  return n;
}

__host__ __device__ inline CubeTile chain_tile(const GemmChainArgs& a,
                                               int elem_bytes, int te) {
  return cube_tile(a.p, 2 * n_elem_inputs(a), elem_bytes, a.n_bufs,
                   2 * a.n_mats, te);
}

__host__ __device__ inline int chain_max_tile(const GemmChainArgs& a,
                                              int elem_bytes) {
  return cube_max_tile(a.p, 2 * n_elem_inputs(a), elem_bytes, a.n_bufs,
                       2 * a.n_mats);
}

// Stores a contraction's outputs: into its work cube (if any) and into
// each device-memory output fed by its slot (first one, then the rare
// others named in `more`), all with the perm folded into the strides.
template <typename T>
struct ChainStore {
  float* buf;
  ModeStrides bm;
  T* out;  // at this tile
  ModeStrides om;
  void* const* outs;
  int64_t off;
  int more;
  __device__ __forceinline__ void operator()(int e, int q0, int q1, int a,
                                             float y) const {
    if (buf) buf[at(bm, e, q0, q1, a)] = y;
    if (out) out[at(om, e, q0, q1, a)] = from_float<T>(y);
    if (more) {
      for (int j = 0; j < kMaxOut; ++j) {
        if (more >> j & 1) {
          static_cast<T*>(outs[j])[off + at(om, e, q0, q1, a)] =
              from_float<T>(y);
        }
      }
    }
  }
};

// The view of a cube stored with the element axes permuted by perm
// (o[q] = y[perm[q]]): y-axis perm[q] strides like stored axis q.
__device__ __forceinline__ CubeView permuted(CubeView v, const int* perm) {
  auto stride = [&](int d) {
    return perm[0] == d ? v.s0 : perm[1] == d ? v.s1 : v.s2;
  };
  return {v.elem, stride(0), stride(1), stride(2)};
}

template <typename T, int P>
__global__ void __launch_bounds__(kCubeMaxThreads)
    gemm_chain_kernel(const __grid_constant__ GemmChainArgs args, int E,
                      int te) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Cube<P>;
  constexpr int MR = mat_row<P>(), P3 = P * P * P;
  const int n_tiles = (E + te - 1) / te;
  const int n_elem = n_elem_inputs(args);
  // matrix m as M(a, l) = m[l][a] at block 2m, m[a][l] at block 2m + 1
  float* mats = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + round16(2 * args.n_mats * P * MR * 4);
  const int sb = stage_bytes(te * P3, sizeof(T));  // [buffer][elem input]
  float* work = reinterpret_cast<float*>(stage + 2 * n_elem * sb);
  const int wb = round16(te * C::kElem * 4) / 4;

  for (int j = 0; j < args.n_in; ++j) {
    if (!args.in_is_elem[j]) {
      const T* m = static_cast<const T*>(args.in[j]);
      float* cols = mats + 2 * args.in_index[j] * P * MR;
      load_mat_cols<P>(cols, m, true);
      load_mat_cols<P>(cols + P * MR, m, false);
    }
  }

  const CubeView cube{C::kElem, C::kPlane, C::kRow, 1};
  const CubeView flat{P3, P * P, P, 1};
  Held<T> held;
  auto issue = [&](int tile, int buf) {
    const int64_t off = static_cast<int64_t>(tile) * te * P3;
    const int n = min(te, E - tile * te) * P3;
    for (int j = 0; j < args.n_in; ++j) {
      if (args.in_is_elem[j]) {
        const int r = args.in_index[j];
        stage_async(stage + (buf * n_elem + r) * sb,
                    static_cast<const T*>(args.in[j]) + off, n, r, held);
      }
    }
  };
  // element slot s < n_elem: staged input s, read in the storage dtype
  auto staged_in = [&](int s, int buf, int64_t off) {
    for (int j = 0; j < args.n_in; ++j) {
      if (args.in_is_elem[j] && args.in_index[j] == s) {
        return staged(stage + (buf * n_elem + s) * sb,
                      static_cast<const T*>(args.in[j]) + off);
      }
    }
    return static_cast<const T*>(nullptr);
  };
  auto cube_at = [&](int i) {  // tile-linear index -> work-cube offset
    if constexpr (C::kRow == P) {
      return i;
    } else {
      const int e = i / P3, r = i - e * P3;
      const int i0 = r / (P * P), r2 = r - i0 * (P * P);
      const int j = r2 / P;
      return e * C::kElem + i0 * C::kPlane + j * C::kRow + (r2 - j * P);
    }
  };

  int tile = blockIdx.x;
  if (tile < n_tiles) issue(tile, 0);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int buf = it & 1;
    held.flush();  // this tile's head and tail, loaded one step ago
    // every thread is past the last tile's final barrier, so no thread
    // reads the other buffer any more: the next tile may go there while
    // this one's copies land
    const int next = tile + static_cast<int>(gridDim.x);
    if (next < n_tiles) issue(next, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int64_t off = static_cast<int64_t>(tile) * te * P3;
    const int n = min(te, E - tile * te);

    for (int k = 0; k < args.n_ops; ++k) {
      const int* op = args.ops[k];
      const int dst = op[1];
      float* dbuf = args.slot_buf[dst] >= 0
                        ? work + args.slot_buf[dst] * wb
                        : nullptr;
      int o0 = -1, more = 0;
      for (int j = 0; j < args.n_out; ++j) {
        if (args.out_slot[j] != dst) continue;
        if (o0 < 0) {
          o0 = j;
        } else {
          more |= 1 << j;
        }
      }
      if (!dbuf && o0 < 0) continue;  // a result nothing reads
      T* out = o0 >= 0 ? static_cast<T*>(args.out[o0]) + off : nullptr;
      if (op[0] == 0) {
        const int mode = op[4];
        const float* cols = mats + (2 * op[3] + op[5]) * P * MR;
        ChainStore<T> st{dbuf,
                         mode_strides(permuted(cube, op + 6), mode),
                         out,
                         mode_strides(permuted(flat, op + 6), mode),
                         args.out,
                         off,
                         more};
        const int src = op[2];
        if (src < n_elem) {
          contract<P>(staged_in(src, buf, off), flat, mode, cols, n * P * P,
                      st);
        } else {
          contract<P>(work + args.slot_buf[src] * wb, cube, mode, cols,
                      n * P * P, st);
        }
      } else {
        const int code = op[0] - 1;
        const float c = args.consts[k];
        const int sa = op[2], sb2 = op[3] >= 0 ? op[3] : op[2];
        const T* ta = sa < n_elem ? staged_in(sa, buf, off) : nullptr;
        const T* tb = sb2 < n_elem ? staged_in(sb2, buf, off) : nullptr;
        const float* fa = sa < n_elem ? nullptr : work + args.slot_buf[sa] * wb;
        const float* fb =
            sb2 < n_elem ? nullptr : work + args.slot_buf[sb2] * wb;
        for (int i = threadIdx.x; i < n * P3; i += blockDim.x) {
          const int w = cube_at(i);
          const float a = ta ? to_float(ta[i]) : fa[w];
          const float b = tb ? to_float(tb[i]) : fb[w];
          float y;
          switch (code) {
            case 0: y = a + b; break;
            case 1: y = a - b; break;
            case 2: y = a * b; break;
            case 3: y = a / b; break;
            case 4: y = -a; break;
            default: y = a * c; break;
          }
          if (dbuf) dbuf[w] = y;
          if (out) out[i] = from_float<T>(y);
          for (int j = 0; more && j < kMaxOut; ++j) {
            if (more >> j & 1) {
              static_cast<T*>(args.out[j])[off + i] = from_float<T>(y);
            }
          }
        }
      }
      __syncthreads();
    }
    // outputs that are element inputs as they came in
    bool fed = false;
    for (int j = 0; j < args.n_out; ++j) {
      if (args.out_slot[j] >= n_elem) continue;
      fed = true;
      const T* x = staged_in(args.out_slot[j], buf, off);
      T* y = static_cast<T*>(args.out[j]) + off;
      for (int i = threadIdx.x; i < n * P3; i += blockDim.x) y[i] = x[i];
    }
    // they read this staging buffer, which the next step starts refilling
    if (fed) __syncthreads();
  }
}

template <typename T, int P>
static cudaError_t launch_gemm_chain(const GemmChainArgs& args, int E, int te,
                                     cudaStream_t stream) {
  const CubeTile t = chain_tile(args, sizeof(T), te);
  if (t.te > chain_max_tile(args, sizeof(T))) return cudaErrorInvalidValue;
  if (E <= 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err = persistent_grid(gemm_chain_kernel<T, P>, t,
                                    (E + t.te - 1) / t.te, &grid);
  if (err != cudaSuccess) return err;
  gemm_chain_kernel<T, P><<<grid, t.threads, t.smem, stream>>>(args, E, t.te);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_gemm_chain(const GemmChainArgs& args, int E,
                                       int te, cudaStream_t s) {
  switch (args.p) {
#define REPRO_GC_CASE(P) \
  case P:                \
    return launch_gemm_chain<T, P>(args, E, te, s);
    REPRO_FOR_EACH_P(REPRO_GC_CASE)
#undef REPRO_GC_CASE
    default:
      return cudaErrorInvalidValue;
  }
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

// The kernel's tile for a recipe at te (te <= 0: the default): {te,
// threads, shared bytes, largest te}, for the wrapper's mirror to be
// checked against.
extern "C" int repro_gemm_chain_tile(const repro::GemmChainArgs* args,
                                     int dtype, int te, int* out) {
  const int eb = dtype == repro::kBFloat16 ? 2 : 4;
  const repro::CubeTile t = repro::chain_tile(*args, eb, te);
  out[0] = t.te;
  out[1] = t.threads;
  out[2] = t.smem;
  out[3] = repro::chain_max_tile(*args, eb);
  return 0;
}

// te: the elements a CTA takes a step; te <= 0 takes the kernel's default.
extern "C" int repro_gemm_chain(const repro::GemmChainArgs* args, int E,
                                int dtype, int te, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->n_in > repro::kMaxIn || args->n_out > repro::kMaxOut ||
      args->n_ops > repro::kMaxOps || args->n_slots > repro::kMaxSlots ||
      args->n_mats > repro::kMaxMats || args->n_bufs > repro::kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == repro::kFloat32) {
    return repro::dispatch_gemm_chain<float>(*args, E, te, s);
  }
  if (dtype == repro::kBFloat16) {
    return repro::dispatch_gemm_chain<__nv_bfloat16>(*args, E, te, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
