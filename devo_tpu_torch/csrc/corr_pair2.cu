// Both pyramid levels of the sparse patch correlation in one launch by
// persistent blocks whose copy stream never drains, the output one step
// behind the products, for Hopper (sm_90a): CORR_KERNEL="pair2". Plain C
// interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_pair2`
// (devo_tpu/ops/corr_pallas.py:1433, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair2 :1835, pallas_call at :1944, variant="pair2")
// together with its XLA glue: lookup_g (:968), _pair_level_index (:1195),
// the one-hot scale lookup and ops/corr.blend_strips for both levels. What
// that kernel adds to `_kernel_banded_pair`: its copy stream never drains at
// a block boundary (a global copy index), and the extraction of block b - 1
// runs after block b's products (the output one block behind). On the TPU
// the grid runs in order and carries the copies from one step to the next;
// here blocks run in no order and nothing carries between them, so a
// persistent block's loop over its edges takes the grid's place. None of
// the TPU's shapes is kept: plain (mem, h, w, C) rings, no bands, stagger,
// 24-wide windows, R scratch or bf16 strip output; the blended (E, 882) f32
// feature is written here.
//
// What it computes: the function of csrc/corr.cu (ops/corr.corr_pyramid is
// the plain version), coords / lvl divided here so that all floor the same
// values.
//
// What bounds it on an H100: bytes, as csrc/corr.cu. The design is the edge
// pipeline of corr_pipe.cuh with both levels and one edge a step, in the
// TPU kernel's schedule:
//   - blocks of one pipeline of 256 threads, as many an SM as the occupancy
//     query gives (ops/corr_cuda.pair2_plan sizes the windows for two on
//     int8 rings), the grid as many as the SMs hold at once and at most E;
//     block b walks edges b, b + grid, b + 2 grid, ...: the copy stream of
//     a block runs from its first edge to its last, and the scheduler
//     interleaves the blocks of an SM;
//   - two rotating surface slots a level and one barrier a step: after the
//     barrier that makes edge n's copies visible, the products of n go to
//     slot n % 2 and then the extraction and blend of edge n - 1 read the
//     other slot (the lagged output); the last edge's extraction follows
//     the loop;
//   - two stages: the copies of edge n + 1 fly under that step;
//   - products as csrc/corr.cu: on the tensor cores (corr_mma.cuh) for bf16
//     patch features, the int8 -> bf16 conversion in the fragment loads; on
//     the CUDA cores (position_products) for f32 ones; a level whose window
//     exceeds `cap` reads its taps from the ring, one dot a tap. Nothing is
//     clipped.
// No atomics, and every sum in a fixed order: two launches give the same
// bits.

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// both levels, one edge a step, one pipeline of 256 threads, at most two
// stages, strided over a persistent grid, the extraction one step behind
using Pair2 = PipeShape<2, 1, 1, 2, false, false, false, 256,
                        Order::kStrided, Sched::kLagged>;

template <typename G, typename F>
__global__ void __launch_bounds__(Pair2::kBlock, 2)
corr_pair2_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, Pair2>(args);
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<G, F, Pair2>(PP, C, cap).bytes(depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_pyramid
// (csrc/corr.cu): `cap` a multiple of 16 for bf16 patch features, `depth`
// the stages of a block's ring (2), `grid` the blocks of the persistent
// grid (1 .. E; the wrapper takes the SMs times the occupancy query's
// blocks an SM). The dynamic shared memory taken is devo_corr_pair2_smem's,
// that of ops/corr_cuda.pair2_smem_bytes.
extern "C" int devo_corr_pair2(const void* gmap, const void* fmap1,
                               const void* fmap2, const void* dq1,
                               const void* dq2, const void* coords,
                               const void* kk, const void* jj, void* out, int E,
                               int PP, int C, int h1, int w1, int h2, int w2,
                               int cap, float lvl1, float lvl2, int g_bf16,
                               int ring_i8, int depth, int grid,
                               void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || depth != Pair2::kMaxDepth || grid < 1 || grid > E ||
      (g_bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                     \
  launch_pipe<Pair2>(corr_pair2_kernel<G, F>,                                 \
                     PipeArgs<G, F>{pair_args<G, F>(gmap, fmap1, fmap2, dq1,  \
                                                    dq2, coords, kk, jj, out, \
                                                    E, PP, C, h1, w1, h2, w2, \
                                                    cap, lvl1, lvl2),         \
                                    depth, 0, nullptr, 0},                    \
                     grid, smem_bytes<G, F>(PP, C, cap, depth), st)
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_pair2 takes at these sizes.
extern "C" long long devo_corr_pair2_smem(int PP, int C, int cap, int depth,
                                          int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) static_cast<long long>(smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_pair2's kernel that one SM of the current device holds
// at a time at these sizes (the persistent grid is that times the number of
// SMs), or minus the cudaError_t of the query.
extern "C" int devo_corr_pair2_blocks_per_sm(int PP, int C, int cap, int depth,
                                             int g_bf16, int ring_i8) {
#define DEVO_OCC(G, F)                                                    \
  pipe_blocks_per_sm<Pair2>(corr_pair2_kernel<G, F>,                      \
                            smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_OCC);
#undef DEVO_OCC
}
