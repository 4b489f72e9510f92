// Both pyramid levels of the sparse patch correlation in one launch, from a
// per-edge product surface in two rotating slots, for Hopper (sm_90a):
// CORR_KERNEL="mono3". Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_mono3`
// (devo_tpu/ops/corr_pallas.py:1736, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair2 :1835, pallas_call at :1944, variant="mono3")
// together with its XLA glue: lookup_g (:968), _pair_level_index (:1195), the
// one-hot scale lookup and ops/corr.blend_strips for both levels. What that
// kernel is: the mono kernel's function with a two-slot rotating per-edge f32
// product scratch, the extraction in the same iteration as the product (no
// lagged output block), 64 edges a block and a deep ring of window copies
// ahead of the products. This kernel keeps that schedule and none of the
// TPU's shapes: plain (mem, h, w, C) rings, no bands, stagger, 24-wide
// windows or bf16 strip output; the blended (E, 882) f32 feature is written
// here.
//
// What it computes: the function of csrc/corr.cu (ops/corr.corr_pyramid is
// the plain version), coords / lvl divided here so that both floor the same
// values.
//
// What bounds it on an H100: bytes, as csrc/corr.cu. The design is the edge
// pipeline of corr_pipe.cuh with both levels and one edge a step, in the
// TPU kernel's schedule:
//   - one pipeline of 512 threads a block, one block an SM (shared memory),
//     walking a run of consecutive edges (at most 64; the wrapper sizes the
//     runs to whole rounds over the SMs, ops/corr_cuda.mono3_run);
//   - two rotating surface slots a level: the products of edge e go to slot
//     e % 2 and, after the step's one barrier, the extraction of e reads
//     them while the products of e + 1 write the other slot. One barrier an
//     edge, where csrc/corr.cu has two;
//   - the deepest ring of stages that fits beside the slots
//     (ops/corr_cuda.mono3_plan: four at C = 128 on int8 rings, two on
//     bf16): the copies of edge e + depth - 1 start right after the barrier
//     that closes the products of e - 1 and fly under the next depth - 1
//     steps;
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

// both levels, one edge a step, one pipeline of 512 threads, at most eight
// stages, runs of edges, the extraction right after the products' barrier
using Mono3 = PipeShape<2, 1, 1, 8, false, false, false, kPipeBlock,
                        Order::kRuns, Sched::kSameStep>;

template <typename G, typename F>
__global__ void __launch_bounds__(Mono3::kBlock, 1)
corr_mono3_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, Mono3>(args);
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<G, F, Mono3>(PP, C, cap).bytes(depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_pyramid
// (csrc/corr.cu): `cap` a multiple of 16 for bf16 patch features, `depth`
// the stages of the block's ring (2 .. 8), `run` the consecutive edges a
// block walks (at least 1). The dynamic shared memory taken is
// devo_corr_mono3_smem's, that of ops/corr_cuda.mono3_smem_bytes.
extern "C" int devo_corr_mono3(const void* gmap, const void* fmap1,
                               const void* fmap2, const void* dq1,
                               const void* dq2, const void* coords,
                               const void* kk, const void* jj, void* out, int E,
                               int PP, int C, int h1, int w1, int h2, int w2,
                               int cap, float lvl1, float lvl2, int g_bf16,
                               int ring_i8, int depth, int run, void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || depth < 2 || depth > Mono3::kMaxDepth || run < 1 ||
      (g_bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(G, F)                                                     \
  launch_pipe<Mono3>(corr_mono3_kernel<G, F>,                                 \
                     PipeArgs<G, F>{pair_args<G, F>(gmap, fmap1, fmap2, dq1,  \
                                                    dq2, coords, kk, jj, out, \
                                                    E, PP, C, h1, w1, h2, w2, \
                                                    cap, lvl1, lvl2),         \
                                    depth, run, nullptr, 0},                  \
                     grid, smem_bytes<G, F>(PP, C, cap, depth), st)
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_mono3 takes at these sizes.
extern "C" long long devo_corr_mono3_smem(int PP, int C, int cap, int depth,
                                          int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) static_cast<long long>(smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_mono3's kernel that one SM of the current device holds
// at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_mono3_blocks_per_sm(int PP, int C, int cap, int depth,
                                             int g_bf16, int ring_i8) {
#define DEVO_OCC(G, F)                                                    \
  pipe_blocks_per_sm<Mono3>(corr_mono3_kernel<G, F>,                      \
                            smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_OCC);
#undef DEVO_OCC
}
