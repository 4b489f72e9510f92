// One pyramid level of the sparse patch correlation on float rings, on the
// edge pipeline, with the stage instances that time its parts apart, for
// Hopper (sm_90a): CORR_KERNEL="full". Plain C interface, loaded with ctypes
// by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded` (devo_tpu/ops/corr_pallas.py:289,
// reached through corr_level_banded :738 with ablate="full", pallas_call at
// :958; ablate="noext", "nomm" and "noDMA" are its stage ablations) together
// with its XLA glue: lookup_g (:968), the index preamble (:784-810) and
// ops/corr.blend_strips. What that kernel is: per edge, in one loop, a window
// copy out of a K-deep ring with IF copies in flight, one product of the
// window against the patch's pixels into one of four rotating result
// scratches, and the extraction of the pixels' tap strips from it in the
// same iteration. It keeps none of the TPU's shapes: plain (mem, h, w, C)
// rings, no bands, stagger or 24-wide windows; a window is the union of the
// pixels' 8x8 tap grids, and out-of-image positions are zero.
//
// What it computes, per edge, with coords already at this level's resolution:
// ops/corr.corr_level on bf16 or f32 rings (the patch features of the ring's
// type), unclipped; a window of more than `cap` positions (a strongly
// distorted patch; every window where cap = 0) is not staged and that edge
// reads its 64 taps a pixel from the ring. The stage instances compute no
// correlation; each writes what ops/corr.corr_level_stage defines at `cap`:
//   noext  copies and products, no extraction: a staged edge's row is the
//          first 49*P*P values of its surface (window position i / P*P,
//          pixel i % P*P); an edge not staged is 0
//   nomm   copies and extraction, no product: every tap is the ring value
//          of channel p % C of its position
//   noDMA  products and extraction over windows that are zeroed once and
//          never copied: a staged edge is 0; an edge not staged reads the
//          ring as the correlation does.
//
// What bounds it on an H100: bytes, the covering windows (about 10x10
// feature vectors an edge at level 1), and below them the latency of the
// window copies and the barriers. The design is the edge pipeline of
// corr_pipe.cuh in corr_group8.cu's shape: one level, one edge a step,
// exact taps; two pipelines of 256 threads a block, each walking its half
// of a run of consecutive edges behind a ring of staged windows, two
// barriers a step; the products on the tensor cores (corr_mma.cuh) for bf16
// rings, on the CUDA cores (position_products) for f32 rings; the f32
// surface in shared memory, extraction and blend from it. The plan is
// ops/corr_cuda.group_plan (full_knobs: the ring's depth and a block's run
// of edges may be set for tuning): at C = 128 on bf16 rings two blocks an
// SM, each two stages of full windows, four pipelines an SM whose waits
// overlap one another's work; f32 rings one block. The stage instances are
// the same pipeline with one part left out (Part): under nomm the copies of
// a stage start only after its extraction and one more barrier
// (corr_pipe.cuh's hazard notes). The TPU kernel's schedule on the same
// pipeline (one pipeline of 256 threads a block walking a run of edges,
// the extraction of each edge in its products' step, Sched::kSameStep as
// csrc/corr_mono3.cu, the deepest ring half an SM holds: two stages on bf16
// rings) was 10-11% slower in turns at both levels and is not kept
// (PERF.md).
// No atomics, and every sum in a fixed order: two launches give the same
// bits.

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// one level, one edge a step, two pipelines, at most four stages, exact
// taps; the parts of a step that run
template <Part kPart>
using Full = PipeShape<1, 1, 2, 4, false, false, false, kPipeBlock,
                       Order::kRuns, Sched::kTwoBarriers, kPart>;

// F: type of the rings and of the patch features (bf16 or f32)
template <typename F, Part kPart>
__global__ void __launch_bounds__(kPipeBlock, 2)
corr_level_full_kernel(const PipeArgs<F, F> args) {
  edge_pipeline<F, F, Full<kPart>>(args);
}

template <typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<F, F, Full<Part::kAll>>(PP, C, cap).bytes(depth);
}

template <typename F>
int launch(const PipeArgs<F, F>& args, int stage, int grid,
           cudaStream_t st) {
  const size_t smem = smem_bytes<F>(args.p.PP, args.p.C, args.p.cap,
                                    args.depth);
  switch (stage) {
#define DEVO_STAGE(P)                                                      \
  return launch_pipe<Full<P>>(corr_level_full_kernel<F, P>, args, grid, smem, st)
    case 0: DEVO_STAGE(Part::kAll);
    case 1: DEVO_STAGE(Part::kNoExt);
    case 2: DEVO_STAGE(Part::kNoMM);
    case 3: DEVO_STAGE(Part::kNoDMA);
#undef DEVO_STAGE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. gmap, fmap, coords, kk, jj, out, E, PP, C, H, W
// and `cap` are those of devo_corr_group8 (csrc/corr_group8.cu); `depth` is
// the number of stages of the window ring (2 or 4, half of them each
// pipeline's), `run` the consecutive edges a block walks (at least 1),
// `stage` 0 = the correlation, 1 = no extraction, 2 = no product, 3 = no
// copy (ops/corr.corr_level_stage). The dynamic shared memory taken is
// devo_corr_level_full_smem's, that of ops/corr_cuda.group_smem_bytes.
extern "C" int devo_corr_level_full(const void* gmap, const void* fmap,
                                    const void* coords, const void* kk,
                                    const void* jj, void* out, int E, int PP,
                                    int C, int H, int W, int cap, int bf16,
                                    int depth, int run, int stage,
                                    void* stream) {
  using S = Full<Part::kAll>;
  if (E == 0) return 0;
  if (PP > kMaxPP || depth < S::kPipes || depth > S::kMaxDepth ||
      depth % S::kPipes != 0 || run < 1 || (bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(F)                                                        \
  launch(PipeArgs<F, F>{level_args<F, F>(gmap, fmap, nullptr, coords, kk, jj, \
                                         out, E, PP, C, H, W, cap),           \
                        depth, run, nullptr, 0},                              \
         stage, grid, st)
  return bf16 ? DEVO_LAUNCH(__nv_bfloat16) : DEVO_LAUNCH(float);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_level_full takes at these sizes (every
// stage instance the same).
extern "C" long long devo_corr_level_full_smem(int PP, int C, int cap,
                                               int depth, int bf16) {
  return static_cast<long long>(
      bf16 ? smem_bytes<__nv_bfloat16>(PP, C, cap, depth)
           : smem_bytes<float>(PP, C, cap, depth));
}

// Blocks of devo_corr_level_full's kernel (the correlation) that one SM of
// the current device holds at these sizes, or minus the cudaError_t of the
// query. The arguments are those of devo_corr_group8_blocks_per_sm.
extern "C" int devo_corr_level_full_blocks_per_sm(int PP, int C, int cap,
                                                  int depth, int bf16,
                                                  int ring_i8) {
  using S = Full<Part::kAll>;
  if (ring_i8) return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? pipe_blocks_per_sm<S>(
                    corr_level_full_kernel<__nv_bfloat16, Part::kAll>,
                    smem_bytes<__nv_bfloat16>(PP, C, cap, depth))
              : pipe_blocks_per_sm<S>(corr_level_full_kernel<float, Part::kAll>,
                                      smem_bytes<float>(PP, C, cap, depth));
}
