// One pyramid level of the sparse patch correlation per launch on the edge
// pipeline, on every ring type, for Hopper (sm_90a): CORR_KERNEL="split".
// Plain C interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_split`
// (devo_tpu/ops/corr_pallas.py:356, reached through corr_level_banded :738,
// pallas_call at :857, ablate="split") together with its XLA glue: lookup_g
// (:968), the index preamble (:784-810), the one-hot scale lookup (:824-826)
// and ops/corr.blend_strips. What that kernel does: a block streams all of
// its edges' windows and products into an R-buffer, then extracts them
// (:366-369, the loops at :418 and :432). None of the TPU's shapes is kept:
// plain (mem, h, w, C) rings, no bands, stagger, 24-wide windows or window
// clip; out-of-image taps read zero.
//
// What it computes, per edge e, with coords already at this level's
// resolution: ops/corr.corr_level, unclipped, on bf16 or f32 patch features
// and bf16, f32 or int8 rings:
//   tap[p][di][dj] = <gmap[kk[e]][p], fmap[jj[e], y0[p] + di - 3,
//                    x0[p] + dj - 3]> * dq[jj[e]] (int8 rings; 1 else), f32
//                    sums never rounded; 0 off the image
//   out            the 7x7 bilinear blend, (E, 49*P*P) f32 in [dx, dy, pixel]
//                  order.
//
// What bounds it on an H100: bytes, the covering windows (about 10x10
// feature vectors an edge at level 1), and below them the latency of the
// window copies and the barriers. The design is the one-level instance of
// the edge pipeline of corr_pipe.cuh that csrc/corr_level_pipe.cu
// ("split2") runs, under its own name: one edge a step, exact taps, two
// pipelines of 256 threads a block, each walking its half of a run of
// consecutive edges behind a ring of staged windows, two barriers a step;
// the products on the tensor cores (corr_mma.cuh) for bf16 patch features,
// on the CUDA cores (position_products) for f32 ones; the f32 surface in
// shared memory, extraction and blend from it; a window beyond `cap` takes
// its taps from the ring, one dot a tap. The plan is ops/corr_cuda.group_plan
// (at C = 128 two blocks an SM, 63,360 bytes on int8 rings, 109,440 on
// bf16), and the output is corr_level_pipe.cu's bits at the same plan.
//
// The TPU kernel's phase split on the same pipeline (each pipeline takes
// its run in groups of R edges, the products of a group back to back into R
// surface slots, then one barrier and the group's extraction) was tried
// against this design in turns and gave the same bits; its lead on int8
// rings was within the spread of two identical instances and it lost on
// bf16 rings (PERF.md), so it is not kept.
// No atomics, and every sum in a fixed order: two launches give the same
// bits.

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// one level, one edge a step, two pipelines, at most four stages, exact taps
using LevelPipe = PipeShape<1, 1, 2, 4, false, false, false>;

template <typename G, typename F>
__global__ void __launch_bounds__(kPipeBlock, 2)
corr_level_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, LevelPipe>(args);
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<G, F, LevelPipe>(PP, C, cap).bytes(depth);
}

bool bad_plan(int PP, int cap, int g_bf16, int depth, int run) {
  return PP > kMaxPP || depth < LevelPipe::kPipes ||
         depth > LevelPipe::kMaxDepth || depth % LevelPipe::kPipes != 0 ||
         run < 1 || (g_bf16 && cap % 16 != 0);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_level_pipe
// (csrc/corr_level_pipe.cu): gmap (Mring, P, P, C), bf16 if g_bf16 else
// f32; fmap (mem, H, W, C) of gmap's type, or int8 if ring_i8 with dq (mem,)
// f32 the slots' scales (null otherwise); coords (E, P, P, 2) f32 at this
// level's resolution; kk / jj (E,) int32; out (E, 49*P*P) f32; `cap` a
// multiple of 16 for bf16 patch features, `depth` the stages (2 or 4, half
// of them each pipeline's), `run` the consecutive edges a block walks. The
// dynamic shared memory taken is devo_corr_level_smem's, that of
// ops/corr_cuda.group_smem_bytes.
extern "C" int devo_corr_level(const void* gmap, const void* fmap,
                               const void* dq, const void* coords,
                               const void* kk, const void* jj, void* out,
                               int E, int PP, int C, int H, int W, int cap,
                               int g_bf16, int ring_i8, int depth, int run,
                               void* stream) {
  if (E == 0) return 0;
  if (bad_plan(PP, cap, g_bf16, depth, run))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(G, F)                                                   \
  launch_pipe<LevelPipe>(corr_level_kernel<G, F>,                           \
              PipeArgs<G, F>{level_args<G, F>(gmap, fmap, dq, coords, kk,   \
                                              jj, out, E, PP, C, H, W, cap), \
                             depth, run, nullptr, 0},                       \
              grid, smem_bytes<G, F>(PP, C, cap, depth), st)
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_level takes at these sizes.
extern "C" long long devo_corr_level_smem(int PP, int C, int cap, int depth,
                                          int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) static_cast<long long>(smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_level's kernel that one SM of the current device holds
// at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_level_blocks_per_sm(int PP, int C, int cap, int depth,
                                             int g_bf16, int ring_i8) {
#define DEVO_OCC(G, F)                                                   \
  pipe_blocks_per_sm<LevelPipe>(corr_level_kernel<G, F>,                 \
                                smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_OCC);
#undef DEVO_OCC
}

